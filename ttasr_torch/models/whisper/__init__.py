"""Whisper in PyTorch: config, model, weights, decoding."""
