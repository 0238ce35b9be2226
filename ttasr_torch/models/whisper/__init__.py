"""Whisper in PyTorch: config, model, weights, decoding, word alignment."""

from ttasr_torch.models.whisper.config import PRESETS, WhisperConfig, get_config
from ttasr_torch.models.whisper.load import (
    load_whisper,
    params_from_hf_model,
    params_from_jax,
    params_from_state_dict,
)
from ttasr_torch.models.whisper.model import (
    DecodeCache,
    decode_step,
    decode_train,
    encode,
    forward,
    init_cache,
    init_params,
)

__all__ = [
    "WhisperConfig", "PRESETS", "get_config",
    "DecodeCache", "decode_step", "decode_train", "encode", "forward",
    "init_cache", "init_params",
    "load_whisper", "params_from_hf_model", "params_from_jax",
    "params_from_state_dict",
]
