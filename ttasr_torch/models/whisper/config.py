"""Whisper architecture configurations (port of
``ttasr/models/whisper/config.py``).

Declared again rather than imported: ``ttasr.models.whisper`` imports jax
in its package ``__init__``.  ``tests/test_torch_config.py`` pins these
declarations to the originals field by field.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    @classmethod
    def from_hf_config(cls, hf) -> "WhisperConfig":
        """Build from a transformers.WhisperConfig or a config.json dict."""
        get = (lambda k, d=None: getattr(hf, k, d)) if not isinstance(hf, dict) else (
            lambda k, d=None: hf.get(k, d)
        )
        return cls(
            name=str(get("_name_or_path", "custom")),
            vocab_size=get("vocab_size"),
            num_mel_bins=get("num_mel_bins"),
            d_model=get("d_model"),
            encoder_layers=get("encoder_layers"),
            encoder_heads=get("encoder_attention_heads"),
            decoder_layers=get("decoder_layers"),
            decoder_heads=get("decoder_attention_heads"),
            ffn_dim=get("encoder_ffn_dim"),
            max_source_positions=get("max_source_positions", 1500),
            max_target_positions=get("max_target_positions", 448),
        )

    @classmethod
    def from_json(cls, path: str) -> "WhisperConfig":
        with open(path, encoding="utf-8") as fh:
            return cls.from_hf_config(json.load(fh))


def _preset(name, d, enc_l, dec_l, heads, mels=80, vocab=51865):
    return WhisperConfig(
        name=name, vocab_size=vocab, num_mel_bins=mels, d_model=d,
        encoder_layers=enc_l, encoder_heads=heads, decoder_layers=dec_l,
        decoder_heads=heads, ffn_dim=4 * d,
    )


PRESETS = {
    # byte-fallback-tokenizer vocab, micro dims (tests)
    "micro-test": _preset("micro-test", 64, 2, 2, 4, vocab=1865),
    # head_dim-64 micro preset: reaches the encoder-attention kernel
    "micro64-test": _preset("micro64-test", 128, 2, 2, 2, vocab=1865),
    "tiny": _preset("tiny", 384, 4, 4, 6),
    "tiny.en": _preset("tiny.en", 384, 4, 4, 6, vocab=51864),
    "base": _preset("base", 512, 6, 6, 8),
    "small": _preset("small", 768, 12, 12, 12),
    "medium": _preset("medium", 1024, 24, 24, 16),
    "large-v2": _preset("large-v2", 1280, 32, 32, 20),
    "large-v3": _preset("large-v3", 1280, 32, 32, 20, mels=128, vocab=51866),
    "large-v3-turbo": _preset("large-v3-turbo", 1280, 32, 4, 20, mels=128, vocab=51866),
}


def get_config(name_or_path: str) -> WhisperConfig:
    """Resolve a preset name, an HF model dir, or a config.json path."""
    if name_or_path in PRESETS:
        return PRESETS[name_or_path]
    if os.path.isdir(name_or_path):
        cfg_path = os.path.join(name_or_path, "config.json")
        if os.path.exists(cfg_path):
            return WhisperConfig.from_json(cfg_path)
    if os.path.isfile(name_or_path) and name_or_path.endswith(".json"):
        return WhisperConfig.from_json(name_or_path)
    raise ValueError(f"unknown whisper config: {name_or_path!r}")
