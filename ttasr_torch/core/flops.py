"""Analytic model-FLOPs accounting for MFU reporting (the port of
``ttasr/core/flops.py``; the counts are the original's).

A benchmark divides these counts by measured wall-clock and the card's
peak matmul rate to report model-FLOPs utilization (RTF alone says
nothing about how fast the program is *for the silicon*).  Counts follow
the standard 2-FLOPs-per-MAC convention and include only matmul/conv
work (layernorms, softmax, gelu are noise at these shapes).

Peak rate: one NVIDIA H100 SXM at its 700 W limit, 989 TFLOP/s dense
bf16 (NVIDIA's data sheet; ``chip_smoke.PEAK_OPS_PER_S`` holds the same
rate beside the card's other peaks).  Override with
``TTASR_PEAK_TFLOPS``, e.g. for a card set below 700 W.
"""

from __future__ import annotations

import os


def peak_tflops() -> float:
    """Peak dense bf16 matmul TFLOP/s of the card (env-overridable)."""
    env = os.environ.get("TTASR_PEAK_TFLOPS")
    if env:
        return float(env)
    return 989.0  # H100 SXM, 700 W


def encoder_flops(cfg, batch: int) -> float:
    """Conv stem + transformer encoder over one 30 s window batch."""
    t = cfg.max_source_positions          # 1500
    frames = 2 * t                        # 3000 mel frames, stride-2 conv2
    d, ffn, n_layers = cfg.d_model, cfg.ffn_dim, cfg.encoder_layers
    conv = (2 * frames * 3 * cfg.num_mel_bins * d   # conv1 (stride 1)
            + 2 * t * 3 * d * d)                    # conv2 (stride 2)
    per_layer = (
        8 * t * d * d        # q,k,v,out projections (4 × 2·T·d²)
        + 4 * t * t * d      # scores + attention·V einsums
        + 4 * t * d * ffn    # mlp up + down
    )
    return float(batch) * (conv + n_layers * per_layer)


def decode_flops(cfg, batch: int, beam: int, prompt_width: int,
                 new_tokens: int) -> float:
    """Prefill + ``new_tokens`` incremental steps of beam decode.

    Self-attention cache reads use the average live cache length under
    the growth-bucket schedule (≈ prompt + tokens/2) — exact per-bucket
    accounting shifts the total by <2 % at the bench shapes.
    """
    t_src = cfg.max_source_positions
    d, ffn, n_layers = cfg.d_model, cfg.ffn_dim, cfg.decoder_layers
    v = cfg.vocab_size
    rows = batch * beam

    # cross-K/V projection, once per window (shared across beams)
    cross_kv = batch * n_layers * 4 * t_src * d * d
    # teacher-forced prefill over the (left-padded) prompt buffer
    p = prompt_width
    prefill = rows * n_layers * (
        8 * p * d * d          # self q,k,v,out
        + 4 * p * p * d        # self attention
        + 4 * p * d * d        # cross q + out
        + 4 * p * t_src * d    # cross attention
        + 4 * p * d * ffn      # mlp
    )
    # incremental steps (T=1 per step)
    avg_len = prompt_width + new_tokens / 2.0
    per_step = rows * n_layers * (
        8 * d * d
        + 4 * avg_len * d
        + 4 * d * d
        + 4 * t_src * d
        + 4 * d * ffn
    )
    # logits: one unembed per step + the prefill's last row + sot row
    unembed = rows * 2 * d * v * (new_tokens + 2)
    return cross_kv + prefill + unembed + new_tokens * per_step
