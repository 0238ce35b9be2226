#!/usr/bin/env python3
"""Smoke run of the ttasr_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the device: CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``ttasr_torch/csrc`` with nvcc;
3. holds the encoder-attention kernel against its plain PyTorch version at
   large-v3 shapes (bf16 and float32, full and ragged ``t_real``), and times
   both with CUDA events;
4. drives the port's batch CLI path: ``WhisperEngine("large-v3",
   compute_type="bfloat16")`` with random weights from a seeded generator,
   on two synthesized speech-like WAVs (20 s and 45 s, so the seek loop
   crosses a window with prompt carry), through
   ``ttasr_torch.cli.asr.process_audio_folder``; checks the results, that
   the encoder-attention kernel ran (32 launches per encoded window), that
   beam decodes ran with finite logits, and that the encoder output agrees
   with the plain-attention encoder on one window.

Prints one JSON line with each kernel's launches, error and times, then
the contract line ``{"ok": true, "device": {...}}`` last.  Imports nothing
of jax.  Exits non-zero, printing no result, when CUDA is unavailable or the
checkout is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bounds over rows < t_real, relative to max|plain|
BF16_REL = 2e-2   # bf16 inputs and probabilities, f32 sums
F32_REL = 1e-4    # exact f32 products, f32 sums in another order
ENCODER_REL = 5e-2  # 32 bf16 layers, kernel vs plain attention


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_encoder_attention(card: str) -> dict:
    """B11 against its plain version at the main path's shapes."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged,
        encoder_attention_merged_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, dh = 1280, 64
    worst = 0.0
    cases = [(torch.bfloat16, 1, 1500, 1500), (torch.bfloat16, 4, 1500, 1500),
             (torch.bfloat16, 1, 1536, 1500), (torch.bfloat16, 4, 1536, 1500),
             (torch.float32, 1, 1500, 1500), (torch.float32, 1, 1536, 1500)]
    for dtype, b, t, t_real in cases:
        def rand():
            return torch.randn((b, t, d), generator=gen, device="cuda")

        q = (rand() * dh ** -0.5).to(dtype)
        k, v = rand().to(dtype), rand().to(dtype)
        got = encoder_attention_merged(q, k, v, t_real)
        torch.cuda.synchronize()
        want = encoder_attention_merged_ref(q, k, v, t_real)
        err = (got[:, :t_real].float() - want[:, :t_real].float()).abs().max().item()
        scale = want[:, :t_real].float().abs().max().item()
        bound = (BF16_REL if dtype == torch.bfloat16 else F32_REL) * scale
        print(f"encoder_attention {str(dtype)[6:]} B={b} T={t} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e}, max|plain| {scale:.3e})")
        check(err <= bound, f"encoder attention disagrees with its plain "
                            f"version: {err} > {bound}")
        worst = max(worst, err)
        if t == t_real:
            # plain, kernel, kernel, plain: both measured in turns
            f_k = lambda: encoder_attention_merged(q, k, v, t_real)  # noqa: E731
            f_p = lambda: encoder_attention_merged_ref(q, k, v, t_real)  # noqa: E731
            p1, k1, k2, p2 = time_ms(f_p), time_ms(f_k), time_ms(f_k), time_ms(f_p)
            kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            print(f"encoder_attention {str(dtype)[6:]} B={b} T={t}: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
            if dtype == torch.bfloat16 and b == 1:
                main_ms, main_plain_ms = kernel_ms, plain_ms
    return {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain_ms}


def run_main_path(card: str) -> int:
    """The batch CLI at large-v3, bf16, beam 5; returns B11's launches."""
    import numpy as np
    import torch

    from tools.train_vad import synth_speech
    from ttasr.audio.io import write_wav
    from ttasr_torch.cli.asr import build_engine, process_audio_folder
    from ttasr_torch.models.whisper.model import encode
    from ttasr_torch.ops.encoder_attention import encoder_attention_merged
    from ttasr_torch.ops.mel import log_mel_spectrogram

    t0 = time.perf_counter()
    engine = build_engine("large-v3", device="cuda")
    torch.cuda.synchronize()
    print(f"engine: large-v3 bf16 random init on {engine.device} in "
          f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        audio_seconds = 0.0
        first = None
        for name, seconds, seed in (("speech20", 20.0, 0), ("speech45", 45.0, 1)):
            audio, _ = synth_speech(np.random.default_rng(seed), seconds)
            write_wav(os.path.join(audio_dir, f"{name}.wav"), audio, 16000)
            audio_seconds += seconds
            first = audio if first is None else first

        encoder_attention_merged.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = process_audio_folder(audio_dir, model="large-v3", engine=engine,
                                      results_json_dir=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = encoder_attention_merged.launches

    check(result is not None, "process_audio_folder returned None")
    entries = result["detailed_results"]
    check(len(entries) == 2, f"expected 2 results, got {len(entries)}")
    for entry in entries:
        check("error" not in entry, f"{entry['audio_file']}: {entry.get('error')}")
    stats = engine.decode_stats
    print(f"decode stats: {json.dumps(stats)}")
    check(launches > 0 and launches % 32 == 0,
          f"encoder attention launched {launches} times, not a positive "
          f"multiple of 32")
    check(stats["beam_decodes"] > 0 and stats["beam_steps"] > 0,
          "no beam decode step ran")
    check(stats["nonfinite_logits"] == 0, "a decode produced non-finite logits")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"main path: 2 files, {audio_seconds:.1f} s of audio, wall "
          f"{wall:.2f} s, {launches} encoder-attention launches "
          f"({launches // 32} windows), peak memory {peak_gib:.2f} GiB ({card})")
    for entry in entries:
        print(f"  {entry['audio_file']}: {len(entry['asr_result'] or '')} chars")

    # the encoder output: finite, of the expected shape, and close to the
    # plain-attention encoder on one window
    with torch.inference_mode():
        mel = log_mel_spectrogram(first, n_mels=engine.cfg.num_mel_bins,
                                  device=engine.device)[None]
        kernel_out = encode(engine.params, engine.cfg, mel)
        plain_out = encode(engine.params, engine.cfg, mel, fused_attention=False)
    check(tuple(kernel_out.shape) == (1, 1500, 1280),
          f"encoder output shape {tuple(kernel_out.shape)}")
    check(bool(torch.isfinite(kernel_out).all()), "non-finite encoder output")
    err = (kernel_out.float() - plain_out.float()).abs().max().item()
    scale = plain_out.float().abs().max().item()
    print(f"encoder large-v3 bf16, kernel vs plain attention: max_abs_err "
          f"{err:.3e}, max|plain| {scale:.3e}")
    check(err <= ENCODER_REL * scale, "encoder disagrees with plain attention")
    return launches


def main() -> int:
    try:
        sys.stdout.reconfigure(encoding="utf-8")
    except AttributeError:
        pass
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    check(os.path.isdir(os.path.join(ROOT, "ttasr_torch")),
          "ttasr_torch/ not found next to chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from ttasr_torch import resolve_device
    from ttasr_torch.ops import _build

    resolve_device("cuda")  # TF32 off: float32 means float32
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    b11 = check_encoder_attention(card)
    launches = run_main_path(card)

    print(json.dumps({"kernels": [{
        "name": "encoder_attention_merged",
        "route": "cuda",
        "source": "ttasr_torch/csrc/encoder_attention.cu",
        "replaces": "ttasr/ops/encoder_attention_pallas.py:156",
        "launches": launches,
        "max_abs_err": b11["max_abs_err"],
        "ms": b11["ms"],
        "plain_ms": b11["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
