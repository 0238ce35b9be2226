#!/usr/bin/env python3
"""Smoke run of the ttasr_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the device: CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``ttasr_torch/csrc`` with nvcc
   (one process per source, in parallel), and prints the floor of
   ``time_ms`` (a 1-element add per CUDA graph replay: the host's launch
   rate, which a kernel time near it reflects);
3. holds the encoder-attention kernel (B11) against its plain PyTorch
   version at large-v3 shapes (bf16 and float32, full and ragged
   ``t_real``); prints its TFLOP/s and share of the bound beside
   ``scaled_dot_product_attention``'s;
4. holds the int8 decode kernels against their plain versions at large-v3
   shapes: B1 and B4 at 5 rows; B3 at (B, K) = (1, 5) and (5, 1) over int4
   and int8 cross-KV; B2 (beam 5, a non-identity ancestry map) and B10
   (5 audios x 1 row) at cache lengths 288 and 480 with the slot near the
   end and two pad lengths, int4 and int8 self-KV.  New K/V codes and
   scales must be exact; floats within the bounds below.  Each kernel and
   its plain version, and one decoder layer's chain B1 -> B2 -> B3 -> B4
   against the plain chain, are timed in turns (plain, kernel, kernel,
   plain) with CUDA events over replays of a CUDA graph of the call, so
   the host's launch overhead is out of both numbers; B3 also with an
   ``s_real`` that masks a whole split of its cross-attention's cluster
   (finite, within the same bound), twice on one input (the same bits), and
   cold: a graph over 32 layers' distinct weights and cross-KV caches;
5. holds the s8 x s8 encoder's kernels against their plain versions at
   large-v3 shapes (B = 1 and 2, T = 1500): B5 ``ln_quant``, B7
   ``quant_only``, B8 ``add_ln_quant`` (D = 1280) and B9 ``gelu_quant`` (F =
   5120) within the codes envelope (|delta code| <= 1 on under 0.1 % of
   entries, row scales within rtol 1e-6, B8's residual exact); B9 and B5
   from the int8 GEMM's accumulators, ``gelu_quant_acc`` (W1's, F = 5120)
   and ``ln_quant_acc`` (W2's, with the residual x), on accumulators of
   seeded codes some of which pass 2**24, within the same envelope with
   ``x'`` exact, equal bit for bit to the parent route on the card (the
   torch epilogue, the eager add and the bf16 entry) and the same bits
   twice, timed in turns with their plain versions and with the parent
   route (also in graphs of 20 calls); B6
   ``encoder_attention_merged_qkv`` from the (B, T, 3840) qkv buffer
   within B11's bound, and the int8 GEMM (``torch._int_mm`` on K-major
   codes) equal to the exact int32 product at the encoder's four shapes;
   timed as in phase 4, with the library call beside B6 and B11
   (``scaled_dot_product_attention``) and the GEMM (a bf16 matmul); B6
   also at bench.py's 48 windows, (48, 1500, 3840), held to and timed in
   turns with ``scaled_dot_product_attention``, with TFLOP/s and the share
   of the bound;
6. holds the kernels of the decode's other branches against their plain
   versions at large-v3 shapes: B12 ``attnout_ln_q_fused`` at 5 and 10
   rows and B13 ``cross_attention_int8`` at (B, K) = (1, 5), (5, 1) and
   (1, 8) over int8 and int4 cross-KV, and at (1, 5) with a whole split of
   the cache masked, within the bound of B1-B4; B17
   ``gather_cache_rows`` (32 layers, 5 rows, len 480, int4 and int8 codes,
   a top-k's index and a permutation) byte for byte; timed as in phase 4,
   B17 on the permutation beside its library call (four ``index_select``
   into the spare buffers);
7. holds the tensor-parallel kernels against their plain versions at the
   shard shapes of a model axis of 1 and 2: B15 ``matmul_int8_partial``
   (DL = 1280 and 640, 5 and 10 rows), B14 ``mlp_int8_fused`` (partial
   and full, F = 5120 and 2560, 5 and 8 rows) and B16 ``ln_q_cross_int8``
   (20 and 10 local heads, (B, K) = (1, 5) and (5, 1), int4 and int8
   cross-KV, and at n = 1, (1, 5) with a whole split of the cache masked),
   within the bound of B1-B4; B15 twice on one input (the same bits);
   timed as in phase 4, B15 beside its library call (a bf16 matmul on a
   weight cast beforehand), warm and cold (a graph over the 64 distinct
   weights of a tensor-parallel step's wo and wo_c, the library call over
   the same weights in bf16), with the ``time_ms`` floor beside them;
8. drives B18 ``log_mel_spectrogram_fused`` and B19
   ``encoder_self_attention``, which no engine path calls (in either
   package), through their entry points as the JAX golden test drives the
   Pallas kernels: B18 at 128 mels on the 20 s and 45 s clips (padded and
   cut) at B = 1 and on 48 windows, within 2e-4 of its plain version (the
   port's matmul frontend in float64); B19 at (1, 1500, 20, 64) in
   bf16 and float32 within ``BF16_REL`` x max|plain|, its float32 output
   bf16-rounded; exact launch counts; timed as in phase 4, B18 beside the
   port's float32 matmul frontend (whose distance from the plain version is
   printed), B19 beside ``scaled_dot_product_attention`` (TFLOP/s and
   the share of the bound printed);
9. drives the bf16 batch CLI path: ``WhisperEngine("large-v3",
   compute_type="bfloat16")`` with random weights from a seeded generator,
   on two synthesized speech-like WAVs (20 s and 45 s, so the seek loop
   crosses a window with prompt carry), through
   ``ttasr_torch.cli.asr.process_audio_folder``; checks the results, that
   B11 ran 32 times per encoder pass, that beam decodes ran with finite
   logits, and that the encoder output agrees with the plain-attention
   encoder on one window;
10. drives the main path, the int8 engine with all its defaults:
   ``WhisperEngine("large-v3", compute_type="int8")`` (weights quantized
   on the card, the s8 x s8 encoder with B5-B9, int8 and int4 self-KV,
   int4 cross-KV, beam 5 through the ancestry map, best-of-5 fallback);
   checks the results, that B6, B7, B8 and B9 (from W1's accumulators)
   ran 32 times per encoder pass, B5 once from x and 31 times from W2's
   accumulators, the int8 GEMM 4 x 32 times, B11 never, B1, B3 and B4 32
   times per decode step, B2 32 times per beam step and B10 32 times per
   greedy step; that one window through the s8 x s8 encoder agrees with
   the same encoder on the plain versions of B5-B9; and the encoder
   through this tree's route and the parent route (W1's and W2's torch
   epilogues, the eager residual add, B9's and B5's bf16 entries) in
   turns: their outputs within ``ENCODER_REL``, one window's wall, device
   ms and kernels, and bench.py's 48 windows' wall, device ms and peak
   memory;
11. drives the decode's other branches on one encoder window of the main
   path's engine, ``BRANCH_STEPS`` tokens each, beside a main-path beam
   decode of the same window: ``beam_decode`` with
   ``TTASR_UNFUSED_RULES=1`` (the two-stage logit rules: ``_apply_rules``
   once per step, finite log-probabilities, its tokens' agreement with the
   main-path leg printed), ``beam_decode`` with a bf16 cross-KV (B12),
   ``beam_decode`` with ``beam_indirect=False`` (B17 and B10; its tokens
   must equal the main-path leg's and its step logits stay within 1.4 %
   of them with every argmax equal), ``beam_decode`` and
   ``greedy_decode`` on the weights
   ``quantize_params`` gives without ``fuse_qkv`` (the 5-D int8 self-KV,
   B13), and one 20 s file through the engine's ``transcribe`` with
   ``beam_size=10`` (B12 and the quantized cross-attention's XLA branch);
   each with exact launch counts, finite logits and its ms per step; the
   main-path leg and the unfused beam leg once more over
   ``PROFILE_STEPS`` tokens under ``torch.profiler`` (device ms, kernels
   and busy share per step);
12. drives the tensor-parallel decode (``ttasr_torch.parallel``) on the
   same window: ``TPDecoder(..., create_mesh(1, 1), row_parallel=True)``
   on a one-rank NCCL group (TP v2: B15 twice, B16 and B14 per layer),
   beam 5 held to the main-path leg (equal tokens, step logits within
   1.4 % with every argmax equal) and greedy over 5 rows held to the
   single-card fused greedy decode; ``WhisperEngine(..., mesh=
   create_mesh(1, 1))`` (TP v1, the unfused s8 x s8 encoder with B11) on
   the 20 s file at T = 0, and its own window decoded by the engine and by
   the single-card fused ``beam_decode`` (held the same way); two one-card
   controls that change only the order of f32 sums (B4 through its plain
   version; the cross-KV projected per half of the heads, as a 2-way shard
   does); then two gloo ranks on this card, mesh (1, 2) (10 local heads
   each), v2 and v1 beam 5, their step-logit gaps to the main-path leg
   held to the controls' (``CONTROL_MARGIN``); exact launch counts in
   every leg;
13. drives the int8 engine with ``encoder_act_int8=False`` (the bf16
   encoder on int8 weights, B11) on one file, with its launch counts.

Every path's counts are set to 0 just before it and read just after, and
each path ends with one 30 s window through its encoder, timed and
profiled (``torch.profiler``: device time, kernel count).  Prints one
JSON line with each kernel's launches (from the main path's run; B11's
from the bf16 path's, B12's from the bf16 cross-KV leg's, B13's from the
unfused beam leg's, B17's from the ``beam_indirect=False`` leg's, B14-B16's
from the one-rank TP v2 beam leg's, B18's and B19's from phase 8's run, B9's
bf16 entry's from one parent-route encoder pass),
worst
error, times, bound and library time, then
the card line, then the contract line ``{"ok": true, "device": {...}}``
last.
Imports nothing of jax and nothing of the JAX package.  Exits non-zero,
printing no result, when CUDA is unavailable or the checkout is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bounds over rows < t_real, relative to max|plain|
BF16_REL = 2e-2   # bf16 inputs and probabilities, f32 sums
F32_REL = 1e-4    # exact f32 products, f32 sums in another order
ENCODER_REL = 5e-2  # 32 bf16 layers, kernel vs plain attention
# int8 decode kernels vs their plain versions, relative to max|plain|: both
# round to bf16 at the same points (LN and GELU outputs, pre-scaled
# queries, scale-folded probabilities) and take exact f32 products; the f32
# sums run in another order, so a last-bit difference can flip one bf16
# rounding of an intermediate and move an output by about one bf16 step of
# one term.  New K/V codes and scales are held exactly.
DECODE_REL = 2e-3
# the encoder's row quantizers vs their plain versions: the LayerNorm's
# sums run in another order, so a code can flip by one at a .5 tie
CODE_FLIP_FRAC = 1e-3
SCALE_RTOL = 1e-6

N_LAYERS = 32  # large-v3 decoder and encoder depth

# H100 SXM 80GB HBM3 at 700 W (NVIDIA's data sheet, dense): the least time
# a kernel could take is the larger of its bytes over the memory rate and
# its operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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


def time_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call of ``fn``: ``fn`` is captured once in a
    CUDA graph and the graph replayed ``iters`` times between two CUDA
    events, so the host's per-launch overhead is not in the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel_fn, plain_fn, timer=None):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain by
    ``timer`` (default :func:`time_ms`)."""
    timer = timer or time_ms
    p1, k1, k2, p2 = (timer(plain_fn), timer(kernel_fn), timer(kernel_fn), timer(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_ms_floor() -> float:
    """``time_ms`` of one 1-element add: the floor that the host's graph
    launches put under every ``time_ms`` reading; a kernel near it is
    launch-bound in that reading, not device-bound."""
    import torch

    t = torch.zeros(1, device="cuda")
    return time_ms(lambda: t.add_(1.0))


def per_call_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of a CUDA graph of ``reps`` calls: back to back
    on the card, with no host launch between them (no ``time_ms`` floor)."""
    return time_ms(lambda: [fn() for _ in range(reps)]) / reps


def time_cold_ms(fns, iters: int = 5) -> float:
    """Device milliseconds per call of a CUDA graph that calls every ``fns``
    in turn once: each call meets its operands cold (their sum far beyond
    the 50 MB L2), as one decode step meets its 32 layers' weights."""
    return time_ms(lambda: [fn() for fn in fns], iters=iters) / len(fns)


def _same_bits(name, fn) -> None:
    """``fn()`` twice on the same input gives the same bits (fixed-order
    sums, no atomics)."""
    import torch

    outs = []
    for _ in range(2):
        out = fn()
        outs.append([t.clone() for t in (out if isinstance(out, tuple) else (out,))])
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*outs))
    print(f"{name}: the same bits on two calls with the same input: {same}")
    check(same, f"{name} gave other bits on a second call with the same input")


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _tensors(*objs):
    """The tensors among ``objs``, tuples and lists flattened."""
    import torch

    out = []
    for o in objs:
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (tuple, list)):
            out += _tensors(*o)
    return out


def bound(tensors, ops: float, kind: str) -> dict:
    """{bound_ms, bound_by}: every input read once and every output
    written once, against ``ops`` operations at the peak rate of ``kind``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (dict(bound_ms=byte_ms, bound_by="bytes") if byte_ms >= op_ms
            else dict(bound_ms=op_ms, bound_by="operations"))


def _sdpa_ms(q, k, v, t_real: int, scale: float = 1.0) -> float:
    """One ``scaled_dot_product_attention`` call on the same heads (the
    merged (B, T, D) tensors viewed as (B, H, T, 64)), keys >= t_real
    masked, scores times ``scale``: the library yardstick for B6, B11 and
    B19."""
    import torch
    import torch.nn.functional as F

    b, t, d = q.shape
    h = d // 64

    def heads(x):
        return x.view(b, t, h, 64).transpose(1, 2)

    mask = None
    if t_real < t:
        mask = (torch.arange(t, device=q.device) < t_real).view(1, 1, 1, t)
    return time_ms(lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=mask, scale=scale))


def _attention_rate(name: str, m: dict, flop: float, card: str) -> None:
    """Prints an attention kernel's achieved rate and its share of the
    bound (``m``: ms, bound_ms, library_ms)."""
    print(f"{name}: {flop / m['ms'] / 1e9:.1f} TFLOP/s ({flop / 1e9:.2f} GFLOP), "
          f"{m['bound_ms'] / m['ms']:.1%} of the bound; scaled_dot_product_attention "
          f"{flop / m['library_ms'] / 1e9:.1f} TFLOP/s ({card})")


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
        err = _max_err(got[:, :t_real], want[:, :t_real])
        scale = want[:, :t_real].float().abs().max().item()
        limit = (BF16_REL if dtype == torch.bfloat16 else F32_REL) * scale
        print(f"encoder_attention {str(dtype)[6:]} B={b} T={t} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {limit:.3e}, max|plain| {scale:.3e})")
        check(err <= limit, f"encoder attention disagrees with its plain "
                            f"version: {err} > {limit}")
        worst = max(worst, err)
        if t == t_real:
            kernel_ms, plain_ms = in_turns(
                lambda: encoder_attention_merged(q, k, v, t_real),
                lambda: encoder_attention_merged_ref(q, k, v, t_real))
            print(f"encoder_attention {str(dtype)[6:]} B={b} T={t}: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
            if dtype == torch.bfloat16 and b == 1:
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=_sdpa_ms(q, k, v, t_real),
                            **bound([q, k, v, got], 4.0 * b * t * t_real * d, "bf16"))
    print(f"encoder_attention bf16 B=1 T=1500: scaled_dot_product_attention "
          f"{main['library_ms']:.4f} ms, bound {main['bound_ms']:.4f} ms ({card})")
    _attention_rate("encoder_attention bf16 B=1 T=1500", main, 4.0 * 1500 * 1500 * d, card)
    return dict(max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# Phase 4: the int8 decode kernels at large-v3 shapes
# ---------------------------------------------------------------------------

D, H, FFN, S_PAD, S_REAL = 1280, 20, 5120, 1504, 1500
HP = 24  # ceil(H / 8) * 8 scale rows
# an s_real that masks every slot of the last of the 7 blocks that split a
# (head, audio) of beam 5 (cross_attention.cuh: int4 packed rows 648-751,
# slots 648-751 and 1400-1503; int8 slots 1290-1503)
MASKED_S_REAL = 600


class Inputs:
    """Seeded random large-v3 decode-step operands on the card."""

    def __init__(self, seed: int):
        import torch

        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(self, *shape, scale=1.0):
        import torch

        return torch.randn(shape, generator=self.gen, device="cuda") * scale

    def weight(self, k, n):
        from ttasr_torch.ops.quant import quantize_tensor

        w = quantize_tensor(self.randn(k, n, scale=0.02))
        return w["q"], w["s"]

    def vec(self, n, scale=0.02, offset=0.0):
        return self.randn(n, scale=scale) + offset

    def codes(self, *shape, levels):
        import torch

        return torch.randint(-levels, levels + 1, shape, generator=self.gen,
                             device="cuda", dtype=torch.int8)

    def layer(self):
        """One decoder layer's int8 weights and f32 vectors."""
        p = {}
        p["wqkv"], p["wqkv_s"] = self.weight(D, 3 * D)
        p["wo"], p["wo_s"] = self.weight(D, D)
        p["wqc"], p["wqc_s"] = self.weight(D, D)
        p["woc"], p["woc_s"] = self.weight(D, D)
        p["w1"], p["w1_s"] = self.weight(D, FFN)
        p["w2"], p["w2_s"] = self.weight(FFN, D)
        for name, n in (("bqkv", 3 * D), ("bo", D), ("bqc", D), ("boc", D),
                        ("b1", FFN), ("b2", D)):
            p[name] = self.vec(n)
        for ln in ("ln1", "lnc", "ln2"):
            p[ln + "_s"], p[ln + "_b"] = self.vec(D, 0.1, 1.0), self.vec(D, 0.1)
        return p

    def cross_kv(self, b, int4: bool):
        """Quantized cross-KV of b audios: codes (B, S/2, D) uint8 packed
        along S or (B, S, D) int8, scales (B, H, S), last slots padding."""
        from ttasr_torch.ops.int4 import pack_int4
        from ttasr_torch.ops.quant import quantize_kv_sym

        out = []
        for _ in range(2):
            kv = self.randn(b, S_PAD, H, 64, scale=0.5)
            kv[:, S_REAL:] = 0.0
            codes, scales = quantize_kv_sym(kv, 7 if int4 else 127)
            codes = codes.reshape(b, S_PAD, D)
            out += [pack_int4(codes) if int4 else codes,
                    scales.transpose(1, 2).contiguous()]
        return out

    def self_kv(self, b, k, length, int4: bool):
        """Flat self-KV caches (B, K, len, D or D/2) and scales (B, K, HP,
        len) with rows >= H zero."""
        import torch

        from ttasr_torch.ops.int4 import pack_int4_lanes

        out = []
        for _ in range(2):
            codes = self.codes(b, k, length, D, levels=7 if int4 else 127)
            scales = torch.zeros((b, k, HP, length), device="cuda")
            scales[:, :, :H] = self.randn(b, k, H, length).abs() * 0.02 + 1e-3
            out += [pack_int4_lanes(codes) if int4 else codes, scales]
        return out


def _hold(name, case, got, want, worst):
    """Floats within DECODE_REL x max|plain|; returns the new worst error."""
    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    print(f"{name} {case}: max_abs_err {err:.3e} (bound {DECODE_REL * scale:.3e}, "
          f"max|plain| {scale:.3e})")
    check(err <= DECODE_REL * scale,
          f"{name} {case} disagrees with its plain version: {err}")
    return max(worst, err)


def check_decode_kernels(card: str) -> dict:
    """B1, B2, B3, B4, B10 against their plain versions; returns per-kernel
    {max_abs_err, ms, plain_ms} keyed by wrapper name."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    inp = Inputs(1)
    lay = inp.layer()
    res = {}

    # B1: 5 rows
    x = inp.randn(5, D, scale=0.5)
    b1 = (x, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"], lay["bqkv"])
    worst = _hold("qkv_int8_fused", "R=5", blk.qkv_int8_fused(*b1),
                  blk.qkv_int8_fused_ref(*b1), 0.0)
    ms, plain_ms = in_turns(lambda: blk.qkv_int8_fused(*b1),
                            lambda: blk.qkv_int8_fused_ref(*b1))
    res["qkv_int8_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b1, blk.qkv_int8_fused(*b1)), 2.0 * 5 * D * 3 * D, "bf16"))

    # B3: (B, K) = (1, 5) and (5, 1), int4-packed and int8 cross-KV
    worst = 0.0
    main_b3 = None
    for b, k in ((1, 5), (5, 1)):
        for int4 in (True, False):
            ck, cks, cv, cvs = inp.cross_kv(b, int4)
            args = (inp.randn(b, k, D, scale=0.5), inp.randn(b, k, D, scale=0.5),
                    lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
                    lay["wqc"], lay["wqc_s"], lay["bqc"], ck, cks, cv, cvs, S_REAL)
            got = blk.attnout_ln_q_cross_int8(*args)
            want = blk.attnout_ln_q_cross_int8_ref(*args)
            case = f"B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
            worst = _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], worst)
            worst = _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], worst)
            if (b, k, int4) == (1, 5, True):
                main_b3 = args
    # beam 5 of one audio with a whole split of the cache masked
    for int4 in (True, False):
        args = main_b3[:10] + tuple(inp.cross_kv(1, int4)) + (MASKED_S_REAL,)
        got = blk.attnout_ln_q_cross_int8(*args)
        want = blk.attnout_ln_q_cross_int8_ref(*args)
        case = (f"B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got[1]).all()), f"attnout_ln_q_cross_int8 {case}: not finite")
        worst = _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], worst)
        worst = _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], worst)
    _same_bits("attnout_ln_q_cross_int8 B=1 K=5 int4",
               lambda: blk.attnout_ln_q_cross_int8(*main_b3))
    ms, plain_ms = in_turns(lambda: blk.attnout_ln_q_cross_int8(*main_b3),
                            lambda: blk.attnout_ln_q_cross_int8_ref(*main_b3))
    # cold: 32 layers' wo, cross query and cross-KV, one call each
    cold = []
    for _ in range(N_LAYERS):
        (wo, wo_s), (wqc, wqc_s) = inp.weight(D, D), inp.weight(D, D)
        layer = (main_b3[0], main_b3[1], wo, wo_s, lay["bo"], lay["lnc_s"], lay["lnc_b"],
                 wqc, wqc_s, lay["bqc"], *inp.cross_kv(1, True), S_REAL)
        cold.append(lambda a=layer: blk.attnout_ln_q_cross_int8(*a))
    cold_ms = time_cold_ms(cold)
    print(f"attnout_ln_q_cross_int8 B=1 K=5 int4: warm {ms:.4f} ms, cold {cold_ms:.4f} ms "
          f"(a graph over {N_LAYERS} layers' weights and cross-KV) ({card})")
    del cold
    # wo and the cross query (2 x 2 R D^2), scores and values over S_REAL
    b3_ops = 2.0 * 2 * 5 * D * D + 2.0 * 2 * 5 * S_REAL * D
    res["attnout_ln_q_cross_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main_b3, blk.attnout_ln_q_cross_int8(*main_b3)), b3_ops, "bf16"))

    # B4: 5 rows
    b4 = (inp.randn(5, D, scale=0.5), inp.randn(5, D, scale=0.5),
          lay["woc"], lay["woc_s"], lay["boc"], lay["ln2_s"], lay["ln2_b"],
          lay["w1"], lay["w1_s"], lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])
    worst = _hold("mlp_with_crossout_int8", "R=5", mlp.mlp_with_crossout_int8(*b4),
                  mlp.mlp_with_crossout_int8_ref(*b4), 0.0)
    ms, plain_ms = in_turns(lambda: mlp.mlp_with_crossout_int8(*b4),
                            lambda: mlp.mlp_with_crossout_int8_ref(*b4))
    res["mlp_with_crossout_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b4, mlp.mlp_with_crossout_int8(*b4)),
                2.0 * 5 * (D * D + 2 * D * FFN), "bf16"))

    res.update(check_self_attention(inp, card))

    for name, r in res.items():
        r["library_ms"] = None  # no single PyTorch call computes these
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
    time_layer_chain(inp, lay, card)
    return res


# B2/B10 cache lengths and slots timed (480: the main path's last growth
# bucket; 64: an early one), and the longest the wrapper takes: at the 2
# splits of 100 (head, row) clusters one block's range would not fit
# shared memory, so the kernel takes more
SELF_LENGTHS = ((480, 477), (288, 285), (64, 40))
SELF_LONG = 4096


def _self_step(inp: Inputs, b, k, length, slot, pads, int4):
    """B2's (k > 1, a random ancestry map) or B10's (k = 1) wrapper, plain
    version and arguments at one length."""
    import torch

    from ttasr_torch.ops import self_attention as sa

    kc, ks, vc, vs = inp.self_kv(b, k, length, int4)
    qkv = inp.randn(b, k, 3 * D, scale=0.5)
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda").reshape(b, k)
    if k > 1:
        anc = torch.randint(0, k, (b, k, length), generator=inp.gen, device="cuda",
                            dtype=torch.int32)
        return (sa.self_attn_step_indirect_int8, sa.self_attn_step_indirect_int8_ref,
                (qkv, kc, ks, vc, vs, anc, pad, slot))
    return sa.self_attn_step_int8, sa.self_attn_step_int8_ref, (qkv, kc, ks, vc, vs, pad, slot)


def check_self_attention(inp: Inputs, card: str) -> dict:
    """B2 (beam 5 of one audio, through anc) and B10 (5 audios x 1 row)
    against their plain versions: len 288 and 480 with two pad sets, a
    slot or pads that mask whole splits, len SELF_LONG; int4 and int8; new
    codes and scales exact, the same bits twice; warm at SELF_LENGTHS (one
    call per replay and in graphs of 20), cold over 32 layers' caches."""
    import torch

    res = {}
    for name, b, k in (("self_attn_step_indirect_int8", 1, 5),
                       ("self_attn_step_int8", 5, 1)):
        # B2: audio-uniform pads (the beams share the prompt); B10: per row
        pad_sets = [[0] * 5, [100] * 5] if k == 5 else [[0, 3, 100, 7, 250], [41] * 5]
        cases = [(length, length - 3, pads, "") for length in (288, 480) for pads in pad_sets]
        # 2 splits of 240 positions at len 480: B2's slot 150 masks rank 1,
        # B10's pads 330 rank 0
        cases.append((480, 150, [0] * 5, " (split 2 of 2 masked)") if k == 5
                     else (480, 477, [330] * 5, " (split 1 of 2 masked)"))
        cases.append((SELF_LONG, SELF_LONG - 3, pad_sets[0], " (longer than one block's stage)"))
        worst, main = 0.0, None
        for length, slot, pads, note in cases:
            for int4 in (True, False):
                fn, ref, args = _self_step(inp, b, k, length, slot, pads, int4)
                kw = dict(n_heads=H, int4=int4)
                got, want = fn(*args, **kw), ref(*args, **kw)
                case = (f"B={b} K={k} len={length} slot={slot} pad={pads[:2]} "
                        f"{'int4' if int4 else 'int8'}{note}")
                check(bool(torch.isfinite(got[0]).all()), f"{name} {case}: not finite")
                worst = _hold(name, case, got[0], want[0], worst)
                for i, what in ((1, "k codes"), (2, "k scales"), (3, "v codes"),
                                (4, "v scales")):
                    check(torch.equal(got[i], want[i]),
                          f"{name} {case}: new {what} differ from the plain version")
                if length == 480 and int4 and main is None:
                    main = (fn, ref, args, kw)
        print(f"{name}: new codes and scales exact in every case")
        fn, ref, args, kw = main
        _same_bits(f"{name} B={b} K={k} len=480 int4", lambda: fn(*args, **kw))
        ms, plain_ms = in_turns(lambda: fn(*args, **kw), lambda: ref(*args, **kw))
        for length, slot in SELF_LENGTHS:
            f, _, a = _self_step(inp, b, k, length, slot, [0] * 5, True)
            call = (lambda f=f, a=a: f(*a, n_heads=H, int4=True))
            print(f"{name} B={b} K={k} len={length} slot={slot} int4: time_ms "
                  f"{time_ms(call):.4f}, in a graph of 20 {per_call_ms(call):.4f} ms per "
                  f"call ({card})")
        cold = []
        for _ in range(N_LAYERS):
            f, _, a = _self_step(inp, b, k, 480, 477, [0] * 5, True)
            cold.append(lambda f=f, a=a: f(*a, n_heads=H, int4=True))
        print(f"{name} B={b} K={k} len=480 int4: warm {ms:.4f} ms, cold "
              f"{time_cold_ms(cold):.4f} ms (a graph over {N_LAYERS} layers' caches) ({card})")
        del cold
        # scores and values over positions pad..slot of each row (the
        # caches' bytes counted whole)
        pad, slot = args[-2], args[-1]
        positions = float((slot + 1 - pad).sum().item())
        res[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         **bound(_tensors(args, fn(*args, **kw)),
                                 2.0 * 2 * positions * D, "bf16"))
    return res


def time_layer_chain(inp: Inputs, lay: dict, card: str) -> dict:
    """One decoder layer of a beam-5 step at cache length 480 (int4 self-
    and cross-KV): B1 -> B2 -> B3 -> B4 against the plain chain."""
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import self_attention as sa

    import torch

    b, k, length = 1, 5, 480
    kc, ks, vc, vs = inp.self_kv(b, k, length, True)
    ck, cks, cv, cvs = inp.cross_kv(b, True)
    anc = torch.randint(0, k, (b, k, length), generator=inp.gen, device="cuda",
                        dtype=torch.int32)
    pad = torch.zeros((b, k), dtype=torch.int32, device="cuda")
    x = inp.randn(b * k, D, scale=0.5)

    def chain(f1, f2, f3, f4):
        qkv = f1(x, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"], lay["bqkv"])
        attn = f2(qkv.reshape(b, k, 3 * D), kc, ks, vc, vs, anc, pad, length - 1,
                  n_heads=H, int4=True)[0]
        xo, cross = f3(x.reshape(b, k, D), attn, lay["wo"], lay["wo_s"], lay["bo"],
                       lay["lnc_s"], lay["lnc_b"], lay["wqc"], lay["wqc_s"], lay["bqc"],
                       ck, cks, cv, cvs, S_REAL)
        return f4(xo.reshape(b * k, D), cross.reshape(b * k, D), lay["woc"], lay["woc_s"],
                  lay["boc"], lay["ln2_s"], lay["ln2_b"], lay["w1"], lay["w1_s"],
                  lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])

    kernels = (blk.qkv_int8_fused, sa.self_attn_step_indirect_int8,
               blk.attnout_ln_q_cross_int8, mlp.mlp_with_crossout_int8)
    plains = (blk.qkv_int8_fused_ref, sa.self_attn_step_indirect_int8_ref,
              blk.attnout_ln_q_cross_int8_ref, mlp.mlp_with_crossout_int8_ref)
    got, want = chain(*kernels), chain(*plains)
    err = _max_err(got, want)
    scale = want.abs().max().item()
    print(f"layer chain B1->B2->B3->B4 (beam 5, len 480, int4): max_abs_err "
          f"{err:.3e} (max|plain| {scale:.3e})")
    check(err <= DECODE_REL * scale, f"the kernel chain disagrees with the plain chain: {err}")
    ms, plain_ms = in_turns(lambda: chain(*kernels), lambda: chain(*plains))
    print(f"layer chain: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms per layer; "
          f"x 32 layers = {32 * ms:.3f} vs {32 * plain_ms:.3f} ms of device time "
          f"per beam step ({card})")
    return dict(ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# Phase 5: the s8 x s8 encoder's kernels at large-v3 shapes
# ---------------------------------------------------------------------------

ENC_T = 1500  # encoder positions of a 30 s window


def _hold_codes(name, case, got, want):
    """Codes within the envelope, scales within SCALE_RTOL; returns the
    largest code difference."""
    dq = (got[0].int() - want[0].int()).abs()
    worst, frac = dq.max().item(), (dq > 0).float().mean().item()
    rel = ((got[1] - want[1]).abs() / want[1].abs()).max().item()
    print(f"{name} {case}: max |delta code| {worst}, on {frac:.2e} of codes; "
          f"scales max rel err {rel:.2e}")
    check(worst <= 1 and frac < CODE_FLIP_FRAC,
          f"{name} {case}: codes outside the envelope ({worst}, {frac})")
    check(rel <= SCALE_RTOL, f"{name} {case}: scales differ by {rel}")
    return float(worst)


def _b6_windows(gen, colscale, card: str) -> dict:
    """B6 at bench.py's MEL_WINDOWS windows ((48, 1500, 3840) bf16, each
    window's attention 32 times per encoder pass there), held to
    ``scaled_dot_product_attention`` on the same heads within B11's bound
    and timed beside it in turns."""
    import torch
    import torch.nn.functional as F

    from ttasr_torch.ops.encoder_attention import encoder_attention_merged_qkv

    b = MEL_WINDOWS
    qkv = (torch.randn((b, ENC_T, 3 * D), generator=gen, device="cuda") * colscale
           ).to(torch.bfloat16)

    def heads(x):
        return x.view(b, ENC_T, H, 64).transpose(1, 2)

    q, k, v = heads(qkv[..., :D]), heads(qkv[..., D:2 * D]), heads(qkv[..., 2 * D:])
    got = encoder_attention_merged_qkv(qkv, ENC_T)
    want = F.scaled_dot_product_attention(q, k, v, scale=1.0).transpose(1, 2).reshape(
        b, ENC_T, D)
    err = _max_err(got, want)
    limit = BF16_REL * want.float().abs().max().item()
    print(f"encoder_attention_merged_qkv B={b} T={ENC_T}: max_abs_err {err:.3e} against "
          f"scaled_dot_product_attention (bound {limit:.3e})")
    check(err <= limit, f"B6 at B={b} disagrees with scaled_dot_product_attention: {err}")
    ms, sdpa_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, ENC_T),
                           lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    m = dict(ms=ms, library_ms=sdpa_ms, **bound([qkv, got], 4.0 * b * ENC_T * ENC_T * D, "bf16"))
    print(f"encoder_attention_merged_qkv B={b} T={ENC_T}: kernel {ms:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {m['bound_ms']:.4f} ms "
          f"({card})")
    _attention_rate(f"encoder_attention_merged_qkv B={b} T={ENC_T}", m,
                    4.0 * b * ENC_T * ENC_T * D, card)
    return m


def _acc_case(gen, b, k, n):
    """W1's (k, n) = (D, FFN) or W2's (FFN, D) accumulators (b, ENC_T, n)
    from the int8 GEMM on seeded codes, the first rows and columns all 127
    so some pass 2**24 (where the int -> float conversion rounds), with
    row scales, column scales and a bf16 bias of the encoder's magnitudes
    (outputs of a few units)."""
    import torch

    from ttasr_torch.ops import quant

    a = torch.randint(-127, 128, (b * ENC_T, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    a[:3] = 127
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    w[:, :4] = 127
    acc = quant._int8_product(a, quant.kmajor(w)).view(b, ENC_T, n)
    check(acc.abs().max().item() > 2 ** 24, "no accumulator beyond 2**24")
    xs = torch.rand((b, ENC_T, 1), generator=gen, device="cuda") * 0.045 + 0.005
    ws = torch.rand((1, n), generator=gen, device="cuda") * 8e-4 + 2e-4
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return acc, xs, ws, bias


def parent_gelu_quant_acc(acc, xs, w_scale, b):
    """The parent route of B9: W1's torch epilogue, then the bf16 entry."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.quant import act8_epilogue

    return ef.gelu_quant(act8_epilogue(acc, xs, w_scale, b, torch.bfloat16))


def parent_ln_quant_acc(x, acc, xs, w_scale, b, scale, bias):
    """The parent route of B5 after W2: the torch epilogue, the eager bf16
    residual add, then the bf16 entry."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.quant import act8_epilogue

    x2 = x + act8_epilogue(acc, xs, w_scale, b, torch.bfloat16)
    return (x2, *ef.ln_quant(x2, scale, bias))


def _check_acc_entries(gen, ln_s, ln_b, act, card: str) -> dict:
    """B9 and B5 from the accumulators at B = 1 and 2: against their plain
    versions (x' exact, codes within the envelope), against the parent
    route on the card bit for bit (B9: an exact epilogue, a GELU per
    element, an absmax in any order; B5: ``ln_quant`` runs the same
    template, so its LayerNorm sums in the same order), the same bits
    twice; at B = 1 timed in turns with the plain version and with the
    parent route (``time_ms`` and graphs of 20 calls)."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    res = {}
    for b in (1, 2):
        w1 = _acc_case(gen, b, D, FFN)
        x = act(b, ENC_T, D)
        w2 = _acc_case(gen, b, FFN, D)
        cases = {  # name: (kernel, plain, parent route, args, operations per element)
            "gelu_quant_acc": (ef.gelu_quant_acc, ef.gelu_quant_acc_ref,
                               parent_gelu_quant_acc, w1, 30),
            "ln_quant_acc": (ef.ln_quant_acc, ef.ln_quant_acc_ref, parent_ln_quant_acc,
                             (x, *w2, ln_s, ln_b), 20),
        }
        for name, (fn, ref, parent, args, per_elem) in cases.items():
            acc = args[0] if name == "gelu_quant_acc" else args[1]
            got, want, old = fn(*args), ref(*args), parent(*args)
            case = f"B={b} T={ENC_T} width={got[-2].shape[-1]}"
            same = all(torch.equal(g, o) for g, o in zip(got, old))
            print(f"{name} {case}: equal to the parent route bit for bit: {same}")
            check(same, f"{name} {case}: differs from the parent route on the card")
            if name == "ln_quant_acc":
                check(torch.equal(got[0], want[0]),
                      f"{name} {case}: the bf16 residual x' differs from the plain version")
                got, want = got[1:], want[1:]
            err = _hold_codes(name, case, got, want)
            _same_bits(f"{name} {case}", lambda: fn(*args))
            r = res.setdefault(name, dict(max_abs_err=0.0, library_ms=None))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if b == 1:
                r["ms"], r["plain_ms"] = in_turns(lambda: fn(*args), lambda: ref(*args))
                r["ms_beside_parent"], r["parent_ms"] = in_turns(
                    lambda: fn(*args), lambda: parent(*args))
                r["graph20_ms"], r["graph20_parent_ms"] = in_turns(
                    lambda: fn(*args), lambda: parent(*args), timer=per_call_ms)
                # the column vectors are read as f32
                ins = [a.float() if a.dim() == 1 else a for a in args]
                r.update(bound(_tensors(ins, fn(*args)), float(per_elem * acc.numel()),
                               "f32"))
                print(f"{name} B=1: kernel {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}); "
                      f"in turns with the parent route {r['ms_beside_parent']:.4f} against "
                      f"{r['parent_ms']:.4f} ms; graphs of 20 {r['graph20_ms']:.4f} against "
                      f"{r['graph20_parent_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}) ({card})")
    return res


def check_encoder_kernels(card: str) -> dict:
    """B5, B6, B7, B8 and B9 (both B5 and B9 entries) against their plain
    versions, and the int8 GEMM against the exact product; returns
    per-kernel measurements keyed by wrapper name, and the GEMM's under
    ``int8_gemm``."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import quant
    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged_qkv,
        encoder_attention_merged_qkv_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)

    def act(*shape, scale=1.0):
        """bf16 activations, rows of different magnitude."""
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        spread = torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") * 3.9 + 0.1
        return (x * spread).to(torch.bfloat16)

    ln_s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    ln_b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    res = {}
    for b in (1, 2):
        x, y, h = act(b, ENC_T, D), act(b, ENC_T, D, scale=0.5), act(b, ENC_T, FFN, scale=2.0)
        cases = {  # name: (kernel, plain, args, operations per element)
            "ln_quant": (ef.ln_quant, ef.ln_quant_ref, (x, ln_s, ln_b), 14),
            "quant_only": (ef.quant_only, ef.quant_only_ref, (x,), 4),
            "add_ln_quant": (ef.add_ln_quant, ef.add_ln_quant_ref, (x, y, ln_s, ln_b), 15),
            "gelu_quant": (ef.gelu_quant, ef.gelu_quant_ref, (h,), 26),
        }
        for name, (fn, ref, args, per_elem) in cases.items():
            got, want = fn(*args), ref(*args)
            case = f"B={b} T={ENC_T} width={args[0].shape[-1]}"
            if name == "add_ln_quant":
                check(torch.equal(got[0], want[0]),
                      f"add_ln_quant {case}: the bf16 residual differs")
                got, want = got[1:], want[1:]
            err = _hold_codes(name, case, got, want)
            r = res.setdefault(name, dict(max_abs_err=0.0, library_ms=None))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if b == 1:
                r["ms"], r["plain_ms"] = in_turns(lambda: fn(*args), lambda: ref(*args))
                # the LN parameters are read as f32
                ins = [a.float() if a.dim() == 1 else a for a in args]
                r.update(bound(_tensors(ins, fn(*args)),
                               float(per_elem * args[0].numel()), "f32"))

    res.update(_check_acc_entries(gen, ln_s, ln_b, act, card))

    # B6: q/K/V straight from the fused qkv buffer, q pre-scaled
    worst = 0.0
    colscale = torch.ones(3 * D, device="cuda")
    colscale[:D] = 0.125
    for b, t_real in ((1, ENC_T), (2, ENC_T), (2, 1400)):
        qkv = (torch.randn((b, ENC_T, 3 * D), generator=gen, device="cuda") * colscale
               ).to(torch.bfloat16)
        got = encoder_attention_merged_qkv(qkv, t_real)
        want = encoder_attention_merged_qkv_ref(qkv, t_real)
        err = _max_err(got[:, :t_real], want[:, :t_real])
        scale = want[:, :t_real].float().abs().max().item()
        print(f"encoder_attention_merged_qkv B={b} T={ENC_T} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {BF16_REL * scale:.3e})")
        check(err <= BF16_REL * scale, f"B6 disagrees with its plain version: {err}")
        worst = max(worst, err)
        if b == 1:
            ms, plain_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, t_real),
                                    lambda: encoder_attention_merged_qkv_ref(qkv, t_real))
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=_sdpa_ms(
                qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], t_real),
                **bound([qkv, got], 4.0 * b * ENC_T * t_real * D, "bf16"))
    res["encoder_attention_merged_qkv"] = dict(max_abs_err=worst, **main)
    _attention_rate(f"encoder_attention_merged_qkv B=1 T={ENC_T}", main,
                    4.0 * ENC_T * ENC_T * D, card)
    res["b6_windows"] = _b6_windows(gen, colscale, card)

    # the int8 GEMM at the encoder's four shapes, K-major codes
    gemm = {}
    for k, n in ((D, 3 * D), (D, D), (D, FFN), (FFN, D)):
        for m in (ENC_T, 2 * ENC_T, 5):
            a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = quant.kmajor(torch.randint(-127, 128, (k, n), generator=gen,
                                           device="cuda", dtype=torch.int8))
            acc = quant._int8_product(a, w)
            exact = torch.matmul(a.double(), w.double())  # |sum| < 2**53: exact
            check(acc.dtype == torch.int32 and torch.equal(acc.double(), exact),
                  f"int8 GEMM M={m} K={k} N={n} differs from the exact product")
        a = torch.randint(-127, 128, (ENC_T, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        acc = quant._int8_product(a, w)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        xs = torch.rand((ENC_T, 1), generator=gen, device="cuda") * 1e-2
        leaf = {"q": w, "s": torch.rand((1, n), generator=gen, device="cuda") * 1e-3}
        g = dict(ms=time_ms(lambda: quant._int8_product(a, w)),
                 epilogue_ms=time_ms(lambda: quant.quant_matmul_act8(a, xs, leaf)),
                 bf16_matmul_ms=time_ms(lambda: torch.matmul(ab, wb)),
                 **bound([a, w, acc], 2.0 * ENC_T * k * n, "int8"))
        try:  # the layout probe: row-major (K, N) codes
            rm = w.contiguous()
            torch._int_mm(a, rm)
            g["row_major_ms"] = time_ms(lambda: torch._int_mm(a, rm))
        except RuntimeError as exc:
            g["row_major_ms"] = f"refused: {str(exc).splitlines()[0][:120]}"
        gemm[f"{ENC_T}x{k}x{n}"] = g
        print(f"int8 GEMM M={ENC_T} K={k} N={n}: _int_mm {g['ms']:.4f} ms, with "
              f"the scale/bias epilogue {g['epilogue_ms']:.4f} ms, bf16 matmul "
              f"{g['bf16_matmul_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms, "
              f"row-major codes {g['row_major_ms']} ({card})")
    try:
        quant._int8_product(a, w.contiguous())
        check(False, "the GEMM wrapper took row-major codes")
    except ValueError:
        pass
    print("int8 GEMM: int32 accumulators equal the exact product at every shape")
    for name in ("ln_quant", "quant_only", "add_ln_quant", "gelu_quant",
                 "encoder_attention_merged_qkv"):
        r = res[name]
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
    res["int8_gemm"] = gemm
    return res


# ---------------------------------------------------------------------------
# Phase 6: the kernels of the decode's other branches at large-v3 shapes
# ---------------------------------------------------------------------------

BEAM_ROWS, CACHE_LEN = 5, 480  # B17: beam 5 of one audio, the last bucket


def check_branch_kernels(card: str) -> dict:
    """B12, B13 and B17 against their plain versions; returns per-kernel
    measurements keyed by wrapper name."""
    import torch

    from ttasr_torch.ops import beam_gather as bg
    from ttasr_torch.ops import cross_attention as ca
    from ttasr_torch.ops import decoder_blocks as blk

    inp = Inputs(3)
    lay = inp.layer()
    res = {}

    # B12: 5 rows (a bf16 cross-KV at beam 5) and 10 (beam 10 of one audio)
    worst = 0.0
    for r in (5, 10):
        b12 = (inp.randn(r, D, scale=0.5), inp.randn(r, D, scale=0.5),
               lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
               lay["wqc"], lay["wqc_s"], lay["bqc"])
        got, want = blk.attnout_ln_q_fused(*b12), blk.attnout_ln_q_fused_ref(*b12)
        worst = _hold("attnout_ln_q_fused", f"R={r} x'", got[0], want[0], worst)
        worst = _hold("attnout_ln_q_fused", f"R={r} qc", got[1], want[1], worst)
    ms, plain_ms = in_turns(lambda: blk.attnout_ln_q_fused(*b12),
                            lambda: blk.attnout_ln_q_fused_ref(*b12))
    res["attnout_ln_q_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b12, blk.attnout_ln_q_fused(*b12)), 2.0 * 2 * 10 * D * D, "bf16"))

    # B13: bf16 queries (the served dtype) over int8 and int4 cross-KV
    worst, main = 0.0, None
    for b, k in ((1, 5), (5, 1), (1, 8)):
        for int4 in (False, True):
            ck, cks, cv, cvs = inp.cross_kv(b, int4)
            b13 = (inp.randn(b, k, H, 64, scale=0.5).to(torch.bfloat16),
                   ck, cks, cv, cvs, S_REAL)
            case = f"B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
            worst = _hold("cross_attention_int8", case, ca.cross_attention_int8(*b13),
                          ca.cross_attention_int8_ref(*b13), worst)
            if (b, k, int4) == (1, 5, False):  # the unfused beam leg's shape
                main = b13
    for int4 in (False, True):  # a whole split of the cache masked
        b13 = (main[0], *inp.cross_kv(1, int4), MASKED_S_REAL)
        got = ca.cross_attention_int8(*b13)
        case = (f"B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got).all()), f"cross_attention_int8 {case}: not finite")
        worst = _hold("cross_attention_int8", case, got, ca.cross_attention_int8_ref(*b13), worst)
    ms, plain_ms = in_turns(lambda: ca.cross_attention_int8(*main),
                            lambda: ca.cross_attention_int8_ref(*main))
    # scores and values of 5 rows over the S_REAL valid slots
    res["cross_attention_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, ca.cross_attention_int8(*main)),
                2.0 * 2 * 5 * S_REAL * D, "bf16"))

    # B17: every layer's rows of a beam-5 cache, held byte for byte on a
    # top-k's index (a repeat, a drop and a move) and on a permutation;
    # timed and bounded on the permutation, which reads every row once
    top_k_idx, perm = (torch.tensor(i, dtype=torch.int32, device="cuda")
                       for i in ([3, 3, 0, 4, 1], [3, 0, 4, 1, 2]))
    for int4 in (False, True):
        width, dtype, lo, hi = ((D // 2, torch.uint8, 0, 256) if int4
                                else (D, torch.int8, -128, 128))
        codes = [torch.randint(lo, hi, (N_LAYERS, BEAM_ROWS, CACHE_LEN, width),
                               generator=inp.gen, device="cuda", dtype=dtype)
                 for _ in range(2)]
        scales = [inp.randn(N_LAYERS, BEAM_ROWS, HP, CACHE_LEN) for _ in range(2)]
        b17 = (*codes, *scales)
        spare = tuple(torch.empty_like(t) for t in b17)
        for idx in (top_k_idx, perm):
            got = bg.gather_cache_rows(*b17, idx, out=spare)
            want = bg.gather_cache_rows_ref(*b17, idx)
            for g, w in zip(got, want):
                check(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                      f"gather_cache_rows {'int4' if int4 else 'int8'} "
                      f"idx {idx.tolist()}: bytes differ from index_select")
        print(f"gather_cache_rows L={N_LAYERS} BK={BEAM_ROWS} T={CACHE_LEN} "
              f"{'int4' if int4 else 'int8'}: equal to index_select byte for byte")
    ms, plain_ms = in_turns(lambda: bg.gather_cache_rows(*b17, perm, out=spare),
                            lambda: bg.gather_cache_rows_ref(*b17, perm))
    long_perm = perm.long()
    library_ms = time_ms(lambda: [torch.index_select(t, 1, long_perm, out=o)
                                  for t, o in zip(b17, spare)])
    res["gather_cache_rows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(_tensors((*b17, perm), spare), 0.0, "f32"))

    for name, r in res.items():
        r.setdefault("library_ms", None)  # no single PyTorch call for B12, B13
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 7: the tensor-parallel kernels at large-v3 shard shapes
# ---------------------------------------------------------------------------

def check_tp_kernels(card: str) -> dict:
    """B15, B14 and B16 against their plain versions at the shapes of a
    model axis of n = 1 and n = 2 (a shard's rows of wo/wo_c/w2, columns of
    w1 and cross-q, local heads); timed at n = 1 with 5 rows, the one-card
    TP leg's shapes.  Returns per-kernel measurements keyed by wrapper
    name."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    inp = Inputs(4)
    res = {}

    # B15: a shard's DL = D / n input columns, 5 and 10 rows
    worst, main = 0.0, None
    for n in (1, 2):
        wq, ws = inp.weight(D // n, D)
        for r in (5, 10):
            b15 = (inp.randn(r, D // n, scale=0.5), wq, ws)
            worst = _hold("matmul_int8_partial", f"n={n} DL={D // n} R={r}",
                          blk.matmul_int8_partial(*b15),
                          blk.matmul_int8_partial_ref(*b15), worst)
            if (n, r) == (1, 5):
                main = b15
    _same_bits("matmul_int8_partial n=1 R=5", lambda: blk.matmul_int8_partial(*main))
    ms, plain_ms = in_turns(lambda: blk.matmul_int8_partial(*main),
                            lambda: blk.matmul_int8_partial_ref(*main))
    x, wq, ws = main
    w_bf16 = wq.to(torch.bfloat16)  # cast once, outside the timed call
    library_ms = time_ms(lambda: torch.matmul(x.to(torch.bfloat16), w_bf16))
    res["matmul_int8_partial"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(_tensors(main, blk.matmul_int8_partial(*main)),
                2.0 * 5 * D * D, "bf16"))
    # cold: the 64 row-split projections of a TP v2 step (wo, wo_c per
    # layer), and the library call over the same weights cast to bf16
    weights = [inp.weight(D, D) for _ in range(2 * N_LAYERS)]
    cold_ms = time_cold_ms([lambda w=w: blk.matmul_int8_partial(x, *w) for w in weights])
    cold_bf16 = [w.to(torch.bfloat16) for w, _ in weights]
    cold_library_ms = time_cold_ms(
        [lambda w=w: torch.matmul(x.to(torch.bfloat16), w) for w in cold_bf16])
    del weights, cold_bf16
    print(f"matmul_int8_partial R=5 DL=1280: warm {ms:.4f} ms, library {library_ms:.4f}; "
          f"cold {cold_ms:.4f}, library cold {cold_library_ms:.4f} (a graph over "
          f"{2 * N_LAYERS} weights); time_ms floor {time_ms_floor():.4f} ms ({card})")

    # B14: F / n hidden columns, partial (TP v2) and full, 5 and 8 rows
    worst, main = 0.0, None
    for n in (1, 2):
        f = FFN // n
        w1, w1_s = inp.weight(D, f)
        w2, w2_s = inp.weight(f, D)
        vecs = (inp.vec(D, 0.1, 1.0), inp.vec(D, 0.1), w1, w1_s, inp.vec(f),
                w2, w2_s, inp.vec(D))
        for r in (5, 8):
            for partial in (True, False):
                b14 = (inp.randn(r, D, scale=0.5), *vecs)
                worst = _hold("mlp_int8_fused", f"n={n} F={f} R={r} partial={partial}",
                              mlp.mlp_int8_fused(*b14, partial=partial),
                              mlp.mlp_int8_fused_ref(*b14, partial=partial), worst)
                if (n, r, partial) == (1, 5, True):
                    main = b14
    ms, plain_ms = in_turns(lambda: mlp.mlp_int8_fused(*main, partial=True),
                            lambda: mlp.mlp_int8_fused_ref(*main, partial=True))
    res["mlp_int8_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, mlp.mlp_int8_fused(*main, partial=True)),
                2.0 * 5 * 2 * D * FFN, "bf16"))

    # B16: H / n local heads over int4 and int8 cross-KV, (B, K) = (1, 5)
    # and (5, 1), 1500 of 1504 slots valid
    worst, main = 0.0, None
    for n in (1, 2):
        h_loc = H // n
        wqc, wqc_s = inp.weight(D, h_loc * 64)
        for b, k in ((1, 5), (5, 1)):
            for int4 in (True, False):
                ck, cks, cv, cvs = inp.cross_kv(b, int4)
                ck, cv = (t[..., :h_loc * 64].contiguous() for t in (ck, cv))
                cks, cvs = (t[:, :h_loc].contiguous() for t in (cks, cvs))
                b16 = (inp.randn(b, k, D, scale=0.5), inp.vec(D, 0.1, 1.0),
                       inp.vec(D, 0.1), wqc, wqc_s, inp.vec(h_loc * 64),
                       ck, cks, cv, cvs, S_REAL)
                case = f"n={n} H_loc={h_loc} B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
                worst = _hold("ln_q_cross_int8", case, blk.ln_q_cross_int8(*b16),
                              blk.ln_q_cross_int8_ref(*b16), worst)
                if (n, b, k, int4) == (1, 1, 5, True):
                    main = b16
    for int4 in (True, False):  # n = 1, beam 5, a whole split of the cache masked
        b16 = main[:6] + tuple(inp.cross_kv(1, int4)) + (MASKED_S_REAL,)
        got = blk.ln_q_cross_int8(*b16)
        case = (f"n=1 B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got).all()), f"ln_q_cross_int8 {case}: not finite")
        worst = _hold("ln_q_cross_int8", case, got, blk.ln_q_cross_int8_ref(*b16), worst)
    ms, plain_ms = in_turns(lambda: blk.ln_q_cross_int8(*main),
                            lambda: blk.ln_q_cross_int8_ref(*main))
    # the cross query (2 R D DC), scores and values over S_REAL
    res["ln_q_cross_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, blk.ln_q_cross_int8(*main)),
                2.0 * 5 * D * D + 2.0 * 2 * 5 * S_REAL * D, "bf16"))

    for name, r in res.items():
        r.setdefault("library_ms", None)  # no single PyTorch call for B14, B16
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})")
    return res


@contextlib.contextmanager
def plain_encoder_kernels():
    """The s8 x s8 encoder on the plain versions of B5-B9, both entries of
    B5 and B9 (the int8 GEMM is exact either way)."""
    from ttasr_torch.models.whisper import model
    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import encoder_attention as ea

    saved = [(ef, n, getattr(ef, n)) for n in ("ln_quant", "quant_only", "add_ln_quant",
                                               "gelu_quant", "gelu_quant_acc",
                                               "ln_quant_acc")]
    saved.append((model, "encoder_attention_merged_qkv", model.encoder_attention_merged_qkv))
    try:
        for mod, name, _ in saved[:-1]:
            setattr(mod, name, getattr(ef, name + "_ref"))
        model.encoder_attention_merged_qkv = ea.encoder_attention_merged_qkv_ref
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _act8_encoder_launches(passes: int, gemms: int = 4) -> dict:
    """The fused-quant s8 x s8 encoder's row-kernel and GEMM launches over
    ``passes`` passes: B5 from x in layer 0 and from W2's accumulators in
    the layers after it, B9 from W1's accumulators, B7, B8 and ``gemms``
    int8 GEMMs per layer (4 with the fused qkv leaf, 6 without)."""
    L = N_LAYERS
    return dict(ln_quant=passes, ln_quant_acc=(L - 1) * passes, quant_only=L * passes,
                add_ln_quant=L * passes, gelu_quant_acc=L * passes,
                quant_matmul_act8=gemms * L * passes)


@contextlib.contextmanager
def parent_encoder_route():
    """The s8 x s8 encoder as the parent tree ran it: W1's and W2's torch
    epilogues, the eager residual add, and the bf16 entries of B9 and B5,
    in place of the entries that read the accumulators (the last layer's
    W2 epilogue and add run in ``encode`` on either route)."""
    from ttasr_torch.ops import encoder_fused as ef

    saved = ef.gelu_quant_acc, ef.ln_quant_acc
    ef.gelu_quant_acc, ef.ln_quant_acc = parent_gelu_quant_acc, parent_ln_quant_acc
    try:
        yield
    finally:
        ef.gelu_quant_acc, ef.ln_quant_acc = saved


def _encoder_windows(engine, batch, label: str, card: str) -> dict:
    """``batch`` (bench.py's MEL_WINDOWS windows) through the engine's
    encoder: the wall of a call ended by a synchronise (median of 3 after a
    warm-up), the peak device memory of one call, and one call under
    ``torch.profiler`` (device ms, kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.encode_windows(batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.encode_windows(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.encode_windows(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    m = dict(wall_ms=sorted(times)[1], device_ms=sum(e.self_device_time_total
                                                     for e in kernels) / 1e3,
             kernels=sum(e.count for e in kernels), peak_gib=peak / 2 ** 30,
             peak_above_weights_gib=(peak - base) / 2 ** 30)
    print(f"{label}: {len(batch)} windows, wall {m['wall_ms']:.2f} ms (median of 3, "
          f"mel included), device {m['device_ms']:.2f} ms in {m['kernels']} kernels, "
          f"peak memory {m['peak_gib']:.2f} GiB ({m['peak_above_weights_gib']:.2f} above "
          f"what was allocated before) ({card})")
    return m


def compare_encoder_routes(engine, audio, card: str) -> dict:
    """The main path's s8 x s8 encoder through this tree's route and the
    parent route (:func:`parent_encoder_route`) on the same engine: one
    window through each (finite, within ENCODER_REL of each other, the
    largest gap printed; the parent route's B5 and B9 launch counts); one
    window timed and profiled by :func:`encoder_ms` and MEL_WINDOWS windows
    by :func:`_encoder_windows`, each in turns (parent, this tree, this
    tree, parent).  Returns the readings and the parent route's
    ``gelu_quant`` launches per pass."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    counters = (ef.ln_quant, ef.ln_quant_acc, ef.gelu_quant, ef.gelu_quant_acc)
    with torch.inference_mode():
        new = engine.encode_windows(audio[None])
        for fn in counters:
            fn.launches = 0
        with parent_encoder_route():
            old = engine.encode_windows(audio[None])
        parent_counts = {fn.__name__: fn.launches for fn in counters}
    _expect("parent route, one window", parent_counts,
            {"ln_quant": N_LAYERS, "gelu_quant": N_LAYERS})
    check(bool(torch.isfinite(new).all()) and new.shape == old.shape,
          "s8 x s8 encoder: non-finite output or shapes differ between the routes")
    gap = _max_err(new, old)
    scale = old.float().abs().max().item()
    print(f"s8 x s8 encoder, this tree's route vs the parent route: largest gap "
          f"{gap:.3e}, max|parent| {scale:.3e}, bit for bit: {torch.equal(new, old)}; "
          f"parent route launches per pass {json.dumps(parent_counts)}")
    check(gap <= ENCODER_REL * scale, "the two encoder routes disagree")
    batch = np.stack([audio] * MEL_WINDOWS)
    res = dict(max_gap=gap, parent_gelu_quant_launches=parent_counts["gelu_quant"])
    for route in ("parent", "tree", "tree", "parent"):
        ctx = parent_encoder_route() if route == "parent" else contextlib.nullcontext()
        with ctx:
            label = f"s8 x s8 encoder, {'parent' if route == 'parent' else 'this tree'}'s route"
            one = encoder_ms(engine, audio, label, card)
            many = _encoder_windows(engine, batch, label, card)
        res.setdefault(route, []).append(dict(one_window=one, windows=many))
    print("s8 x s8 encoder routes: " + json.dumps({r: [dict(
        one_window={k: v["one_window"][k] for k in ("wall_ms", "device_ms", "kernels")},
        windows=v["windows"]) for v in res[r]] for r in ("parent", "tree")}) + f" ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 8: B18 and B19, the two kernels no engine path calls
# ---------------------------------------------------------------------------

MEL_ABS = 2e-4  # B18 vs its plain version: the Pallas kernel's contract
MEL_WINDOWS = 48  # bench.py's window count
N_MELS = 128  # large-v3
ATTN_SHAPE = (1, 1500, 20, 64)  # large-v3's encoder self-attention heads


def _mel_batch(clips):
    """MEL_WINDOWS rows of 45 s: the 45 s clip and the 20 s clip followed
    by silence, in turns, each rolled and scaled differently."""
    import torch
    import torch.nn.functional as F

    a20, a45 = clips["speech20"], clips["speech45"]
    rows = [torch.roll(a45 if i % 2 else F.pad(a20, (0, a45.numel() - a20.numel())),
                       7919 * i) * (0.5 + i / (2 * MEL_WINDOWS))
            for i in range(MEL_WINDOWS)]
    return torch.stack(rows).contiguous()


N_FFT, N_FREQS = 400, 201  # Whisper's frame and its one-sided spectrum


def _log_mel_frame_flop(n_fb: int) -> float:
    """Float operations one frame of the log-mel needs at the least: the
    window (N_FFT multiplies), a real FFT of N_FFT points (2.5 N log2 N, half
    of a complex FFT's 5 N log2 N), the power (3 per bin), the mel
    projection over the bank's ``n_fb`` nonzeros (2 each), and the floor
    and log10 of each mel (2 each)."""
    return (N_FFT + 2.5 * N_FFT * np.log2(N_FFT) + 3 * N_FREQS + 2 * n_fb
            + 2 * N_MELS)


def check_standalone_kernels(card: str) -> tuple:
    """B18 ``log_mel_spectrogram_fused`` and B19 ``encoder_self_attention``
    driven through their entry points as the JAX golden test drives the
    Pallas kernels (no engine path calls either, in either package): B18
    on the 20 s (padded) and 45 s (cut) clips at B = 1 and on
    MEL_WINDOWS windows, B19 at large-v3's encoder shape in bf16 and
    float32.  Counts set to 0 just before that run and read just after;
    each output held to its plain version on the same inputs; timed as in
    phase 4.  Returns ({name: measured}, {name: launches})."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_self_attention,
        encoder_self_attention_ref,
    )
    from ttasr_torch.ops.mel import log_mel_spectrogram, mel_filter_bank
    from ttasr_torch.ops.mel_fused import (
        log_mel_spectrogram_fused,
        log_mel_spectrogram_fused_ref,
    )

    t_phase = time.perf_counter()
    clips = {name: torch.from_numpy(synth_speech(np.random.default_rng(seed),
                                                 seconds)[0]).cuda()
             for name, seconds, seed in AUDIO}
    mel_in = {f"B=1 {name}": clip for name, clip in clips.items()}
    mel_in[f"B={MEL_WINDOWS}"] = _mel_batch(clips)
    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv32 = [torch.randn(ATTN_SHAPE, generator=gen, device="cuda") for _ in range(3)]
    attn_in = {"bf16": [x.to(torch.bfloat16) for x in qkv32], "f32": qkv32}

    counters = (log_mel_spectrogram_fused, encoder_self_attention)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    mel_out = {key: log_mel_spectrogram_fused(x, N_MELS) for key, x in mel_in.items()}
    attn_out = {key: encoder_self_attention(*x) for key, x in attn_in.items()}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    _expect("phase 8", launches, {"log_mel_spectrogram_fused": len(mel_in),
                                  "encoder_self_attention": len(attn_in)})
    print(f"phase 8 launches: {json.dumps(launches)}")

    worst_mel = 0.0
    for key, x in mel_in.items():
        got, want = mel_out[key], log_mel_spectrogram_fused_ref(x, N_MELS)
        err = _max_err(got, want)
        # the float32 frontend's own distance from the float64 plain
        # version, for comparison (the DFT cancels near the floor)
        f32_err = _max_err(log_mel_spectrogram(x, N_MELS), want)
        print(f"log_mel_spectrogram_fused {key} ({x.shape[-1] / SR:.0f} s): max_abs_err "
              f"{err:.3e} (bound {MEL_ABS:.0e}); ops/mel.py float32 {f32_err:.3e}")
        check(got.shape == want.shape == x.shape[:-1] + (N_MELS, 3000)
              and bool(torch.isfinite(got).all()), f"B18 {key}: shape "
              f"{tuple(got.shape)} or non-finite values")
        check(err <= MEL_ABS, f"B18 {key} disagrees with its plain version: "
                              f"{err} > {MEL_ABS}")
        worst_mel = max(worst_mel, err)
    worst_attn = 0.0
    for key, x in attn_in.items():
        got, want = attn_out[key], encoder_self_attention_ref(*x)
        err = _max_err(got, want)
        limit = BF16_REL * want.float().abs().max().item()
        print(f"encoder_self_attention {key} {ATTN_SHAPE}: max_abs_err {err:.3e} "
              f"(bound {limit:.3e})")
        check(err <= limit, f"B19 {key} disagrees with its plain version: "
                            f"{err} > {limit}")
        check(torch.equal(got, got.to(torch.bfloat16).to(got.dtype)),
              f"B19 {key}: output not rounded to bf16")
        worst_attn = max(worst_attn, err)

    times = {}
    for key, x in mel_in.items():
        times[key] = in_turns(lambda: log_mel_spectrogram_fused(x, N_MELS),
                              lambda: log_mel_spectrogram_fused_ref(x, N_MELS))
        print(f"log_mel_spectrogram_fused {key}: kernel {times[key][0]:.4f} ms, plain "
              f"{times[key][1]:.4f} ms ({card})")
    key = f"B={MEL_WINDOWS}"  # the numbers of the kernels line
    x = mel_in[key]
    n_fb = int(np.count_nonzero(mel_filter_bank(N_MELS)))
    flop = x.shape[0] * 3000 * _log_mel_frame_flop(n_fb)
    measured = {"log_mel_spectrogram_fused": dict(
        max_abs_err=worst_mel, ms=times[key][0], plain_ms=times[key][1],
        library_ms=time_ms(lambda: log_mel_spectrogram(x, N_MELS)),
        **bound([x[:, :480000], mel_out[key]], flop, "f32"))}
    m = measured["log_mel_spectrogram_fused"]
    dense = x.shape[0] * 3000 * (N_FFT * N_FREQS * 2 * 2 + N_FREQS * N_MELS * 2)
    print(f"log_mel_spectrogram_fused {key}: library (ops/mel.py, f32 cuBLAS "
          f"matmuls and unfold) {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
          f"({m['bound_by']}; {flop / 1e9:.2f} GFLOP by a real FFT and the "
          f"{n_fb} nonzeros of the mel bank, {flop / PEAK_OPS_PER_S['f32'] * 1e3:.4f} ms "
          f"at the f32 peak; the kernel's dense DFT and bank do "
          f"{dense / 1e9:.1f} GFLOP, {dense / PEAK_OPS_PER_S['f32'] * 1e3:.4f} ms) "
          f"({card})")

    b, t, h, dh = ATTN_SHAPE
    for key, x in attn_in.items():
        kernel_ms, plain_ms = in_turns(lambda: encoder_self_attention(*x),
                                       lambda: encoder_self_attention_ref(*x))
        print(f"encoder_self_attention {key}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})")
        if key == "bf16":
            merged = [y.view(b, t, h * dh) for y in x]
            measured["encoder_self_attention"] = dict(
                max_abs_err=worst_attn, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=_sdpa_ms(*merged, t, scale=dh ** -0.5),
                **bound(x + [attn_out[key]], 4.0 * b * h * t * t * dh, "bf16"))
    m = measured["encoder_self_attention"]
    print(f"encoder_self_attention bf16: scaled_dot_product_attention "
          f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({card})")
    _attention_rate("encoder_self_attention bf16", m, 4.0 * b * h * t * t * dh, card)
    print(f"phase 8 (B18, B19): {time.perf_counter() - t_phase:.1f} s")
    return measured, launches


# ---------------------------------------------------------------------------
# Phases 9, 10 and 13: the CLI paths end to end
# ---------------------------------------------------------------------------

SR = 16000
VAD_WINDOW = 512  # the VAD's frame, for synth_speech's labels


def _formant_filter(x, freq, bw, sr=SR):
    """2nd-order resonator (all-pole)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    return lfilter([1.0], [1.0, -2 * r * np.cos(theta), r * r], x)


def synth_speech(rng, seconds=3.0):
    """Speech-like signal + per-frame labels: a glottal pulse train through
    three formant resonators, syllabic modulation, pauses and fricative
    bursts (a copy of ``tools/train_vad.py::synth_speech``, which the
    smoke run's audio has come from since the port began)."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    # pitch contour 80-300 Hz with slow wander + jitter
    f0 = rng.uniform(90, 250)
    contour = f0 * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t))
    contour *= 1 + 0.02 * rng.standard_normal(n).cumsum() / np.sqrt(np.arange(1, n + 1))
    phase = 2 * np.pi * np.cumsum(contour) / SR
    # glottal-ish pulse train: rectified+sharpened harmonic sum
    voiced = np.maximum(np.sin(phase), 0.0) ** 3
    # formants (F1-F3 random per "speaker")
    sig = np.zeros(n)
    for lo, hi, bw in ((300, 900, 80), (900, 2200, 120), (2200, 3200, 200)):
        sig += _formant_filter(voiced, rng.uniform(lo, hi), bw) * rng.uniform(0.5, 1.0)
    sig /= np.max(np.abs(sig)) + 1e-9
    # syllabic envelope: 2-8 Hz with hard pauses
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 8.0) * t + rng.uniform(0, 6)))
    env = env ** rng.uniform(1.0, 2.0)
    # utterance gating: speech bursts with silence gaps
    gate = np.zeros(n)
    pos = 0
    while pos < n:
        burst = int(SR * rng.uniform(0.4, 1.5))
        gap = int(SR * rng.uniform(0.2, 1.0))
        gate[pos : pos + burst] = 1.0
        pos += burst + gap
    # fricative bursts (unvoiced): high-passed noise in short spans
    fric = rng.standard_normal(n) * 0.15
    fric = np.diff(fric, prepend=0.0)  # crude high-pass
    fric_gate = (rng.random(n // (SR // 10) + 1) < 0.2).repeat(SR // 10)[:n]
    out = (sig * env + fric * fric_gate * env) * gate
    out = out / (np.max(np.abs(out)) + 1e-9) * rng.uniform(0.2, 0.9)
    # frame labels: envelope*gate active
    act = (env * gate)
    frames = act[: (n // VAD_WINDOW) * VAD_WINDOW].reshape(-1, VAD_WINDOW).mean(axis=1)
    labels = (frames > 0.25).astype(np.float32)
    return out.astype(np.float32), labels


AUDIO = (("speech20", 20.0, 0), ("speech45", 45.0, 1))


def _write_wavs(audio_dir: str, n_files: int):
    from ttasr_torch.audio.io import write_wav

    total, first = 0.0, None
    for name, seconds, seed in AUDIO[:n_files]:
        audio, _ = synth_speech(np.random.default_rng(seed), seconds)
        write_wav(os.path.join(audio_dir, f"{name}.wav"), audio, SR)
        total += seconds
        first = audio if first is None else first
    return total, first


def _drive_cli(engine, label: str, card: str, counters, n_files: int = 2) -> dict:
    """process_audio_folder over the first ``n_files`` WAVs with
    ``engine``; counts are set to 0 just before and read just after.
    Returns the counts, the decode stats, the first audio and timing."""
    import torch

    from ttasr_torch.cli.asr import process_audio_folder

    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        audio_seconds, first = _write_wavs(audio_dir, n_files)
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = process_audio_folder(audio_dir, model="large-v3", engine=engine,
                                      results_json_dir=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counters}

    check(result is not None, f"{label}: process_audio_folder returned None")
    entries = result["detailed_results"]
    check(len(entries) == n_files,
          f"{label}: expected {n_files} results, got {len(entries)}")
    for entry in entries:
        check("error" not in entry, f"{label} {entry['audio_file']}: {entry.get('error')}")
    stats = dict(engine.decode_stats)
    print(f"{label} decode stats: {json.dumps(stats)}")
    check(stats["beam_decodes"] > 0 and stats["beam_steps"] > 0,
          f"{label}: no beam decode step ran")
    check(stats["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {n_files} files, {audio_seconds:.1f} s of audio, wall {wall:.2f} s = "
          f"{wall / audio_seconds:.4f} s per audio second, peak memory "
          f"{peak_gib:.2f} GiB ({card})")
    print(f"{label} launches: {json.dumps(counts)}")
    for entry in entries:
        print(f"  {entry['audio_file']}: {len(entry['asr_result'] or '')} chars")
    return dict(counts=counts, stats=stats, first=first, wall=wall,
                audio_seconds=audio_seconds, peak_gib=peak_gib)


def encoder_ms(engine, audio, label: str, card: str) -> dict:
    """One 30 s window through ``engine``'s encoder (mel included): the
    wall milliseconds, median of 5 calls after a warm-up, each ended by a
    synchronise; then one call under ``torch.profiler``: the device time,
    the kernels it ran and the longest of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.encode_windows(audio[None])
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.encode_windows(audio[None])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    device_ms = sum(dev_us.values()) / 1e3
    n_kernels = sum(e.count for e in kernels)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: encoder {wall:.2f} ms per 30 s window (mel included; median "
          f"of 5); profiled call: {device_ms:.2f} ms of device time in {n_kernels} "
          f"kernels, busy {device_ms / wall:.0%} ({card})")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    return dict(wall_ms=wall, device_ms=device_ms, kernels=n_kernels,
                top=[(name[:100], us / 1e3) for name, us in top])


def _encoder_agrees(engine, audio, label: str, plain=None) -> None:
    """One window through the engine's encoder with the kernels and with
    the plain versions (``plain``: a context that swaps them in, or None
    for the bf16 path's plain attention): finite, of the expected shape,
    and within ENCODER_REL."""
    import torch

    from ttasr_torch.models.whisper.model import encode
    from ttasr_torch.ops.mel import log_mel_spectrogram

    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=engine.cfg.num_mel_bins,
                                  device=engine.device)[None]
        kw = dict(act_int8=engine._act8, fused_quant=engine._fused_quant)
        kernel_out = encode(engine.params, engine.cfg, mel, **kw)
        if plain is None:
            plain_out = encode(engine.params, engine.cfg, mel, fused_attention=False)
        else:
            with plain():
                plain_out = encode(engine.params, engine.cfg, mel, **kw)
    check(tuple(kernel_out.shape) == (1, 1500, 1280),
          f"{label}: encoder output shape {tuple(kernel_out.shape)}")
    check(bool(torch.isfinite(kernel_out).all()), f"{label}: non-finite encoder output")
    err = _max_err(kernel_out, plain_out)
    scale = plain_out.float().abs().max().item()
    print(f"{label}: encoder large-v3, kernels vs plain versions: max_abs_err "
          f"{err:.3e}, max|plain| {scale:.3e}")
    check(err <= ENCODER_REL * scale, f"{label}: encoder disagrees with its plain versions")


def run_bf16_path(card: str) -> dict:
    """The batch CLI at large-v3, bf16, beam 5; returns B11's launches and
    the encoder's ms per window."""
    import torch

    from ttasr_torch.cli.asr import build_engine
    from ttasr_torch.ops.encoder_attention import encoder_attention_merged

    t0 = time.perf_counter()
    engine = build_engine("large-v3", device="cuda")
    torch.cuda.synchronize()
    print(f"engine: large-v3 bf16 random init on {engine.device} in "
          f"{time.perf_counter() - t0:.1f} s")
    run = _drive_cli(engine, "bf16 path", card, [encoder_attention_merged])
    launches = run["counts"]["encoder_attention_merged"]
    check(launches > 0 and launches == N_LAYERS * run["stats"]["encoder_passes"],
          f"encoder attention launched {launches} times for "
          f"{run['stats']['encoder_passes']} encoder passes")
    _encoder_agrees(engine, run["first"], "bf16 path")
    ms = encoder_ms(engine, run["first"], "bf16 path", card)
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, encoder_ms=ms)


def _int8_counters():
    from ttasr_torch.models.whisper import model
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import quant
    from ttasr_torch.ops import self_attention as sa

    from ttasr_torch.ops import beam_gather as bg
    from ttasr_torch.ops import cross_attention as ca

    return [blk.qkv_int8_fused, sa.self_attn_step_indirect_int8,
            blk.attnout_ln_q_cross_int8, mlp.mlp_with_crossout_int8,
            sa.self_attn_step_int8, model.encoder_attention_merged,
            model.encoder_attention_merged_qkv, ef.ln_quant, ef.ln_quant_acc,
            ef.quant_only, ef.add_ln_quant, ef.gelu_quant, ef.gelu_quant_acc,
            quant.quant_matmul_act8,
            blk.attnout_ln_q_fused, ca.cross_attention_int8,
            bg.gather_cache_rows, blk.matmul_int8_partial,
            blk.ln_q_cross_int8, mlp.mlp_int8_fused]


def run_int8_path(card: str, act8: bool) -> dict:
    """The batch CLI on the int8 engine: with all its defaults (``act8``,
    the main path: the s8 x s8 encoder, both files; then the decode's
    other branches on the same engine, :func:`run_branch_paths`) or with
    ``encoder_act_int8=False`` (the bf16 encoder on int8 weights, one
    file).  Returns each kernel's launches in that run, the encoder's ms
    per window and, for the main path, the branch paths' results."""
    import torch

    from ttasr_torch.engine.transcriber import WhisperEngine

    label = "int8 main path" if act8 else "int8 path, encoder_act_int8=False"
    t0 = time.perf_counter()
    kw = {} if act8 else dict(encoder_act_int8=False)
    engine = WhisperEngine("large-v3", compute_type="int8", device="cuda", **kw)
    torch.cuda.synchronize()
    print(f"engine: large-v3 int8 (quantized on the card) {kw or 'defaults'}, "
          f"random init in {time.perf_counter() - t0:.1f} s")
    run = _drive_cli(engine, label, card, _int8_counters(), n_files=2 if act8 else 1)
    c, st = run["counts"], run["stats"]
    steps = st["beam_steps"] + st["greedy_steps"]
    passes = st["encoder_passes"]
    check(passes > 0 and steps > 0, f"{label}: no encoder pass or step")
    want = {"qkv_int8_fused": N_LAYERS * steps,
            "attnout_ln_q_cross_int8": N_LAYERS * steps,
            "mlp_with_crossout_int8": N_LAYERS * steps,
            "self_attn_step_indirect_int8": N_LAYERS * st["beam_steps"],
            "self_attn_step_int8": N_LAYERS * st["greedy_steps"]}
    if act8:
        want.update(_act8_encoder_launches(passes),
                    encoder_attention_merged_qkv=N_LAYERS * passes)
    else:
        want["encoder_attention_merged"] = N_LAYERS * passes
    _expect(label, c, want)
    print(f"{label}: launch counts match the decode stats "
          f"({st['beam_steps']} beam + {st['greedy_steps']} greedy steps, "
          f"{st['encoder_passes']} encoder passes, x {N_LAYERS} layers)")
    if act8:
        _encoder_agrees(engine, run["first"], label, plain=plain_encoder_kernels)
    ms = encoder_ms(engine, run["first"], label, card)
    branches = tp = routes = None
    if act8:
        routes = compare_encoder_routes(engine, run["first"], card)
        branches, main_leg = run_branch_paths(engine, run["first"], card)
        tp = run_tp_paths(engine, run["first"], main_leg, card)
    del engine
    torch.cuda.empty_cache()
    return dict(counts=c, encoder_ms=ms, branches=branches, tp=tp, routes=routes)


# ---------------------------------------------------------------------------
# Phase 11: the decode's other branches on the main path's engine
# ---------------------------------------------------------------------------

BRANCH_STEPS = 96  # tokens per branch decode: three growth buckets
STEP_LOGIT_REL = 1.4e-2  # ROADMAP C: step logits within 1.4 % relative


def _unfused_decoder(params):
    """The decoder's fused q/k/v leaves split back into wq/wk/wv and bq/bv:
    the weights ``quantize_params`` gives without ``fuse_qkv`` (the scales
    are per output column, so the split is exact)."""
    dec = params["decoder"]
    blocks = []
    for blk in dec["blocks"]:
        out = {k: v for k, v in blk.items() if k not in ("wqkv", "bqkv")}
        d = blk["wqkv"]["q"].shape[0]
        for j, name in enumerate(("wq", "wk", "wv")):
            cols = slice(j * d, (j + 1) * d)
            out[name] = {"q": blk["wqkv"]["q"][:, cols].contiguous(),
                         "s": blk["wqkv"]["s"][..., cols].contiguous()}
        out["bq"], out["bv"] = blk["bqkv"][:d].contiguous(), blk["bqkv"][2 * d:].contiguous()
        blocks.append(out)
    return dict(params, decoder=dict(dec, blocks=blocks))


PROFILE_STEPS = 16  # tokens of the profiled decodes of PROFILED_LEGS
# the legs decoded once more under torch.profiler: the main path's step
# (B1 -> B2 -> B3 -> B4) and the slice's heaviest, with B13 in it
MAIN_LEG = "main path beam 5 (B3, ancestry map)"
PROFILED_LEGS = (MAIN_LEG, "unfused int8 graph beam 5 (B13, 5-D cache)")


def _profile_decode(run) -> dict:
    """One decode ``run()`` (prefill included) under ``torch.profiler``:
    device ms and kernels per step, the busy share of its wall, and the
    four kernels with the most device time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = run()["steps"]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    device_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    return dict(device_ms_per_step=device_ms / steps,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                busy=device_ms / wall_ms,
                top=[(name[:90], us / 1e3 / steps) for name, us in top])


def _expect(label, counts, want):
    """Every counter equals ``want`` (0 where not named), each named > 0."""
    for name, n in counts.items():
        w = want.get(name, 0)
        check(n == w and (w > 0 or name not in want),
              f"{label}: {name} launched {n} times, expected {w}")


@contextlib.contextmanager
def _step_logits():
    """Collects the logits of every decode step (``decode._step``'s
    output, kept by reference: nothing more runs on the card)."""
    from ttasr_torch.models.whisper import decode as dm

    step, seen = dm._step, []

    def recorded(*args, **kwargs):
        logits, cache = step(*args, **kwargs)
        seen.append(logits)
        return logits, cache

    dm._step = recorded
    try:
        yield seen
    finally:
        dm._step = step


@contextlib.contextmanager
def _unfused_rules_env():
    """TTASR_UNFUSED_RULES=1 for the decodes inside, with
    ``decode._apply_rules`` counted and its log-probabilities checked
    finite; the variable is unset afterwards.  The flag stays on the card
    (``seen["finite"]``, a bool tensor, read once after the leg), so the
    spy adds a few small kernels per step and no host sync."""
    import torch

    from ttasr_torch.models.whisper import decode as dm

    apply_rules, seen = dm._apply_rules, {"calls": 0, "finite": None}

    def counted(*args, **kwargs):
        out = apply_rules(*args, **kwargs)
        seen["calls"] += 1
        finite = torch.isfinite(torch.log_softmax(out, dim=-1)).all()
        seen["finite"] = finite if seen["finite"] is None else seen["finite"] & finite
        return out

    check("TTASR_UNFUSED_RULES" not in os.environ, "TTASR_UNFUSED_RULES already set")
    dm._apply_rules = counted
    os.environ["TTASR_UNFUSED_RULES"] = "1"
    try:
        yield seen
    finally:
        del os.environ["TTASR_UNFUSED_RULES"]
        dm._apply_rules = apply_rules


def _logit_gaps(a, b):
    """Per step of two decodes: (max |a - b| / max |a|, every row's argmax
    equal)."""
    return [(float((x - y).abs().max() / x.abs().max()),
             bool((x.argmax(-1) == y.argmax(-1)).all())) for x, y in zip(a, b)]


def _first_difference(a, b):
    """(row, step) of the first differing token of two decodes, or None."""
    for row in range(a["tokens"].shape[0]):
        n_a, n_b = int(a["lengths"][row]), int(b["lengths"][row])
        ta, tb = a["tokens"][row].tolist(), b["tokens"][row].tolist()
        for step in range(max(n_a, n_b)):
            if step >= min(n_a, n_b) or ta[step] != tb[step]:
                return row, step
    return None


def _hold_to_main(label, out, logits, main) -> float:
    """``out``'s tokens equal to the main-path leg's, and its step
    ``logits`` within STEP_LOGIT_REL of that leg's with every argmax
    equal; returns the worst relative gap."""
    gaps = _logit_gaps(main["logits"], logits)
    diff = _first_difference(main["out"], out)
    if diff is not None:
        row, step = diff
        gap = "the prefill's" if step == 0 else f"{gaps[step - 1][0]:.3e}"
        check(False, f"{label}: tokens differ from the main path leg's at row "
              f"{row} step {step}; relative logit gap of the step that chose "
              f"it {gap}")
    worst = max(g for g, _ in gaps)
    s = out["steps"]
    print(f"{label}: tokens equal to the main path leg's ({s} steps); step "
          f"logits within {worst:.3e} relative, argmax equal on "
          f"{sum(a for _, a in gaps)} of {len(gaps)} steps")
    check(len(gaps) == s and worst <= STEP_LOGIT_REL and all(a for _, a in gaps),
          f"{label}: step logits not within {STEP_LOGIT_REL} of the main path "
          f"leg's with every argmax equal")
    return worst


def run_branch_paths(engine, audio, card: str):
    """Each branch decode on one encoder window of ``audio``, its counts set
    to 0 just before and read just after; returns ({leg: {steps,
    ms_per_step, counts}}, the main-path leg: {out, logits, enc, prompt,
    pad}) for the tensor-parallel legs to be held to."""
    import torch

    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        build_prompt,
        greedy_decode,
        pad_prompts,
    )

    counters = _int8_counters()
    enc = engine.encode_windows(audio[None])
    prompt, pad = pad_prompts([build_prompt(engine.tokenizer, language="zh")],
                              engine.ti.eot)
    base = dict(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
    unfused = _unfused_decoder(engine.params)
    legs = {}

    def decode(fn, params, rows, kw):
        with torch.inference_mode():
            return fn(params, engine.cfg, enc.expand(rows, -1, -1),
                      np.repeat(prompt, rows, 0), np.repeat(pad, rows, 0),
                      opts=DecodingOptions(**dict(base, **kw)), ti=engine.ti)

    def leg(label, fn, params, rows=1, **kw):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(fn, params, rows, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        steps = out["steps"]
        check(steps > 0 and out["logits_finite"], f"{label}: {steps} steps, "
              f"finite logits {out['logits_finite']}")
        legs[label] = dict(steps=steps, ms_per_step=1e3 * wall / steps, counts=counts)
        print(f"{label}: {steps} steps, {1e3 * wall / steps:.2f} ms per step "
              f"(decode wall {wall:.2f} s, prefill included) ({card})")
        print(f"{label} launches: {json.dumps({k: v for k, v in counts.items() if v})}")
        if label in PROFILED_LEGS:
            prof = _profile_decode(lambda: decode(fn, params, rows, dict(
                kw, sample_len=PROFILE_STEPS)))
            legs[label]["profile"] = prof
            print(f"{label}: profiled {PROFILE_STEPS}-step decode: "
                  f"{prof['device_ms_per_step']:.3f} ms of device time and "
                  f"{prof['kernels_per_step']:.0f} kernels per step, busy "
                  f"{prof['busy']:.0%} ({card})")
            for name, ms in prof["top"]:
                print(f"    {ms:8.3f} ms per step  {name}")
        return out, steps

    L = N_LAYERS
    with _step_logits() as main_logits:
        main, s = leg(MAIN_LEG, beam_decode, engine.params)
    _expect("main path leg", legs[MAIN_LEG]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s})

    # the main path with the two-stage rules (ROADMAP C1): same kernels
    label = "TTASR_UNFUSED_RULES=1 beam 5 (two-stage rules)"
    with _unfused_rules_env() as rules:
        unfused_rules, s = leg(label, beam_decode, engine.params)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s})
    finite = rules["finite"] is not None and bool(rules["finite"])
    check(rules["calls"] == s and finite,
          f"{label}: _apply_rules ran {rules['calls']} times in {s} steps, "
          f"log-probabilities finite {finite}")
    diff = _first_difference(main, unfused_rules)
    print(f"{label}: _apply_rules ran once per step ({s} steps), log-probabilities "
          f"finite; tokens " + ("equal to the main path leg's" if diff is None else
                               f"differ from the main path leg's first at row "
                               f"{diff[0]} step {diff[1]}"))

    label = "beam_indirect=False (B17, B10)"
    with _step_logits() as copied_logits:
        copied, s = leg(label, beam_decode, engine.params, beam_indirect=False)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s,
        "gather_cache_rows": s})
    # B17 copies bytes and B10 sums the rows B2 reads through the map in the
    # same order: the legs do the same arithmetic, so no near-tie may flip
    main_leg = dict(out=main, logits=main_logits, enc=enc, prompt=prompt, pad=pad)
    _hold_to_main(label, copied, copied_logits, main_leg)

    label = "bf16 cross-KV (B12)"
    _, s = leg(label, beam_decode, engine.params, cross_kv_int8=False,
               cross_kv_int4=False)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_fused": L * s, "mlp_with_crossout_int8": L * s})

    for label, fn, rows in (("unfused int8 graph beam 5 (B13, 5-D cache)", beam_decode, 1),
                            ("unfused int8 graph greedy 5 rows (B13, 5-D cache)",
                             greedy_decode, 5)):
        _, s = leg(label, fn, unfused, rows=rows, beam_size=5 if rows == 1 else 1)
        _expect(label, legs[label]["counts"], {"cross_attention_int8": L * s})

    label = "engine transcribe beam_size=10 (B12, XLA cross)"
    for c in counters:
        c.launches = 0
    before = dict(engine.decode_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments, _ = engine.transcribe(audio, beam_size=10, temperature=(0.0,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    st = {k: engine.decode_stats[k] - before[k] for k in before}
    s, passes = st["beam_steps"], st["encoder_passes"]
    check(st["nonfinite_logits"] == 0 and s > 0 and st["greedy_steps"] == 0,
          f"{label}: decode stats {st}")
    _expect(label, counts, dict(
        _act8_encoder_launches(passes), qkv_int8_fused=L * s,
        self_attn_step_indirect_int8=L * s, attnout_ln_q_fused=L * s,
        mlp_with_crossout_int8=L * s, encoder_attention_merged_qkv=L * passes))
    legs[label] = dict(steps=s, ms_per_step=1e3 * wall / s, counts=counts)
    print(f"{label}: {len(segments)} segments, {s} beam steps, {passes} encoder "
          f"passes, wall {wall:.2f} s = {1e3 * wall / s:.2f} ms per beam step "
          f"(encoder included) ({card})")
    print(f"{label} launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    print("branch paths, ms per step: " + json.dumps(
        {k: round(v["ms_per_step"], 3) for k, v in legs.items()}) + f" ({card})")
    print("branch paths, profiled device ms per step: " + json.dumps(
        {k: round(v["profile"]["device_ms_per_step"], 3) for k, v in legs.items()
         if "profile" in v}) + f" ({card})")
    return legs, main_leg


# ---------------------------------------------------------------------------
# Phase 12: the tensor-parallel decode
# ---------------------------------------------------------------------------

TP_RANKS = 2  # the two-rank leg: large-v3's 20 heads split into 2 x 10
# The two-rank legs change the f32 summation order (the partial sums of v2;
# cuBLAS's shape-dependent order in a shard's N = 640 projections), and on
# random weights 32 layers grow such last-bit changes into step-logit gaps
# far above STEP_LOGIT_REL: a one-card decode whose only change is the
# order (CONTROLS) moves as far.  So those legs are held to the controls'
# gaps, measured in the same run, times this margin for the spread of a
# maximum over 96 steps; the legs whose arithmetic is the main leg's are
# held to STEP_LOGIT_REL and equal tokens.
CONTROL_MARGIN = 1.5


def _tp_launches(s: int, beam: bool, row_parallel: bool) -> dict:
    """Exact launch counts of ``s`` TP decode steps over N_LAYERS layers."""
    L = N_LAYERS
    want = {"qkv_int8_fused": L * s,
            "self_attn_step_indirect_int8" if beam else "self_attn_step_int8": L * s}
    if row_parallel:
        want.update(matmul_int8_partial=2 * L * s, ln_q_cross_int8=L * s,
                    mlp_int8_fused=L * s)
    else:
        want.update(attnout_ln_q_cross_int8=L * s, mlp_with_crossout_int8=L * s)
    return want


def _decode_leg(label, run, counters, card):
    """``run()`` with the counts set to 0 just before and read just after,
    under ``_step_logits``; returns (output, step logits, {steps,
    ms_per_step, counts})."""
    import torch

    for c in counters:
        c.launches = 0
    with _step_logits() as logits, torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    steps = out["steps"]
    check(steps > 0 and out["logits_finite"], f"{label}: {steps} steps, finite "
          f"logits {out['logits_finite']}")
    print(f"{label}: {steps} steps, {1e3 * wall / steps:.2f} ms per step (decode "
          f"wall {wall:.2f} s, prefill included) ({card})")
    return out, logits, dict(steps=steps, ms_per_step=1e3 * wall / steps, counts=counts)


def _gap_summary(main_logits, logits) -> dict:
    """Worst and median relative step-logit gap, steps with every argmax
    equal."""
    gaps = _logit_gaps(main_logits, logits)
    g = [x for x, _ in gaps]
    return dict(worst_gap=max(g), median_gap=float(np.median(g)),
                argmax_equal_steps=sum(a for _, a in gaps), compared_steps=len(g))


@contextlib.contextmanager
def _plain_b4():
    """The decode's B4 through its plain version: the same function, its
    f32 sums in another order."""
    from ttasr_torch.models.whisper import decode as dm
    from ttasr_torch.ops import decoder_mlp as mlp

    real = dm.mlp_with_crossout_int8
    dm.mlp_with_crossout_int8 = mlp.mlp_with_crossout_int8_ref
    try:
        yield
    finally:
        dm.mlp_with_crossout_int8 = real


@contextlib.contextmanager
def _cross_kv_in_halves():
    """``init_cache`` projects each layer's cross-KV as a 2-way model axis
    does, one projection per half of the heads, and concatenates the
    halves: one card, a 2-way shard's projection shapes."""
    import torch

    from ttasr_torch.models.whisper import model
    from ttasr_torch.parallel.tp import _split_cols

    real = model._quantized_cross_kv

    def halves(enc_out, blk, h, int4):
        parts = [real(enc_out, {k: _split_cols(blk[k], 2, i) for k in ("wk_c", "wv_c", "bv_c")},
                      h // 2, int4) for i in range(2)]
        # codes (B, S, D) join on D, scales (B, H, S) on H
        return [torch.cat(pair, dim=-1 if j % 2 == 0 else 1)
                for j, pair in enumerate(zip(*parts))]

    model._quantized_cross_kv = halves
    try:
        yield
    finally:
        model._quantized_cross_kv = real


CONTROLS = (("control: B4 through its plain version", _plain_b4),
            ("control: cross-KV projected in head halves", _cross_kv_in_halves))


def _segments_well_formed(label, segments) -> None:
    for seg in segments:
        check(isinstance(seg.text, str) and seg.tokens and seg.start <= seg.end
              and np.isfinite(seg.avg_logprob) and 0.0 <= seg.no_speech_prob <= 1.0,
              f"{label}: malformed segment {seg}")


def run_tp_paths(engine, audio, main, card: str) -> dict:
    """The tensor-parallel decode on the main path's window: TP v2 forced on
    a one-rank NCCL group (beam 5 held to the main-path leg, greedy over 5
    rows held to the single-card fused greedy decode), the engine with a
    (1, 1) mesh (TP v1) on the 20 s file and on its own encoder window, the
    one-card CONTROLS, and two gloo ranks on this card
    (:func:`run_two_ranks`).  Returns {leg: {steps, ms_per_step, counts}}."""
    import torch
    import torch.distributed as dist

    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        greedy_decode,
    )
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh
    from ttasr_torch.parallel.tp import TPDecoder

    counters = _int8_counters()
    base = dict(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
    enc, prompt, pad, ti = main["enc"], main["prompt"], main["pad"], engine.ti
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = create_mesh(1, 1)
            tp = TPDecoder(_unfused_decoder(engine.params), engine.cfg, mesh,
                           row_parallel=True)
            label = "TP v2 one rank beam 5 (B15, B16, B14)"
            out, logits, legs[label] = _decode_leg(label, lambda: tp.beam(
                enc, prompt, pad, opts=DecodingOptions(**base), ti=ti), counters, card)
            _expect(label, legs[label]["counts"],
                    _tp_launches(out["steps"], beam=True, row_parallel=True))
            _hold_to_main(label, out, logits, main)

            rows = 5
            g_args = (enc.expand(rows, -1, -1), np.repeat(prompt, rows, 0),
                      np.repeat(pad, rows, 0), None, 0.0)
            g_opts = DecodingOptions(**dict(base, beam_size=1))
            label = "TP v2 one rank greedy 5 rows"
            out, logits, legs[label] = _decode_leg(label, lambda: tp.greedy(
                *g_args, opts=g_opts, ti=ti), counters, card)
            _expect(label, legs[label]["counts"],
                    _tp_launches(out["steps"], beam=False, row_parallel=True))
            single, single_logits, _ = _decode_leg(
                "single-card fused greedy 5 rows", lambda: greedy_decode(
                    engine.params, engine.cfg, *g_args, opts=g_opts, ti=ti),
                counters, card)
            _hold_to_main(label, out, logits, dict(out=single, logits=single_logits))
            del tp

            legs.update(run_mesh_engine(mesh, audio, base, counters, card))
        finally:
            dist.destroy_process_group()
    controls = {}
    for label, ctx in CONTROLS:
        with ctx():
            out, logits, legs[label] = _decode_leg(label, lambda: beam_decode(
                engine.params, engine.cfg, enc, prompt, pad,
                opts=DecodingOptions(**base), ti=ti), counters, card)
        controls[label] = dict(_gap_summary(main["logits"], logits),
                               first_difference=_first_difference(main["out"], out))
        print(f"{label}: {json.dumps(controls[label])}")
    legs.update(run_two_ranks(main, ti, controls, card))
    print("tensor-parallel legs, ms per step: " + json.dumps(
        {k: round(v["ms_per_step"], 3) for k, v in legs.items()}) + f" ({card})")
    return legs


def run_mesh_engine(mesh, audio, base, counters, card) -> dict:
    """``WhisperEngine(..., mesh=mesh)`` at (1, 1): TP v1 by the reference's
    rule, the unfused s8 x s8 encoder (B11).  ``transcribe`` of the 20 s
    file at T = 0 with exact counts, then the engine's own first window
    decoded by the engine and by the single-card fused ``beam_decode`` of
    its weights: equal tokens, step logits within STEP_LOGIT_REL."""
    import torch

    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        build_prompt,
        pad_prompts,
    )
    from ttasr_torch.ops.quant import fuse_qkv

    L = N_LAYERS
    t0 = time.perf_counter()
    engine = WhisperEngine("large-v3", compute_type="int8", device="cuda", mesh=mesh)
    check(engine._tp is not None and not engine._tp.row_parallel,
          "the (1, 1) mesh engine must take TP v1")
    print(f"engine: large-v3 int8 with a (1, 1) mesh in {time.perf_counter() - t0:.1f} s")
    label = "mesh engine transcribe T=0 (TP v1, unfused encoder)"
    for c in counters:
        c.launches = 0
    before = dict(engine.decode_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments, _ = engine.transcribe(audio, temperature=(0.0,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    st = {k: engine.decode_stats[k] - before[k] for k in before}
    s, passes = st["beam_steps"], st["encoder_passes"]
    check(st["nonfinite_logits"] == 0 and s > 0 and st["greedy_steps"] == 0,
          f"{label}: decode stats {st}")
    _segments_well_formed(label, segments)
    _expect(label, counts, dict(
        _tp_launches(s, beam=True, row_parallel=False),
        **_act8_encoder_launches(passes, gemms=6), encoder_attention_merged=L * passes))
    legs = {label: dict(steps=s, ms_per_step=1e3 * wall / s, counts=counts)}
    print(f"{label}: {len(segments)} segments, {s} beam steps, {passes} encoder "
          f"passes, wall {wall:.2f} s = {1e3 * wall / s:.2f} ms per beam step "
          f"(encoder included) ({card})")

    enc = engine.encode_windows(audio[None])
    prompt, pad = pad_prompts([build_prompt(engine.tokenizer, language="zh")],
                              engine.ti.eot)
    opts = DecodingOptions(**base)
    label = "mesh engine beam 5 on its window (TP v1)"
    out, logits, legs[label] = _decode_leg(label, lambda: engine.run_beam_decode(
        enc, prompt, pad, None, opts), counters, card)
    _expect(label, legs[label]["counts"],
            _tp_launches(out["steps"], beam=True, row_parallel=False))
    fused = fuse_qkv({"decoder": engine.params["decoder"]})
    single, single_logits, _ = _decode_leg(
        "single-card fused beam 5 on the mesh engine's window", lambda: beam_decode(
            fused, engine.cfg, enc, prompt, pad, opts=opts, ti=engine.ti),
        counters, card)
    _hold_to_main(label, out, logits, dict(out=single, logits=single_logits))
    del engine, fused
    torch.cuda.empty_cache()
    return legs


def run_two_ranks(main, ti, controls, card: str) -> dict:
    """Two gloo ranks on this card, mesh (1, 2), the seeded large-v3
    weights: TP v2 and v1 beam 5 over the main-path leg's window, each
    rank a process of this script (``--tp-rank``).  Both ranks' counts
    must be exact at the shard shapes, and rank 0's worst and median step
    gap to the main-path leg within CONTROL_MARGIN x the largest of the
    ``controls``' (one-card decodes that only reorder sums)."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(enc=main["enc"], prompt=main["prompt"], pad=main["pad"], ti=ti,
                        logits=torch.stack(main["logits"]),
                        out={k: main["out"][k] for k in ("tokens", "lengths", "steps")}),
                   os.path.join(tmp, "main.pt"))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--tp-rank", str(r), tmp]) for r in range(TP_RANKS)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        check(codes == [0] * TP_RANKS, f"two-rank leg: rank exit codes {codes}")
        legs = {}
        for r in range(TP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json"), encoding="utf-8") as fh:
                for label, leg in json.load(fh).items():
                    _expect(f"{label} rank {r}", leg["counts"], _tp_launches(
                        leg["steps"], beam=True, row_parallel=leg["row_parallel"]))
                    if r == 0:
                        legs[label] = leg
    limit = {k: CONTROL_MARGIN * max(c[k] for c in controls.values())
             for k in ("worst_gap", "median_gap")}
    for label, leg in legs.items():
        print(f"{label}: {leg['steps']} steps, {leg['ms_per_step']:.2f} ms per step; "
              f"to the main path leg: first token difference (row, step) "
              f"{leg['first_difference']}, step logits worst {leg['worst_gap']:.3e} "
              f"(limit {limit['worst_gap']:.3e}), median {leg['median_gap']:.3e} "
              f"(limit {limit['median_gap']:.3e}), argmax equal on "
              f"{leg['argmax_equal_steps']} of {leg['compared_steps']} steps ({card})")
        check(leg["compared_steps"] == leg["steps"]
              and all(leg[k] <= limit[k] for k in limit),
              f"{label}: further from the main path leg than the one-card controls")
    return legs


def tp_rank_main(rank: int, tmp: str) -> int:
    """One rank of :func:`run_two_ranks`: builds the seeded large-v3 decoder
    (the main engine's weights), keeps its shard, decodes v2 then v1 beam
    5 and writes its legs to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ttasr_torch import resolve_device
    from ttasr_torch.models.whisper.decode import DecodingOptions
    from ttasr_torch.models.whisper.load import load_whisper
    from ttasr_torch.ops.quant import quantize_params
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh
    from ttasr_torch.parallel.tp import TPDecoder

    resolve_device("cuda")
    initialize_distributed(f"file://{tmp}/store", world_size=TP_RANKS, rank=rank,
                           backend="gloo")
    try:
        mesh = create_mesh(1, TP_RANKS)
        params, cfg = load_whisper("large-v3", dtype=torch.bfloat16, device="cuda")
        q = quantize_params({"decoder": params["decoder"]})
        del params
        ref = torch.load(os.path.join(tmp, "main.pt"), map_location="cuda",
                         weights_only=False)
        main = dict(out=ref["out"], logits=list(ref["logits"]))
        opts = DecodingOptions(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                               cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
        counters = _int8_counters()
        legs = {}
        for label, rp in ((f"TP v2 {TP_RANKS} gloo ranks, one card, beam 5", True),
                          (f"TP v1 {TP_RANKS} gloo ranks, one card, beam 5", False)):
            tp = TPDecoder(q, cfg, mesh, row_parallel=rp)
            out, logits, leg = _decode_leg(label, lambda: tp.beam(
                ref["enc"], ref["prompt"], ref["pad"], opts=opts, ti=ref["ti"]),
                counters, f"rank {rank}")
            legs[label] = dict(leg, row_parallel=rp,
                               first_difference=_first_difference(main["out"], out),
                               **_gap_summary(main["logits"], logits))
            del tp
        with open(os.path.join(tmp, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(legs, fh)
    finally:
        dist.destroy_process_group()
    return 0


KERNELS = [  # wrapper name, source, the TPU kernel it replaces
    ("encoder_attention_merged", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:156"),
    ("qkv_int8_fused", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:50"),
    ("self_attn_step_indirect_int8", "ttasr_torch/csrc/self_attention.cu",
     "ttasr/ops/self_attention_pallas.py:290"),
    ("attnout_ln_q_cross_int8", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:180"),
    ("mlp_with_crossout_int8", "ttasr_torch/csrc/decoder_mlp.cu",
     "ttasr/ops/decoder_mlp_pallas.py:153"),
    ("self_attn_step_int8", "ttasr_torch/csrc/self_attention.cu",
     "ttasr/ops/self_attention_pallas.py:47"),
    ("ln_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:113"),
    ("encoder_attention_merged_qkv", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:90"),
    ("quant_only", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:204"),
    ("add_ln_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:141"),
    ("gelu_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
    ("gelu_quant_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
    ("ln_quant_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:113"),
    ("attnout_ln_q_fused", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:75"),
    ("cross_attention_int8", "ttasr_torch/csrc/cross_attention.cu",
     "ttasr/ops/cross_attention_pallas.py:47"),
    ("gather_cache_rows", "ttasr_torch/csrc/beam_gather.cu",
     "ttasr/ops/beam_gather_pallas.py:23"),
    ("matmul_int8_partial", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:292"),
    ("ln_q_cross_int8", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:322"),
    ("mlp_int8_fused", "ttasr_torch/csrc/decoder_mlp.cu",
     "ttasr/ops/decoder_mlp_pallas.py:65"),
    ("log_mel_spectrogram_fused", "ttasr_torch/csrc/mel.cu",
     "ttasr/ops/mel_pallas.py:114"),
    ("encoder_self_attention", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:23"),
]
# the branch leg whose run gives each new kernel's launches
BRANCH_LAUNCHES = {
    "attnout_ln_q_fused": "bf16 cross-KV (B12)",
    "cross_attention_int8": "unfused int8 graph beam 5 (B13, 5-D cache)",
    "gather_cache_rows": "beam_indirect=False (B17, B10)",
}
# the tensor-parallel leg whose run gives B14-B16's launches
TP_LEG = "TP v2 one rank beam 5 (B15, B16, B14)"


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
    print(f"time_ms floor (one 1-element add per CUDA graph replay): "
          f"{time_ms_floor():.4f} ms; a kernel time near it is the host's graph "
          f"launch rate, not the kernel's ({card})")

    measured = {"encoder_attention_merged": check_encoder_attention(card)}
    measured.update(check_decode_kernels(card))
    measured.update(check_encoder_kernels(card))
    measured.update(check_branch_kernels(card))
    measured.update(check_tp_kernels(card))
    standalone, standalone_launches = check_standalone_kernels(card)
    measured.update(standalone)
    gemm = measured.pop("int8_gemm")
    b6_windows = measured.pop("b6_windows")
    bf16 = run_bf16_path(card)
    main_path = run_int8_path(card, act8=True)
    int8_bf16_encoder = run_int8_path(card, act8=False)
    launches = dict(main_path["counts"], encoder_attention_merged=bf16["launches"])
    for name, leg in BRANCH_LAUNCHES.items():
        launches[name] = main_path["branches"][leg]["counts"][name]
    for name in ("matmul_int8_partial", "ln_q_cross_int8", "mlp_int8_fused"):
        launches[name] = main_path["tp"][TP_LEG]["counts"][name]
    launches.update(standalone_launches)  # phase 8's run: no engine path calls them
    # B9's bf16 entry left the main path: its launches are the parent
    # route's in one encoder pass (compare_encoder_routes)
    launches["gelu_quant"] = main_path["routes"]["parent_gelu_quant_launches"]
    print(f"gelu_quant (bf16 entry): {main_path['counts']['gelu_quant']} launches on the "
          f"main path; {launches['gelu_quant']} in one pass of the parent route")
    print(f"B11 launches: bf16 path {bf16['launches']}, int8 main path "
          f"{main_path['counts']['encoder_attention_merged']}, encoder_act_int8=False "
          f"path {int8_bf16_encoder['counts']['encoder_attention_merged']}")
    print("encoder per window: " + json.dumps({
        "bf16": bf16["encoder_ms"], "int8_act8": main_path["encoder_ms"],
        "int8_bf16_encoder": int8_bf16_encoder["encoder_ms"]}) + f" ({card})")
    print("int8 GEMM: " + json.dumps(gemm))
    print(f"B6 at {MEL_WINDOWS} windows: " + json.dumps(b6_windows))

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        **{k: measured[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")})
        for name, source, replaces in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--tp-rank"]:  # a rank of run_two_ranks
            sys.exit(tp_rank_main(int(sys.argv[2]), sys.argv[3]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
