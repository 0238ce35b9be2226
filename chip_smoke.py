#!/usr/bin/env python3
"""Smoke run of the ttasr_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the device: CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``ttasr_torch/csrc`` with nvcc
   (one process per source, in parallel);
3. holds the encoder-attention kernel (B11) against its plain PyTorch
   version at large-v3 shapes (bf16 and float32, full and ragged
   ``t_real``);
4. holds the int8 decode kernels against their plain versions at large-v3
   shapes: B1 and B4 at 5 rows; B3 at (B, K) = (1, 5) and (5, 1) over int4
   and int8 cross-KV; B2 (beam 5, a non-identity ancestry map) and B10
   (5 audios x 1 row) at cache lengths 288 and 480 with the slot near the
   end and two pad lengths, int4 and int8 self-KV.  New K/V codes and
   scales must be exact; floats within the bounds below.  Each kernel and
   its plain version, and one decoder layer's chain B1 -> B2 -> B3 -> B4
   against the plain chain, are timed in turns (plain, kernel, kernel,
   plain) with CUDA events over replays of a CUDA graph of the call, so
   the host's launch overhead is out of both numbers;
5. drives the bf16 batch CLI path: ``WhisperEngine("large-v3",
   compute_type="bfloat16")`` with random weights from a seeded generator,
   on two synthesized speech-like WAVs (20 s and 45 s, so the seek loop
   crosses a window with prompt carry), through
   ``ttasr_torch.cli.asr.process_audio_folder``; checks the results, that
   B11 ran 32 times per encoder pass, that beam decodes ran with finite
   logits, and that the encoder output agrees with the plain-attention
   encoder on one window;
6. drives the int8 serving path the same way: ``WhisperEngine("large-v3",
   compute_type="int8", encoder_act_int8=False)`` (weights quantized on
   the card, int8 and int4 self-KV, int4 cross-KV, beam 5 through the
   ancestry map, best-of-5 fallback); checks the results and that B1, B3
   and B4 ran 32 times per decode step, B2 32 times per beam step, B10 32
   times per greedy step and B11 32 times per encoder pass, with every
   count set to 0 just before the phase and read just after.

Prints one JSON line with each kernel's launches (from the int8 path's
run; B11's from the bf16 path's), worst error and times, then the card
line, then the contract line ``{"ok": true, "device": {...}}`` last.
Imports nothing of jax.  Exits non-zero, printing no result, when CUDA is
unavailable or the checkout is missing.
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
# int8 decode kernels vs their plain versions, relative to max|plain|: both
# round to bf16 at the same points (LN and GELU outputs, pre-scaled
# queries, scale-folded probabilities) and take exact f32 products; the f32
# sums run in another order, so a last-bit difference can flip one bf16
# rounding of an intermediate and move an output by about one bf16 step of
# one term.  New K/V codes and scales are held exactly.
DECODE_REL = 2e-3

N_LAYERS = 32  # large-v3 decoder and encoder depth


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


def in_turns(kernel_fn, plain_fn):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(plain_fn), time_ms(kernel_fn),
                      time_ms(kernel_fn), time_ms(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


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
        bound = (BF16_REL if dtype == torch.bfloat16 else F32_REL) * scale
        print(f"encoder_attention {str(dtype)[6:]} B={b} T={t} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e}, max|plain| {scale:.3e})")
        check(err <= bound, f"encoder attention disagrees with its plain "
                            f"version: {err} > {bound}")
        worst = max(worst, err)
        if t == t_real:
            kernel_ms, plain_ms = in_turns(
                lambda: encoder_attention_merged(q, k, v, t_real),
                lambda: encoder_attention_merged_ref(q, k, v, t_real))
            print(f"encoder_attention {str(dtype)[6:]} B={b} T={t}: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
            if dtype == torch.bfloat16 and b == 1:
                main_ms, main_plain_ms = kernel_ms, plain_ms
    return {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain_ms}


# ---------------------------------------------------------------------------
# Phase 4: the int8 decode kernels at large-v3 shapes
# ---------------------------------------------------------------------------

D, H, FFN, S_PAD, S_REAL = 1280, 20, 5120, 1504, 1500
HP = 24  # ceil(H / 8) * 8 scale rows


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
    from ttasr_torch.ops import self_attention as sa

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
    res["qkv_int8_fused"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)

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
    ms, plain_ms = in_turns(lambda: blk.attnout_ln_q_cross_int8(*main_b3),
                            lambda: blk.attnout_ln_q_cross_int8_ref(*main_b3))
    res["attnout_ln_q_cross_int8"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)

    # B4: 5 rows
    b4 = (inp.randn(5, D, scale=0.5), inp.randn(5, D, scale=0.5),
          lay["woc"], lay["woc_s"], lay["boc"], lay["ln2_s"], lay["ln2_b"],
          lay["w1"], lay["w1_s"], lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])
    worst = _hold("mlp_with_crossout_int8", "R=5", mlp.mlp_with_crossout_int8(*b4),
                  mlp.mlp_with_crossout_int8_ref(*b4), 0.0)
    ms, plain_ms = in_turns(lambda: mlp.mlp_with_crossout_int8(*b4),
                            lambda: mlp.mlp_with_crossout_int8_ref(*b4))
    res["mlp_with_crossout_int8"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)

    # B2 (beam 5 of one audio, through anc) and B10 (5 audios x 1 row)
    for name, b, k in (("self_attn_step_indirect_int8", 1, 5),
                       ("self_attn_step_int8", 5, 1)):
        worst, main = 0.0, None
        for length in (288, 480):
            slot = length - 3
            # B2: audio-uniform pads (the beams share the prompt); B10: per row
            pad_sets = ([[0] * 5, [100] * 5] if k == 5
                        else [[0, 3, 100, 7, 250], [41] * 5])
            for pads in pad_sets:
                for int4 in (True, False):
                    kc, ks, vc, vs = inp.self_kv(b, k, length, int4)
                    qkv = inp.randn(b, k, 3 * D, scale=0.5)
                    pad = torch.tensor(pads, dtype=torch.int32,
                                       device="cuda").reshape(b, k)
                    kw = dict(n_heads=H, int4=int4)
                    if k > 1:
                        anc = torch.randint(0, k, (b, k, length), generator=inp.gen,
                                            device="cuda", dtype=torch.int32)
                        args = (qkv, kc, ks, vc, vs, anc, pad, slot)
                        fn, ref = sa.self_attn_step_indirect_int8, \
                            sa.self_attn_step_indirect_int8_ref
                    else:
                        args = (qkv, kc, ks, vc, vs, pad, slot)
                        fn, ref = sa.self_attn_step_int8, sa.self_attn_step_int8_ref
                    got, want = fn(*args, **kw), ref(*args, **kw)
                    case = (f"B={b} K={k} len={length} slot={slot} pad={pads[:2]} "
                            f"{'int4' if int4 else 'int8'}")
                    worst = _hold(name, case, got[0], want[0], worst)
                    for i, what in ((1, "k codes"), (2, "k scales"), (3, "v codes"),
                                    (4, "v scales")):
                        check(torch.equal(got[i], want[i]),
                              f"{name} {case}: new {what} differ from the plain version")
                    if length == 480 and int4 and main is None:
                        main = (fn, ref, args, kw)
        fn, ref, args, kw = main
        ms, plain_ms = in_turns(lambda: fn(*args, **kw), lambda: ref(*args, **kw))
        res[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
        print(f"{name}: new codes and scales exact in every case")

    for name, r in res.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms ({card})")
    res["layer_chain"] = time_layer_chain(inp, lay, card)
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
# Phases 5 and 6: the CLI paths end to end
# ---------------------------------------------------------------------------

def _write_wavs(audio_dir: str):
    import numpy as np

    from tools.train_vad import synth_speech
    from ttasr.audio.io import write_wav

    total, first = 0.0, None
    for name, seconds, seed in (("speech20", 20.0, 0), ("speech45", 45.0, 1)):
        audio, _ = synth_speech(np.random.default_rng(seed), seconds)
        write_wav(os.path.join(audio_dir, f"{name}.wav"), audio, 16000)
        total += seconds
        first = audio if first is None else first
    return total, first


def _drive_cli(engine, label: str, card: str, counters) -> dict:
    """process_audio_folder over the two WAVs with ``engine``; counts are
    set to 0 just before and read just after.  Returns the counts, the
    decode stats, the first audio and timing."""
    import torch

    from ttasr_torch.cli.asr import process_audio_folder

    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        audio_seconds, first = _write_wavs(audio_dir)
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
    check(len(entries) == 2, f"{label}: expected 2 results, got {len(entries)}")
    for entry in entries:
        check("error" not in entry, f"{label} {entry['audio_file']}: {entry.get('error')}")
    stats = dict(engine.decode_stats)
    print(f"{label} decode stats: {json.dumps(stats)}")
    check(stats["beam_decodes"] > 0 and stats["beam_steps"] > 0,
          f"{label}: no beam decode step ran")
    check(stats["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: 2 files, {audio_seconds:.1f} s of audio, wall {wall:.2f} s = "
          f"{wall / audio_seconds:.4f} s per audio second, peak memory "
          f"{peak_gib:.2f} GiB ({card})")
    print(f"{label} launches: {json.dumps(counts)}")
    for entry in entries:
        print(f"  {entry['audio_file']}: {len(entry['asr_result'] or '')} chars")
    return dict(counts=counts, stats=stats, first=first, wall=wall,
                audio_seconds=audio_seconds, peak_gib=peak_gib)


def run_bf16_path(card: str) -> int:
    """The batch CLI at large-v3, bf16, beam 5; returns B11's launches."""
    import torch

    from ttasr_torch.cli.asr import build_engine
    from ttasr_torch.models.whisper.model import encode
    from ttasr_torch.ops.encoder_attention import encoder_attention_merged
    from ttasr_torch.ops.mel import log_mel_spectrogram

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

    # the encoder output: finite, of the expected shape, and close to the
    # plain-attention encoder on one window
    with torch.inference_mode():
        mel = log_mel_spectrogram(run["first"], n_mels=engine.cfg.num_mel_bins,
                                  device=engine.device)[None]
        kernel_out = encode(engine.params, engine.cfg, mel)
        plain_out = encode(engine.params, engine.cfg, mel, fused_attention=False)
    check(tuple(kernel_out.shape) == (1, 1500, 1280),
          f"encoder output shape {tuple(kernel_out.shape)}")
    check(bool(torch.isfinite(kernel_out).all()), "non-finite encoder output")
    err = _max_err(kernel_out, plain_out)
    scale = plain_out.float().abs().max().item()
    print(f"encoder large-v3 bf16, kernel vs plain attention: max_abs_err "
          f"{err:.3e}, max|plain| {scale:.3e}")
    check(err <= ENCODER_REL * scale, "encoder disagrees with plain attention")
    return launches


def run_int8_path(card: str) -> dict:
    """The batch CLI on the int8 serving engine; returns each kernel's
    launches in that run."""
    import torch

    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import self_attention as sa
    from ttasr_torch.ops.encoder_attention import encoder_attention_merged

    t0 = time.perf_counter()
    engine = WhisperEngine("large-v3", compute_type="int8", encoder_act_int8=False,
                           device="cuda")
    torch.cuda.synchronize()
    print(f"engine: large-v3 int8 (quantized on the card, bf16 encoder) random "
          f"init in {time.perf_counter() - t0:.1f} s")
    counters = [blk.qkv_int8_fused, sa.self_attn_step_indirect_int8,
                blk.attnout_ln_q_cross_int8, mlp.mlp_with_crossout_int8,
                sa.self_attn_step_int8, encoder_attention_merged]
    run = _drive_cli(engine, "int8 path", card, counters)
    c, st = run["counts"], run["stats"]
    steps = st["beam_steps"] + st["greedy_steps"]
    want = {"qkv_int8_fused": N_LAYERS * steps,
            "attnout_ln_q_cross_int8": N_LAYERS * steps,
            "mlp_with_crossout_int8": N_LAYERS * steps,
            "self_attn_step_indirect_int8": N_LAYERS * st["beam_steps"],
            "self_attn_step_int8": N_LAYERS * st["greedy_steps"],
            "encoder_attention_merged": N_LAYERS * st["encoder_passes"]}
    for name, n in want.items():
        check(n > 0 and c[name] == n,
              f"int8 path: {name} launched {c[name]} times, expected {n} > 0")
    print(f"int8 path: launch counts match the decode stats "
          f"({st['beam_steps']} beam + {st['greedy_steps']} greedy steps, "
          f"{st['encoder_passes']} encoder passes, x {N_LAYERS} layers)")
    return c


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
]


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

    measured = {"encoder_attention_merged": check_encoder_attention(card)}
    measured.update(check_decode_kernels(card))
    b11_bf16 = run_bf16_path(card)
    launches = run_int8_path(card)
    print(f"B11 launches: bf16 path {b11_bf16}, int8 path "
          f"{launches['encoder_attention_merged']}")

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name], max_abs_err=measured[name]["max_abs_err"],
        ms=measured[name]["ms"], plain_ms=measured[name]["plain_ms"])
        for name, source, replaces in KERNELS]}))
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
