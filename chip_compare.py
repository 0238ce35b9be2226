#!/usr/bin/env python3
"""Times the decode step's int8 kernels of this checkout against those of
another copy of ``ttasr_torch/csrc`` on one NVIDIA GPU.

    python3 chip_compare.py --other DIR [--phases | --encoder | --mel | --attention]
    python3 chip_compare.py --server

DIR holds the other sources, for instance the parent commit's
``ttasr_torch/csrc`` written out with ``git show`` or ``git archive``.  Both
are built with nvcc into separate libraries and called through the same C
entry points on the same seeded large-v3 inputs (``chip_smoke.Inputs``):
B15, the LayerNorm GEMM alone (B1's entry at N = 1280), B1, B13 (int4 and
int8), B3, B16, B4, B14, B12, and the self-attention step B2 (beam 5 of one
audio, through a random ancestry map) and B10 (5 audios x 1 row), int4, at
cache lengths 480, 288 and 64 (slots 477, 285, 40).  For each, the two
builds in turns (other, this, this, other), it prints ``chip_smoke.time_ms``
(one call per CUDA graph replay, whose floor it prints too), the time per
call of a graph of 20 calls (no host launch floor) and the kernels' device
time from ``torch.profiler``, how far the other build's output lies from
this one's and whether the two are equal bit for bit (B4 and B14 must be:
the persistent kernel keeps the three launches' order; so is B1, whose
two teams per block keep its cluster's order); then B15, the other build's
B15 and B15's library call (a bf16 matmul) cold, over the 64 distinct
weights of a tensor-parallel step; B1 and B4 cold, over 32 layers'
distinct weights, each build in turns.
Then B2 and B10 at int4: this build and the other cold, over 32 layers'
distinct caches; and, as a yardstick that is not the same function, ``scaled_dot_product_attention``
on 5 query rows and bf16 K/V of the dequantized cache's shape (2-4x the
bytes, no quantization, no ancestry lookup).

``--phases`` also builds an instrumented copy of this checkout's kernels:
thread 0 of every block stamps ``%globaltimer`` at the skinny GEMM's, the
cross-attention's, the self-attention step's and the persistent MLP
kernel's (B4, B14) phase points, and the script prints, per phase, the
median and the latest block's microseconds from the first block's start
(over the blocks that reached the point).

``--encoder`` compares the s8 x s8 encoder's row kernels instead
(``encoder_fused.cu``): the entries both builds have in turns as above,
on seeded large-v3 inputs (B5, B7, B8 and B9 at one window; B9 and B5
from W1's and W2's int32 accumulators at one window and at bench.py's 48),
every output compared; then this build's accumulator entries of B8 and
the qkv GEMM (``add_ln_quant_acc``, ``qkv_epilogue_acc``) at one and 48
windows in turns with the parent route's torch epilogue and bf16 entry,
each beside its byte bound.

``--mel`` compares B18 (``mel.cu``) instead: the other copy's entry point
of the dense design (before the in-kernel FFT: the DFT basis and the
filterbank in, its clamp and rescale as torch ops after it, as its wrapper
called it) and this checkout's ``log_mel_spectrogram_fused``, in turns at B = 1 (the 45 s clip) and at 48
windows (``chip_smoke._mel_batch``): ``time_ms``, device ms, each output's
distance from the float64 plain version (also on a 30 s clip whose loud
onset puts the max - 8 floor in play, and a loud tone over faint noise),
and the CUDA kernels of one call of each, by name, from torch.profiler;
then ptxas's register and spill report of this checkout's ``mel.cu`` and,
from an instrumented copy, the FFT kernel's clock64 cycles per tile in
each phase (thread 0 of every block, after the phase's barrier) at both
sizes.

``--attention`` compares the encoder attention (``encoder_attention.cu``)
instead: B11 (bf16 at (1, 1500, 1280) and (4, 1536, 1280) with t_real
1500, float32 at one window), B6 (bf16 and float32 at one window) and B19
((1, 1500, 20, 64) bf16 and float32) of both builds in turns as above;
every bf16-kernel output (B19's float32 inputs too) must equal the other
build's bit for bit, and each build's float32 B11 and B6 are held to the
plain version within ``chip_smoke.F32_REL`` x max, with both errors
printed and each build's kernels' device ms per call (the 3xTF32 pre-pass
beside the kernel); first ptxas's register and spill report of this
checkout's ``encoder_attention.cu``.  A DIR whose ``encoder_attention.cu`` has no
``split_tf32_kernel`` (its float32 path the SIMT kernel) is called with
B11's and B6's argument lists from before it (no scratch); only a
comparison with a build from before the 3xTF32 kernel needs them.

The parent of the persistent MLP kernel took B4 and B14 without their
scratch, counters and schedule: a DIR whose ``decoder_mlp.cu`` has no
``mlp_persistent_kernel`` is called with that argument list.  The instrumentation is text inserted at
fixed places of the sources and fails loudly when they change.

``--server`` (no DIR) times the serving layer's dispatch instead: the task
API's call of phase 14 (``chip_smoke._uploads``) over four uploads at once
through ``shared_server(engine, slots=4)`` and
``transcribe_batched_with_server`` on the int8 engine with its defaults,
four times in turns: as the checkout runs it (the next group dispatched
while one decodes, its device work waiting for that group's), with the
engine's device lock taken off (two groups' decode loops at once), with
``TTASR_PIPELINE_GROUPS=1``, and as the checkout runs it again; each with
its wall, ms per decode step, sweeps and dispatches started while another
group was in flight.

Imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "ttasr_torch", "csrc")
SOURCES = ("decoder_blocks.cu", "decoder_mlp.cu", "cross_attention.cu", "self_attention.cu")
ENCODER_SOURCES = ("encoder_fused.cu",)
ATTENTION_SOURCES = ("encoder_attention.cu",)
MEL_SOURCES = ("mel.cu",)


_P, _I = ctypes.c_void_p, ctypes.c_int
# B4's and B14's entry points before the persistent kernel: no scratch for
# the partial sums, no counters, no schedule
LEGACY_MLP_ARGTYPES = {
    "ttasr_mlp_int8": [_P] * 11 + [_I] * 4 + [_P],
    "ttasr_mlp_crossout_int8": [_P] * 16 + [_I] * 3 + [_P],
}


# B11's and B6's entry points before the 3xTF32 kernel (no scratch), for
# comparisons with such builds only
LEGACY_ATTENTION_ARGTYPES = {
    "ttasr_encoder_attention": [_P] * 4 + [_I] * 5 + [_P],
    "ttasr_encoder_attention_qkv": [_P] * 2 + [_I] * 5 + [_P],
}


def legacy_attention(src_dir: str) -> bool:
    """``src_dir``'s B11 and B6 take no scratch (float32 on the SIMT kernel)."""
    path = os.path.join(src_dir, "encoder_attention.cu")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return "split_tf32_kernel" not in f.read()


def legacy_mlp(src_dir: str) -> bool:
    """``src_dir``'s B4 and B14 take the argument list of three launches."""
    with open(os.path.join(src_dir, "decoder_mlp.cu")) as f:
        return "mlp_persistent_kernel" not in f.read()


def build(src_dir: str, out_dir: str, tag: str, sources=SOURCES) -> ctypes.CDLL:
    """The kernels of ``sources`` in ``src_dir`` (default: the decode
    kernels) in a library of their own."""
    from ttasr_torch.ops import _build

    nvcc = _build._nvcc()
    objs = [os.path.join(out_dir, f"{tag}_{s}.o") for s in sources]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, os.path.join(src_dir, s)]
                     for s, o in zip(sources, objs)])
    lib = os.path.join(out_dir, f"lib{tag}.so")
    _build._run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                      lib, *objs]])
    dll = ctypes.CDLL(lib)
    argtypes = dict(_build.ARGTYPES)
    dll.legacy_mlp = legacy_mlp(src_dir)
    if dll.legacy_mlp:
        argtypes.update(LEGACY_MLP_ARGTYPES)
    dll.legacy_attention = legacy_attention(src_dir)
    if dll.legacy_attention:
        argtypes.update(LEGACY_ATTENTION_ARGTYPES)
    for name, types in argtypes.items():
        if hasattr(dll, name):
            getattr(dll, name).argtypes = types
            getattr(dll, name).restype = ctypes.c_int
    return dll


def call(dll, entry, *args) -> None:
    import torch

    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(dll, entry)(*c_args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: cudaError {err}")


def case(entry, *args):
    """(entry point, the output that is compared, args...): the output is
    the last tensor argument."""
    import torch

    return (entry, [a for a in args if isinstance(a, torch.Tensor)][-1], *args)


def self_attn_case(cs, inp, b, k, length, slot, int4=True):
    """B2 (k > 1, a random ancestry map) or B10 (k = 1) at one length:
    (entry point, attn, the C entry point's arguments)."""
    import torch

    kc, ks, vc, vs = inp.self_kv(b, k, length, int4)
    d_store = cs.D // 2 if int4 else cs.D
    kv_dtype = torch.uint8 if int4 else torch.int8
    anc = (torch.randint(0, k, (b, k, length), generator=inp.gen, device="cuda",
                         dtype=torch.int32) if k > 1 else None)

    def e(*shape, dtype=torch.float32):
        return torch.empty(shape, device="cuda", dtype=dtype)

    attn = e(b, k, cs.D)
    return ("ttasr_self_attn_step", attn, inp.randn(b, k, 3 * cs.D, scale=0.5), kc, ks, vc, vs,
            anc, torch.zeros((b, k), dtype=torch.int32, device="cuda"), attn,
            e(b, k, d_store, dtype=kv_dtype), e(b, k, cs.H), e(b, k, d_store, dtype=kv_dtype),
            e(b, k, cs.H), b, k, cs.H, length, cs.HP, slot, int(int4))


def self_cases(cs):
    """{label: (entry point, output, args...)} of B2 and B10 at the timed
    lengths, int4."""
    inp = cs.Inputs(3)
    return {f"{name} len={length} slot={slot} int4": self_attn_case(cs, inp, b, k, length, slot)
            for length, slot in cs.SELF_LENGTHS
            for name, b, k in (("B2 B=1 K=5", 1, 5), ("B10 B=5 K=1", 5, 1))}


def mlp_scratch(D: int, F: int, r: int, cross: bool, legacy: bool) -> list:
    """B4's (``cross``) or B14's arguments after the output: the persistent
    kernel's partial sums, counters, schedule and their ints (none for a
    legacy build)."""
    import torch

    from ttasr_torch.ops.decoder_mlp import _persistent_args

    return [] if legacy else list(_persistent_args(torch.device("cuda", 0), D, F, r, cross))


def cases(cs, legacy: bool = False):
    """{label: (entry point, the output that is compared, args...)};
    ``legacy``: B4 and B14 with the argument list of three launches."""
    import torch

    D, F, S, SR = cs.D, cs.FFN, cs.S_PAD, cs.S_REAL
    inp = cs.Inputs(1)
    lay = inp.layer()

    def e(*shape, dtype=torch.float32):
        return torch.empty(shape, device="cuda", dtype=dtype)

    def mlp_ints(r, partial=None):
        """(B4's or B14's scratch tensors, then R, D, F[, partial] and the
        persistent kernel's ints)."""
        pre = [r, D, F] + ([] if partial is None else [partial])
        scratch = mlp_scratch(D, F, r, partial is None, legacy)
        return scratch[:3], pre + scratch[3:]

    b4_buf, b4_ints = mlp_ints(5)
    b14_buf, b14_ints = mlp_ints(5, 1)
    b4_out, b14_out = e(5, D), e(5, D)
    x5, a5, q = inp.randn(5, D, scale=0.5), inp.randn(5, D, scale=0.5), inp.randn(1, 5, D, scale=0.05)
    kv4, kv8 = inp.cross_kv(1, True), inp.cross_kv(1, False)
    cross = (lay["wqc"], lay["wqc_s"], lay["bqc"])
    return {
        "B15 R=5 (DL=1280)": case(
            "ttasr_matmul_int8_partial", x5, lay["wo"], lay["wo_s"], e(5, D), 5, D, D),
        "LayerNorm GEMM R=5 (B1's entry at N=1280)": case(
            "ttasr_qkv_int8", x5, lay["lnc_s"], lay["lnc_b"], *cross, e(5, D), 5, D, D),
        "B1 R=5": case(
            "ttasr_qkv_int8", x5, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"],
            lay["bqkv"], e(5, 3 * D), 5, D, 3 * D),
        "B13 B=1 K=5 int4": case(
            "ttasr_cross_attention_int8", q, *kv4, e(1, 5, D), 1, 5, D, S, SR, 1),
        "B13 B=1 K=5 int8": case(
            "ttasr_cross_attention_int8", q, *kv8, e(1, 5, D), 1, 5, D, S, SR, 0),
        "B3 B=1 K=5 int4": case(
            "ttasr_attnout_cross_int8", x5, a5, lay["wo"], lay["wo_s"], lay["bo"],
            lay["lnc_s"], lay["lnc_b"], *cross, *kv4, e(5, D), e(5, D), e(5, D),
            1, 5, D, D, S, SR, 1),
        "B16 B=1 K=5 int4": case(
            "ttasr_ln_q_cross_int8", x5, lay["lnc_s"], lay["lnc_b"], *cross, *kv4,
            e(5, D), e(5, D), 1, 5, D, D, S, SR, 1),
        "B4 R=5": ("ttasr_mlp_crossout_int8", b4_out, x5, a5, lay["woc"], lay["woc_s"],
                   lay["boc"], lay["ln2_s"], lay["ln2_b"], lay["w1"], lay["w1_s"], lay["b1"],
                   lay["w2"], lay["w2_s"], lay["b2"], e(5, D), e(5, F, dtype=torch.bfloat16),
                   b4_out, *b4_buf, *b4_ints),
        "B14 partial R=5": ("ttasr_mlp_int8", b14_out, x5, lay["ln2_s"], lay["ln2_b"],
                            lay["w1"], lay["w1_s"], lay["b1"], lay["w2"], lay["w2_s"],
                            lay["b2"], e(5, F, dtype=torch.bfloat16), b14_out, *b14_buf,
                            *b14_ints),
        "B12 R=10": case(
            "ttasr_attnout_ln_q", inp.randn(10, D), inp.randn(10, D), lay["wo"],
            lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"], *cross, e(10, D), e(10, D),
            10, D, D),
        **self_cases(cs),
    }


def encoder_cases(cs):
    """{label: (entry point, [the outputs compared], args...)}: the row
    kernels' entries that the parent build has too, on seeded large-v3
    inputs (bf16 LayerNorm vectors and biases): B5, B7, B8 and B9 at one
    window, B9 and B5 from W1's and W2's accumulators at one and 48."""
    import torch

    D, F, T = cs.D, cs.FFN, cs.ENC_T
    gen = torch.Generator(device="cuda").manual_seed(3)

    def act(rows, width, scale=1.0):
        x = torch.randn((rows, width), generator=gen, device="cuda") * scale
        return (x * (torch.rand((rows, 1), generator=gen, device="cuda") * 3.9 + 0.1)
                ).to(torch.bfloat16)

    def outs(rows, width):
        return (torch.empty((rows, width), device="cuda", dtype=torch.bfloat16),
                torch.empty((rows, width), device="cuda", dtype=torch.int8),
                torch.empty(rows, device="cuda"))

    ln_s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    ln_b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    x, y, h = act(T, D), act(T, D, 0.5), act(T, F, 2.0)
    res, codes, scales = outs(T, D)
    _, h_codes, h_scales = outs(T, F)
    out = {
        "ln_quant B=1": ("ttasr_ln_quant", [codes, scales], x, ln_s, ln_b, codes, scales,
                         T, D, 6),
        "add_ln_quant B=1": ("ttasr_add_ln_quant", [res, codes, scales], x, y, ln_s, ln_b,
                             res, codes, scales, T, D, 6),
        "gelu_quant B=1": ("ttasr_gelu_quant", [h_codes, h_scales], h, h_codes, h_scales,
                           T, F),
        "quant_only B=1": ("ttasr_quant_only", [codes, scales], x, codes, scales, T, D),
    }
    for b in (1, cs.MEL_WINDOWS):
        rows = b * T
        w1, w2 = cs._acc_case(gen, b, D, F), cs._acc_case(gen, b, F, D)
        xb = act(rows, D)
        res, codes, scales = outs(rows, D)
        _, h_codes, h_scales = outs(rows, F)
        out[f"gelu_quant_acc B={b}"] = ("ttasr_gelu_quant_acc", [h_codes, h_scales], *w1,
                                        h_codes, h_scales, rows, F, 1)
        out[f"ln_quant_acc B={b}"] = ("ttasr_ln_quant_acc", [res, codes, scales], xb, *w2,
                                      ln_s, ln_b, res, codes, scales, rows, D, 7)
    return out


def new_encoder_entries(cs, card: str) -> None:
    """This checkout's ``add_ln_quant_acc`` and ``qkv_epilogue_acc`` at one
    and 48 windows (seeded accumulators of wo's and the qkv GEMM's shapes),
    in turns with the parent route (``chip_smoke.parent_add_ln_quant_acc``;
    for the qkv epilogue its plain version, the parent's column scale and
    torch epilogue): ``time_ms``, per call in a graph of 20,
    device ms; the byte bound and its share; outputs equal bit for bit."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    gen = torch.Generator(device="cuda").manual_seed(4)
    ln_s = (1.0 + 0.1 * torch.randn(cs.D, generator=gen, device="cuda")).to(torch.bfloat16)
    ln_b = (0.1 * torch.randn(cs.D, generator=gen, device="cuda")).to(torch.bfloat16)
    for b in (1, cs.MEL_WINDOWS):
        x = (torch.randn((b, cs.ENC_T, cs.D), generator=gen, device="cuda") * 2.0
             ).to(torch.bfloat16)
        entries = {
            "add_ln_quant_acc": (ef.add_ln_quant_acc, cs.parent_add_ln_quant_acc,
                                 (x, *cs._acc_case(gen, b, cs.D, cs.D), ln_s, ln_b)),
            "qkv_epilogue_acc": (ef.qkv_epilogue_acc, ef.qkv_epilogue_acc_ref,
                                 (*cs._acc_case(gen, b, cs.D, 3 * cs.D), cs.Q_SCALE)),
        }
        for name, (fn, parent, args) in entries.items():
            got, old = cs._tensors(fn(*args)), cs._tensors(parent(*args))
            same = all(torch.equal(g, o) for g, o in zip(got, old))
            cs.check(same, f"{name} B={b}: differs from the parent route")
            ins = [a.float() if getattr(a, "ndim", 0) == 1 else a for a in args]
            bnd = cs.bound(cs._tensors(ins, got), 0.0, "f32")["bound_ms"]
            times = {"parent": [], "this": []}
            for tag in ("parent", "this", "this", "parent"):
                f = (lambda: fn(*args)) if tag == "this" else (lambda: parent(*args))
                times[tag].append((cs.time_ms(f), cs.per_call_ms(f), sum(device_ms(f).values())))
            m = {k: np.mean(np.array(v), axis=0) for k, v in times.items()}
            print(f"{name} B={b}: " + "; ".join(
                f"{k} time_ms {v[0]:.4f}, in a graph of 20 {v[1]:.4f}, device {v[2]:.4f}"
                for k, v in m.items()) + f" ms; byte bound {bnd:.4f} ms, "
                f"{bnd / m['this'][2]:.1%} of it by device time; bit for bit the parent "
                f"route's: {same} ({card})", flush=True)
        del x, entries
        torch.cuda.empty_cache()


def _mel_test_clips(n: int = 480000):
    """A 30 s clip of faint noise with a loud chirp from 12 s, and a loud
    7 kHz tone over faint noise (``tests/test_torch_mel_fft.py``'s)."""
    import torch

    t = np.arange(n) / 16000
    onset = 1e-3 * np.random.default_rng(5).standard_normal(n)
    on = t >= 12.0
    onset[on] += 0.8 * np.sin(2 * np.pi * (200 + 150 * (t[on] - 12.0)) * t[on])
    tone = (0.9 * np.sin(2 * np.pi * 7000 * t)
            + 3e-4 * np.random.default_rng(7).standard_normal(n))
    return {name: torch.from_numpy(a.astype(np.float32)).cuda()
            for name, a in (("loud onset", onset), ("7 kHz tone", tone))}


# clock64 marks after each phase of mel.cu's FFT kernel, thread 0's sums
MEL_PHASES = ("staging wait", "stage 1", "stage 2 and the split", "projection",
              "tile max")
MEL_MARKS = [
    ("mel.cu", "namespace {\n", "__device__ unsigned long long g_mel_phase[8];\nnamespace {\n"),
    ("mel.cu", "    const int nf = min(kFrames, kNFrames - f0);\n",
     "    const int nf = min(kFrames, kNFrames - f0);\n    const long long c0 = clock64();\n"),
    ("mel.cu", "    __syncthreads();   // ... from every thread; the tables are in\n",
     "    __syncthreads();   // ... from every thread; the tables are in\n"
     "    const long long c1 = clock64();\n"),
    ("mel.cu", "    // stage 2, float64, a thread per",
     "    const long long c2 = clock64();\n    // stage 2, float64, a thread per"),
    ("mel.cu", "    // mel m of frame j over its bins",
     "    const long long c3 = clock64();\n    // mel m of frame j over its bins"),
    ("mel.cu", "#pragma unroll\n    for (int off = 16; off > 0; off >>= 1) vmax",
     "    __syncthreads();\n    const long long c4 = clock64();\n"
     "#pragma unroll\n    for (int off = 16; off > 0; off >>= 1) vmax"),
    ("mel.cu", "      tile_max[tile] = m;\n",
     "      tile_max[tile] = m;\n      const long long c[6] = {c0, c1, c2, c3, c4, clock64()};\n"
     "      for (int i = 0; i < 5; ++i) atomicAdd(&g_mel_phase[i], (unsigned long long)(c[i + 1] - c[i]));\n"
     "      atomicAdd(&g_mel_phase[7], 1ull);\n"),
]
MEL_READ = """
extern "C" int ttasr_mel_phases(unsigned long long* host, int reset) {
  unsigned long long zero[8] = {0};
  if (reset) return (int)cudaMemcpyToSymbol(g_mel_phase, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_mel_phase, sizeof(zero));
}
"""


def mel_phases(cs, inputs: dict, out_dir: str, card: str) -> None:
    """This checkout's FFT kernel, instrumented (MEL_MARKS): clock64 cycles
    per tile in each phase, over 10 calls on each input."""
    import torch

    from ttasr_torch.ops import mel_fused

    print("mel.cu, ptxas: " + ptxas_report("mel.cu", out_dir), flush=True)
    src = edited(out_dir, "csrc_mel_phases", MEL_MARKS)
    with open(os.path.join(src, "mel.cu"), "a") as f:
        f.write(MEL_READ)
    dll = build(src, out_dir, "melphases", MEL_SOURCES)
    dll.ttasr_mel_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.ttasr_mel_phases.restype = ctypes.c_int
    n_mels = cs.N_MELS
    for name, x in inputs.items():
        x2 = x.reshape(-1, x.shape[-1])
        b, n = x2.shape
        consts = mel_fused._kernel_constants(n_mels, x.device)
        out = torch.empty((b, n_mels, 3000), device=x.device)
        tile_max = torch.empty((b, mel_fused.TILES), device=x.device)
        dll.ttasr_mel_phases(None, 1)
        for _ in range(10):
            call(dll, "ttasr_log_mel", x2, *consts, out, tile_max, b, n, n_mels,
                 consts[-1].numel())
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 8)()
        dll.ttasr_mel_phases(sums, 0)
        tiles = max(sums[7], 1)
        print(f"mel.cu {name}, clock64 cycles per tile (thread 0, after each phase's "
              f"barrier): " + ", ".join(f"{what} {sums[i] / tiles:.0f}"
                                        for i, what in enumerate(MEL_PHASES))
              + f" ({card})", flush=True)


def mel_routes(cs, other, out_dir: str, card: str) -> None:
    """B18 through the other build (``other``) and this checkout in turns
    (see the module docstring)."""
    import torch

    from ttasr_torch.ops import mel_fused
    from ttasr_torch.ops.mel import _dft_basis, mel_filter_bank

    if hasattr(other, "ttasr_log_mel_tail"):
        raise RuntimeError("--mel compares against a mel.cu of the dense design")
    other.ttasr_log_mel.argtypes = [_P] * 4 + [_I] * 3 + [_P]  # x, basis, fb, out
    n_mels = cs.N_MELS
    cos, sin = _dft_basis()
    basis = np.zeros((400, 224, 2), np.float32)
    basis[:, :201, 0], basis[:, :201, 1] = cos, sin
    dense = [torch.from_numpy(a).cuda() for a in (basis, np.ascontiguousarray(
        mel_filter_bank(n_mels)))]

    def parent(x):
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.empty((x2.shape[0], n_mels, 3000), device=x.device)
        call(other, "ttasr_log_mel", x2, *dense, out, x2.shape[0], x2.shape[1], n_mels)
        peak = out.amax(dim=(1, 2), keepdim=True)
        out = (torch.maximum(out, peak - 8.0) + 4.0) / 4.0
        return out.reshape(x.shape[:-1] + (n_mels, 3000))

    fns = {"other": parent, "this": lambda x: mel_fused.log_mel_spectrogram_fused(x, n_mels)}
    clips = {name: torch.from_numpy(cs.synth_speech(np.random.default_rng(seed),
                                                    seconds)[0]).cuda()
             for name, seconds, seed in cs.AUDIO}
    inputs = {"B=1 (45 s)": clips["speech45"], f"B={cs.MEL_WINDOWS}": cs._mel_batch(clips)}
    for name, x in {**inputs, **_mel_test_clips()}.items():
        want = mel_fused.log_mel_spectrogram_fused_ref(x, n_mels)
        errs = "; ".join(f"{tag} {(fn(x) - want).abs().max().item():.3e}"
                         for tag, fn in fns.items())
        print(f"log-mel {name}: max |out - float64 plain version|: {errs} (bound 2e-4) "
              f"({card})", flush=True)
    for name, x in inputs.items():
        times = {tag: [] for tag in fns}
        for tag in ("other", "this", "this", "other"):
            f = (lambda fn=fns[tag]: fn(x))
            times[tag].append((cs.time_ms(f), sum(device_ms(f).values())))
        mean = {k: np.mean(np.array(v), axis=0) for k, v in times.items()}
        print(f"log-mel {name}: " + "; ".join(
            f"{k} time_ms {m[0]:.4f}, device {m[1]:.4f}" for k, m in mean.items())
            + f" ms ({card})", flush=True)
    x = inputs[f"B={cs.MEL_WINDOWS}"]
    for tag, fn in fns.items():
        print(f"log-mel B={cs.MEL_WINDOWS}, {tag}: one call's CUDA kernels "
              f"{cs._kernel_names(lambda: fn(x))} ({card})", flush=True)
    mel_phases(cs, inputs, out_dir, card)


def attention_cases(cs, dll, plain=None):
    """B11, B6 and B19 on seeded inputs (the same for every build), in
    ``dll``'s argument lists; ``plain``, when given, gets each float32 B11
    and B6 case's plain version under its label."""
    import torch

    from ttasr_torch.ops import encoder_attention as ea

    gen = torch.Generator(device="cuda").manual_seed(4)
    D, T = cs.D, cs.ENC_T
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def scratch(b, t, dtype):
        if dll.legacy_attention:
            return []
        return [ea.f32_scratch(b, t, D, "cuda") if dtype == torch.float32 else None]

    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        shapes = ((1, T, T), (4, 1536, T)) if dtype == torch.bfloat16 else ((1, T, T),)
        for b, t, t_real in shapes:
            q, k, v = rand(b, t, D, dtype=dtype, scale=64 ** -0.5), rand(
                b, t, D, dtype=dtype), rand(b, t, D, dtype=dtype)
            o = torch.empty_like(q)
            label = f"B11 {tag} B={b} T={t} t_real={t_real}"
            out[label] = ("ttasr_encoder_attention", o, q, k, v, *scratch(b, t, dtype), o, b, t,
                          D, t_real, codes[dtype])
            if plain is not None and dtype == torch.float32:
                plain[label] = lambda q=q, k=k, v=v, t_real=t_real: ea.encoder_attention_merged_ref(
                    q, k, v, t_real)
        colscale = torch.ones(3 * D, device="cuda")
        colscale[:D] = 64 ** -0.5
        qkv = (torch.randn((1, T, 3 * D), generator=gen, device="cuda") * colscale).to(dtype)
        o = torch.empty((1, T, D), dtype=dtype, device="cuda")
        label = f"B6 {tag} B=1 T={T}"
        out[label] = ("ttasr_encoder_attention_qkv", o, qkv, *scratch(1, T, dtype), o, 1, T, D, T,
                      codes[dtype])
        if plain is not None and dtype == torch.float32:
            plain[label] = lambda qkv=qkv: ea.encoder_attention_merged_qkv_ref(qkv, T)
        q, k, v = (rand(1, T, cs.H, 64, dtype=dtype) for _ in range(3))
        o = torch.empty_like(q)
        bf = (torch.empty(3 * q.numel(), dtype=torch.bfloat16, device="cuda")
              if dtype == torch.float32 else None)
        out[f"B19 {tag} B=1 T={T}"] = ("ttasr_encoder_self_attention", o, q, k, v, bf, o, 1, T, D,
                                       codes[dtype])
    return out


def ptxas_report(source: str, out_dir: str) -> str:
    """ptxas's registers and spills for each kernel of this checkout's
    ``csrc/<source>``."""
    from ttasr_torch.ops import _build

    ptxas = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                            os.path.join(out_dir, source + ".v.o"), os.path.join(CSRC, source)],
                           capture_output=True, text=True, check=True)
    text = subprocess.run(["c++filt"], input=ptxas.stdout + ptxas.stderr, capture_output=True,
                          text=True, check=True).stdout
    report, kernel = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = re.search(r"function '([^']+)'", line).group(1)
        elif "registers" in line or "spill" in line:
            report.append(f"{kernel}: {line.replace('ptxas info    :', '').strip()}")
    return "; ".join(report)


def attention(cs, builds: dict, out_dir: str, card: str) -> None:
    """ptxas's register and spill report of this checkout's
    ``encoder_attention.cu``; the encoder attention of both builds in turns
    (:func:`in_turns`), then each case's outputs: the bf16 kernel's equal
    bit for bit across the builds, float32 B11 and B6 each held to the
    plain version, with each build's kernels' device ms per call."""
    import torch

    print("encoder_attention.cu, ptxas: " + ptxas_report("encoder_attention.cu", out_dir),
          flush=True)
    in_turns(cs, builds, card, make_cases=lambda dll: attention_cases(cs, dll))
    plain = {}
    by_tag = {tag: attention_cases(cs, dll, plain if tag == "this" else None)
              for tag, dll in builds.items()}
    for label, case in by_tag["this"].items():
        outs = {}
        for tag, dll in builds.items():
            entry, out, *args = by_tag[tag][label]
            call(dll, entry, *args)
            torch.cuda.synchronize()
            outs[tag] = out.clone()
        if label in plain:
            want = plain[label]()
            limit = cs.F32_REL * want.abs().max().item()
            errs = {tag: cs._max_err(o, want) for tag, o in outs.items()}
            print(f"{label}: max_abs_err against the plain version " + ", ".join(
                f"{tag} {e:.3e}" for tag, e in errs.items()) + f" (bound {limit:.3e}) ({card})",
                flush=True)
            cs.check(errs["this"] <= limit, f"{label}: {errs['this']} > {limit}")
            for tag, dll in builds.items():
                entry, out, *args = by_tag[tag][label]
                ms = device_ms(lambda d=dll, e=entry, a=args: call(d, e, *a))
                total = sum(ms.values())
                print(f"{label}, {tag}: device ms per call by kernel " + "; ".join(
                    f"{name}: {t:.4f} ({t / total:.1%})" for name, t in ms.items())
                    + f" ({card})", flush=True)
        else:
            same = all(torch.equal(o.view(torch.int16 if o.dtype == torch.bfloat16
                                          else torch.int32),
                                   outs["this"].view(torch.int16 if o.dtype == torch.bfloat16
                                                     else torch.int32))
                       for o in outs.values())
            print(f"{label}: bit for bit across the builds: {same}", flush=True)
            cs.check(same, f"{label}: the builds' outputs differ")


def device_ms(fn, n: int = 30) -> dict:
    """{CUDA kernel name as the profiler gives it: device milliseconds per
    call of ``fn``}, from torch.profiler over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def in_turns(cs, builds: dict, card: str, make_cases=None) -> None:
    """Each case through every build (``builds`` in order, then reversed;
    the last is "this"): time_ms, per call in a graph of 20, device ms, and
    each build's output gap to this one's and whether the two are equal bit
    for bit.  Each build gets the cases of its own argument lists
    (``make_cases(dll)``, default :func:`cases`), on the same seeded
    inputs; a case's compared output may be a list of tensors."""
    import torch

    make_cases = make_cases or (lambda dll: cases(cs, dll.legacy_mlp))
    by_tag = {tag: make_cases(dll) for tag, dll in builds.items()}
    for label in by_tag["this"]:
        res, fns = {}, {}
        for tag, dll in builds.items():
            entry, out, *args = by_tag[tag][label]
            fns[tag] = (lambda d=dll, e=entry, a=args: call(d, e, *a))
            fns[tag]()
            torch.cuda.synchronize()
            res[tag] = torch.cat([o.float().flatten()
                                  for o in (out if isinstance(out, list) else [out])])
        times = {tag: [] for tag in builds}
        for tag in list(builds) + list(reversed(builds)):
            fn = fns[tag]
            times[tag].append((cs.time_ms(fn), cs.per_call_ms(fn), sum(device_ms(fn).values())))
        mean = {k: np.mean(np.array(v), axis=0) for k, v in times.items()}
        gaps = "; ".join(
            f"max|this - {tag}| {(res[tag] - res['this']).abs().max().item():.3e}, bit for bit "
            f"{torch.equal(res[tag].view(torch.int32), res['this'].view(torch.int32))}"
            for tag in builds if tag != "this")
        print(f"{label}: " + "; ".join(
            f"{k} time_ms {m[0]:.4f}, in a graph of 20 {m[1]:.4f}, device {m[2]:.4f}"
            for k, m in mean.items()) + f" ms; {gaps} ({card})", flush=True)


def self_cold(cs, builds: dict, card: str) -> None:
    """B2 and B10 at len 480, int4, cold: a CUDA graph over 32 layers'
    distinct caches (~3.5 MB each, beyond the 50 MB L2 together), as one
    decode step meets them, each build in turns."""
    for name, b, k in (("B2 B=1 K=5", 1, 5), ("B10 B=5 K=1", 5, 1)):
        inp = cs.Inputs(5)
        layers = [self_attn_case(cs, inp, b, k, 480, 477) for _ in range(cs.N_LAYERS)]
        for tag in list(builds) + list(reversed(builds)):
            fns = [lambda c=c, d=builds[tag]: call(d, c[0], *c[2:]) for c in layers]
            print(f"{name} len=480 slot=477 int4 cold, {tag}: {cs.time_cold_ms(fns):.4f} ms "
                  f"per call (a graph over {len(fns)} layers' caches) ({card})", flush=True)


def weights_cold(cs, builds: dict, card: str) -> None:
    """B1 and B4 at 5 rows, cold: a CUDA graph over 32 layers' distinct
    weights (B1's W_qkv 4.9 MB, B4's wo_c, W1 and W2 14.7 MB a layer), as
    one decode step meets them, each build in turns."""
    import torch

    D, F = cs.D, cs.FFN
    inp = cs.Inputs(6)
    lay = inp.layer()
    x5, a5 = inp.randn(5, D, scale=0.5), inp.randn(5, D, scale=0.5)
    layers = [(inp.weight(D, 3 * D), inp.weight(D, D), inp.weight(D, F), inp.weight(F, D))
              for _ in range(cs.N_LAYERS)]

    def e(*shape, dtype=torch.float32):
        return torch.empty(shape, device="cuda", dtype=dtype)

    def b1(dll):
        out = e(5, 3 * D)
        return [lambda w=w[0]: call(dll, "ttasr_qkv_int8", x5, lay["ln1_s"], lay["ln1_b"], *w,
                                    lay["bqkv"], out, 5, D, 3 * D) for w in layers]

    def b4(dll):
        xm, h, out = e(5, D), e(5, F, dtype=torch.bfloat16), e(5, D)
        scratch = mlp_scratch(D, F, 5, True, dll.legacy_mlp)
        return [lambda w=w: call(dll, "ttasr_mlp_crossout_int8", x5, a5, *w[1], lay["boc"],
                                 lay["ln2_s"], lay["ln2_b"], *w[2], lay["b1"], *w[3], lay["b2"],
                                 xm, h, out, *scratch[:3], 5, D, F, *scratch[3:])
                for w in layers]

    for name, fns in (("B1", b1), ("B4", b4)):
        for tag in list(builds) + list(reversed(builds)):
            print(f"{name} R=5 cold, {tag}: {cs.time_cold_ms(fns(builds[tag])):.4f} ms per call "
                  f"(a graph over {cs.N_LAYERS} layers' weights) ({card})", flush=True)


def sdpa_yardstick(cs, card: str) -> None:
    """``scaled_dot_product_attention`` on 5 query rows and bf16 K/V of the
    dequantized cache's shape, positions >= slot masked: not the same
    function (2-4x the bytes, no quantization, no ancestry lookup)."""
    import torch
    import torch.nn.functional as F

    inp = cs.Inputs(4)
    for length, slot in cs.SELF_LENGTHS:
        q = inp.randn(5, cs.H, 1, 64, scale=0.1).to(torch.bfloat16)
        k, v = (inp.randn(5, cs.H, length, 64).to(torch.bfloat16) for _ in range(2))
        mask = (torch.arange(length, device="cuda") < slot).view(1, 1, 1, length)
        fn = (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"yardstick, not the same function: scaled_dot_product_attention on 5 rows x "
              f"{cs.H} heads, bf16 K/V of len {length} (slot {slot}): time_ms "
              f"{cs.time_ms(fn):.4f}, in a graph of 20 {cs.per_call_ms(fn):.4f}, device "
              f"{sum(device_ms(fn).values()):.4f} ms ({card})", flush=True)


def compare(cs, this, other, card: str) -> None:
    import torch

    t = torch.zeros(1, device="cuda")
    print(f"time_ms floor (a 1-element add per replay): {cs.time_ms_floor():.4f} ms; "
          f"per call in a graph of 20: {cs.per_call_ms(lambda: t.add_(1.0)):.4f} ms ({card})",
          flush=True)
    in_turns(cs, {"other": other, "this": this}, card)

    inp = cs.Inputs(2)
    x = inp.randn(5, cs.D, scale=0.5)
    out = torch.empty(5, cs.D, device="cuda")
    weights = [inp.weight(cs.D, cs.D) for _ in range(2 * cs.N_LAYERS)]
    bf16 = [w.to(torch.bfloat16) for w, _ in weights]

    def b15(dll):
        return [lambda w=w: call(dll, "ttasr_matmul_int8_partial", x, *w, out, 5, cs.D, cs.D)
                for w in weights]

    library = [lambda w=w: torch.matmul(x.to(torch.bfloat16), w) for w in bf16]
    for label, fns in (("other", b15(other)), ("this", b15(this)), ("library", library),
                       ("library", library), ("this", b15(this)), ("other", b15(other))):
        print(f"B15 cold, {label}: {cs.time_cold_ms(fns):.4f} ms per call (a graph over "
              f"{len(fns)} weights) ({card})", flush=True)
    self_cold(cs, {"other": other, "this": this}, card)
    weights_cold(cs, {"other": other, "this": this}, card)
    sdpa_yardstick(cs, card)


# ---------------------------------------------------------------------------
# --phases: %globaltimer at the kernels' phase points
# ---------------------------------------------------------------------------

PHASE_DEF = """__device__ unsigned long long g_phase[4][4096][16];
__device__ __forceinline__ void phase_mark(int kind, int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phase[kind][blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][i] = t;
  }
}

"""
# each .cu has its own g_phase (internal linkage): decoder_blocks.cu's holds
# the GEMM's and cross-attention's marks (kinds 0, 1), self_attention.cu's
# the self-attention step's (kind 2), decoder_mlp.cu's the persistent MLP
# kernel's (kind 3)
READ = """
extern "C" int ttasr_phase_clear{0}() {{
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, ttasr::g_phase);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(ttasr::g_phase)));
}}

extern "C" int ttasr_phase_read{0}(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, ttasr::g_phase, sizeof(ttasr::g_phase));
}}
"""
GEMM_PHASES = ["start", "slab requested", "prologue", "slab here", "summed", "pushed", "synced",
               "end"]
CROSS_PHASES = ["start", "rows requested", "queries", "scores", "max exchanged", "sums exchanged",
                "probabilities", "end"]
SELF_PHASES = ["start", "stage requested", "stage landed", "scores", "scores exchanged", "softmax",
               "P.V", "end"]
# per phase: the block's first unit past its wait, that unit's partial
# sums out, the phase's tiles finished (the block's finishers done)
MLP_PHASES = ["start", "first request", "wo_c started", "wo_c 1st summed", "wo_c done",
              "x' waited", "W1 1st summed", "W1 done", "h waited", "W2 1st summed", "W2 done",
              "end", "1st filled", "1st slab here", "W1 1st filled", "W2 1st filled"]
PHASE_NAMES = (GEMM_PHASES, CROSS_PHASES, SELF_PHASES, MLP_PHASES)
PHASE_WHAT = ("the last skinny GEMM", "the cross-attention", "the self-attention step",
              "the persistent MLP kernel")
# (file, text, the text with a mark): each text must occur once
MARKS = [
    ("skinny_gemm.cuh", "// The cluster barrier split in two", PHASE_DEF + "// The cluster barrier split in two"),
    ("skinny_gemm.cuh", "  const int n0 = blockIdx.x * kTileCols;\n",
     "  const int n0 = blockIdx.x * kTileCols;\n  phase_mark(0, 0);\n"),
    ("skinny_gemm.cuh", "  __syncthreads();  // no thread waits on the barrier before its init\n",
     "  __syncthreads();  // no thread waits on the barrier before its init\n  phase_mark(0, 1);\n"),
    ("skinny_gemm.cuh", "    fill_rows<P>(g.a, ln_s, ln_b,",
     "    phase_mark(0, 2);\n    fill_rows<P>(g.a, ln_s, ln_b,"),
    ("skinny_gemm.cuh", "    if (chunk == 0 && kr > 0) mbar_wait(bar, 0);\n    __syncthreads();\n",
     "    if (chunk == 0 && kr > 0) mbar_wait(bar, 0);\n    __syncthreads();\n    phase_mark(0, 3);\n"),
    ("skinny_gemm.cuh", "      const int slot = ((chunk & 1) * splits + rank)",
     "      phase_mark(0, 4);\n      const int slot = ((chunk & 1) * splits + rank)"),
    ("skinny_gemm.cuh", "    if (TEAMS == 1) {\n      cluster.sync();\n    } else {\n      __syncthreads();\n    }\n",
     "    phase_mark(0, 5);\n    if (TEAMS == 1) {\n      cluster.sync();\n    } else {\n"
     "      __syncthreads();\n    }\n    phase_mark(0, 6);\n"),
    ("skinny_gemm.cuh", "      store_out<E>(g.out, oi, v, col_scale, col_bias, resid, g.qscale);\n    }\n",
     "      store_out<E>(g.out, oi, v, col_scale, col_bias, resid, g.qscale);\n    }\n"
     "    phase_mark(0, 7);\n"),
    ("decoder_mlp.cu", "  const int n_units = *unit++;\n",
     "  const int n_units = *unit++;\n  phase_mark(3, 0);\n"),
    ("decoder_mlp.cu", "  __syncthreads();  // no thread waits on a barrier before its init\n",
     "  __syncthreads();  // no thread waits on a barrier before its init\n  phase_mark(3, 1);\n"),
    ("decoder_mlp.cu", "h_tiles_in(split, sl[2].kper, F), request_next);\n        __syncthreads();\n      }\n",
     "h_tiles_in(split, sl[2].kper, F), request_next);\n        __syncthreads();\n      }\n"
     "      if (u == u0) phase_mark(3, 2 + 3 * p);\n"),
    ("decoder_mlp.cu", "      __syncthreads();\n      if (tid == 0 && !un[4]) red_release(",
     "      if (u == u0) phase_mark(3, 3 + 3 * p);\n      __syncthreads();\n"
     "      if (tid == 0 && !un[4]) red_release("),
    ("decoder_mlp.cu", "wait_count(g.sync + kXDone, td, request_next);\n        __syncthreads();\n      }\n",
     "wait_count(g.sync + kXDone, td, request_next);\n        __syncthreads();\n      }\n"
     "      if (p == 1 && u == u0) phase_mark(3, 5);\n"),
    ("decoder_mlp.cu", "            red_release(g.sync + kHDone + j, 1);\n      }\n    }\n  }\n",
     "            red_release(g.sync + kHDone + j, 1);\n      }\n    }\n"
     "    phase_mark(3, 4 + 3 * p);\n  }\n"),
    ("decoder_mlp.cu", "    g.sync[kLeft] = 0;\n  }\n}\n", "    g.sync[kLeft] = 0;\n  }\n  phase_mark(3, 11);\n}\n"),
    ("decoder_mlp.cu", "        if (chunk == 0 && kr > 0) mbar_wait(smem_u32(bars + u), 0);\n        __syncthreads();\n",
     "        if (u == 0 && chunk == 0) phase_mark(3, 12);\n"
     "        if (u == u0 && chunk == 0 && p > 0) phase_mark(3, 12 + p + 1);\n"
     "        if (chunk == 0 && kr > 0) mbar_wait(smem_u32(bars + u), 0);\n        __syncthreads();\n"
     "        if (u == 0 && chunk == 0) phase_mark(3, 13);\n"),
    ("cross_attention.cuh", "  const float* vs_row = cvs + ((size_t)b * H + h) * S;\n",
     "  const float* vs_row = cvs + ((size_t)b * H + h) * S;\n  phase_mark(1, 0);\n"),
    ("cross_attention.cuh", "  cp_async_commit();\n  griddep_launch_dependents();\n",
     "  cp_async_commit();\n  phase_mark(1, 1);\n  griddep_launch_dependents();\n"),
    ("cross_attention.cuh", "  // pass 1: scores", "  phase_mark(1, 2);\n  // pass 1: scores"),
    ("cross_attention.cuh", "  // the softmax over the cluster", "  phase_mark(1, 3);\n  // the softmax over the cluster"),
    ("cross_attention.cuh", "[kStatMaxes + rank * kMaxBeams + r] =\n        s_stat[kStatBlock + r];\n  }\n  cluster_barrier(cluster, splits);\n",
     "[kStatMaxes + rank * kMaxBeams + r] =\n        s_stat[kStatBlock + r];\n  }\n  cluster_barrier(cluster, splits);\n  phase_mark(1, 4);\n"),
    ("cross_attention.cuh", "[kStatSums + rank * kMaxBeams + r] =\n        s_stat[kStatBlock + r];\n  }\n  cluster_barrier(cluster, splits);\n",
     "[kStatSums + rank * kMaxBeams + r] =\n        s_stat[kStatBlock + r];\n  }\n  cluster_barrier(cluster, splits);\n  phase_mark(1, 5);\n"),
    ("cross_attention.cuh", "  // pass 2: out[r, d]", "  phase_mark(1, 6);\n  // pass 2: out[r, d]"),
    ("cross_attention.cuh", "      cross[((size_t)b * K + r) * D + h * kDh + d] = v;\n    });\n  }\n",
     "      cross[((size_t)b * K + r) * D + h * kDh + d] = v;\n    });\n  }\n  phase_mark(1, 7);\n"),
    ("self_attention.cu", "  const int pad_j = a.pad[row];",
     "  phase_mark(2, 0);\n  const int pad_j = a.pad[row];"),
    ("self_attention.cu", "  issue(false);\n  issue(true);\n",
     "  issue(false);\n  issue(true);\n  phase_mark(2, 1);\n"),
    ("self_attention.cu", "  cp_async_wait_group<1>();  // K and ks\n  __syncthreads();\n",
     "  cp_async_wait_group<1>();  // K and ks\n  __syncthreads();\n  phase_mark(2, 2);\n"),
    ("self_attention.cu", "  cluster_barrier(cluster, splits);  // every block holds",
     "  phase_mark(2, 3);\n  cluster_barrier(cluster, splits);  // every block holds"),
    ("self_attention.cu", "  // the maximum, in every warp", "  phase_mark(2, 4);\n  // the maximum, in every warp"),
    ("self_attention.cu", "  // pass 2: out[d]", "  phase_mark(2, 5);\n  // pass 2: out[d]"),
    ("self_attention.cu", "    // the block's partial output into the rank",
     "    phase_mark(2, 6);\n    // the block's partial output into the rank"),
    ("self_attention.cu", "s_scale[own + 1];\n    }\n  }\n}\n",
     "s_scale[own + 1];\n    }\n  }\n  phase_mark(2, 7);\n}\n"),
]


def edited(out_dir: str, name: str, edits) -> str:
    """A copy of this checkout's csrc/ with ``edits`` (file, text, new
    text) applied; each text must occur once."""
    dst = os.path.join(out_dir, name)
    shutil.copytree(CSRC, dst)
    for fname, old, new in edits:
        path = os.path.join(dst, fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {fname} no longer holds {old[:50]!r} once")
        open(path, "w").write(text.replace(old, new))
    return dst


def instrumented(out_dir: str) -> str:
    """A copy of this checkout's csrc/ with the phase marks."""
    dst = edited(out_dir, "csrc_phases", MARKS)
    for fname, suffix in (("decoder_blocks.cu", ""), ("self_attention.cu", "_sa"),
                          ("decoder_mlp.cu", "_mlp")):
        with open(os.path.join(dst, fname), "a") as f:
            f.write(READ.format(suffix))
    return dst


def phases(cs, dll, card: str) -> None:
    import torch

    all_cases = cases(cs)
    buf = np.zeros((len(PHASE_NAMES), 4096, 16), dtype=np.uint64)
    suffixes = {"ttasr_self_attn_step": "_sa", "ttasr_mlp_crossout_int8": "_mlp",
                "ttasr_mlp_int8": "_mlp"}
    for label in ("B15 R=5 (DL=1280)", "LayerNorm GEMM R=5 (B1's entry at N=1280)", "B1 R=5",
                  "B3 B=1 K=5 int4", "B4 R=5", "B14 partial R=5", *self_cases(cs)):
        entry, _, *args = all_cases[label]
        suffix = suffixes.get(entry, "")
        clear, read = (getattr(dll, f"ttasr_phase_{op}{suffix}") for op in ("clear", "read"))
        read.argtypes = [ctypes.c_void_p]
        for _ in range(2):  # warm up, then stamp one call's blocks
            call(dll, entry, *args)
        torch.cuda.synchronize()
        if clear():
            raise RuntimeError("phase clear failed")
        call(dll, entry, *args)
        torch.cuda.synchronize()
        if read(buf.ctypes.data):
            raise RuntimeError("phase read failed")
        kinds = [k for k in range(len(PHASE_NAMES)) if buf[k, :, 0].any()]
        t0 = min(int(buf[k, buf[k, :, 0] > 0, 0].min()) for k in kinds)
        for kind in kinds:
            names = PHASE_NAMES[kind]
            rows = buf[kind, buf[kind, :, 0] > 0, :len(names)]
            marks = []
            for i, nm in enumerate(names):  # the blocks that reached the point
                t = (rows[rows[:, i] > 0, i].astype(np.int64) - t0) / 1e3
                marks.append(f"{nm} {np.median(t):.2f}/{t.max():.2f} ({len(t)})" if len(t)
                             else f"{nm} -")
            print(f"{label}, {PHASE_WHAT[kind]} ({len(rows)} blocks), us from the first "
                  "block's start, median/latest (blocks): " + ", ".join(marks) + f" ({card})",
                  flush=True)


# the four uploads of the task API's call that --server times
SERVER_UPLOADS = (("upload0", 12.0, 10), ("upload1", 16.0, 11), ("upload2", 10.0, 12),
                  ("upload3", 14.0, 13))
SERVER_RUNS = ("device lock (this checkout)", "no device lock", "TTASR_PIPELINE_GROUPS=1",
               "device lock (this checkout)")


def server_dispatch(cs, card: str) -> None:
    """The task API's call three ways on the int8 engine (``--server``)."""
    from ttasr_torch.engine.transcriber import WhisperEngine

    engine = WhisperEngine("large-v3", compute_type="int8", device="cuda")
    lock = engine._device_lock
    with tempfile.TemporaryDirectory() as tmp:
        seconds, _ = cs._write_wavs(tmp, SERVER_UPLOADS)
        paths = [os.path.join(tmp, f"{name}.wav") for name, _, _ in SERVER_UPLOADS]
        for label in SERVER_RUNS:
            if label == "no device lock":
                engine._device_lock = contextlib.nullcontext()
            if label.startswith("TTASR_PIPELINE_GROUPS"):
                os.environ["TTASR_PIPELINE_GROUPS"] = "1"
            try:
                before = dict(engine.decode_stats)
                results, groups, wall = cs._uploads(engine, paths)
            finally:
                engine._device_lock = lock
                os.environ.pop("TTASR_PIPELINE_GROUPS", None)
            failed = [r for r in results if isinstance(r, BaseException)]
            cs.check(not failed, f"{label}: {failed}")
            steps = sum(engine.decode_stats[k] - before[k]
                        for k in ("beam_steps", "greedy_steps"))
            print(f"task API call, {label}: wall {wall:.2f} s = {wall / seconds:.4f} s per "
                  f"audio second, {steps} decode steps, {1e3 * wall / steps:.2f} ms per step, "
                  f"{groups.sweeps} sweeps, {groups.overlapped} dispatches while another "
                  f"group was in flight ({card})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another copy of ttasr_torch/csrc")
    parser.add_argument("--server", action="store_true",
                        help="time the serving layer's dispatch instead (no --other)")
    parser.add_argument("--phases", action="store_true", help="print the phase timelines too")
    parser.add_argument("--encoder", action="store_true",
                        help="compare the encoder's row kernels instead")
    parser.add_argument("--mel", action="store_true", help="compare B18 (mel.cu) instead")
    parser.add_argument("--attention", action="store_true",
                        help="compare the encoder attention (B11, B6, B19) instead")
    opts = parser.parse_args()
    if not opts.server and not opts.other:
        parser.error("--other is required unless --server is given")
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ttasr_torch import resolve_device

    resolve_device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    if opts.server:
        server_dispatch(cs, card)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        if opts.mel:
            mel_routes(cs, build(os.path.abspath(opts.other), tmp, "other", MEL_SOURCES), tmp,
                       card)
            return 0
        if opts.attention:
            attention(cs, {tag: build(src, tmp, tag, ATTENTION_SOURCES) for tag, src in (
                ("other", os.path.abspath(opts.other)), ("this", CSRC))}, tmp, card)
            return 0
        if opts.encoder:
            builds = {tag: build(src, tmp, tag, ENCODER_SOURCES) for tag, src in (
                ("other", os.path.abspath(opts.other)), ("this", CSRC))}
            in_turns(cs, builds, card, make_cases=lambda dll: encoder_cases(cs))
            new_encoder_entries(cs, card)
            return 0
        this = build(CSRC, tmp, "this")
        other = build(os.path.abspath(opts.other), tmp, "other")
        compare(cs, this, other, card)
        if opts.phases:
            phases(cs, build(instrumented(tmp), tmp, "phases"), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
