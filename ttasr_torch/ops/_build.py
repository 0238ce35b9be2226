"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` under ``ttasr_torch/csrc/`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into an object file, all sources at once in parallel
processes, and the objects link into one shared library with a plain C
interface, loaded through ``ctypes``.  The library goes to
``ttasr_torch/_build/`` (listed in ``.gitignore``), named by a hash of the
sources, the shared ``*.cuh`` headers and the flags, so a changed source
rebuilds and an unchanged one loads at once.  Nothing is built when a
module is imported: the first kernel launch calls :func:`load_library`.

:data:`ARGTYPES` declares every C entry point: pointers and the stream are
``c_void_p``, ints ``c_int``, floats ``c_float``.  Each entry point launches on the stream it
is given and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0.

Threads may launch at once (the serving layer decodes two groups from two
executor threads): :func:`launch` holds a lock around the C call, whose
host side keeps per-process state (the shared-memory limit each kernel was
last granted), and every wrapper counts its launches with
:func:`count_launch`, a read-modify-write under a lock of its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# entry point -> argtypes, in the order of the C signature
ARGTYPES = {
    # q, k, v, scratch (float32 inputs' tf32 planes), out; B, T, D, t_real,
    # dtype; stream
    "ttasr_encoder_attention": [_P] * 5 + [_I] * 5 + [_P],
    # qkv, scratch, out; B, T, D, t_real, dtype; stream
    "ttasr_encoder_attention_qkv": [_P] * 3 + [_I] * 5 + [_P],
    # q, k, v, scratch (float32 inputs rounded to bf16), out; B, T, D,
    # dtype; stream
    "ttasr_encoder_self_attention": [_P] * 5 + [_I] * 4 + [_P],
    # x, twiddles, window, indptr, first, weights, out, tile_max; B, n,
    # n_mels, nnz; stream
    "ttasr_log_mel": [_P] * 8 + [_I] * 4 + [_P],
    # out, tile_max; B, n_mels; stream
    "ttasr_log_mel_tail": [_P] * 2 + [_I] * 2 + [_P],
    # x, ln_s, ln_b, codes, scales; rows, D, vec_bf16 (bits 0, 1, 2: b,
    # ln_s, ln_b are bf16, else f32); stream
    "ttasr_ln_quant": [_P] * 5 + [_I] * 3 + [_P],
    # x, y, ln_s, ln_b, resid, codes, scales; rows, D, vec_bf16; stream
    "ttasr_add_ln_quant": [_P] * 7 + [_I] * 3 + [_P],
    # h, codes, scales; rows, F; stream
    "ttasr_gelu_quant": [_P] * 3 + [_I] * 2 + [_P],
    # x, codes, scales; rows, D; stream
    "ttasr_quant_only": [_P] * 3 + [_I] * 2 + [_P],
    # acc, xs, w_scale, b (NULL: none), codes, scales; rows, F, vec_bf16;
    # stream
    "ttasr_gelu_quant_acc": [_P] * 6 + [_I] * 3 + [_P],
    # x, acc, xs, w_scale, b (NULL: none), ln_s, ln_b, resid, codes, scales;
    # rows, D, vec_bf16; stream
    "ttasr_ln_quant_acc": [_P] * 10 + [_I] * 3 + [_P],
    # x, acc, xs, w_scale, b (NULL: none), ln_s, ln_b, resid, codes, scales;
    # rows, D, vec_bf16; stream
    "ttasr_add_ln_quant_acc": [_P] * 10 + [_I] * 3 + [_P],
    # acc, xs, w_scale, b (NULL: none), out; rows, W, q_cols; q_scale;
    # vec_bf16; stream
    "ttasr_qkv_epilogue_acc": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    # x, ln_s, ln_b, w, w_scale, bias, out; R, D, M; stream
    "ttasr_qkv_int8": [_P] * 7 + [_I] * 3 + [_P],
    # x, attn, wo, wo_s, bo, lnc_s, lnc_b, wqc, wqc_s, bqc, xo, qc; R, D, DC;
    # stream
    "ttasr_attnout_ln_q": [_P] * 12 + [_I] * 3 + [_P],
    # q, ck, cks, cv, cvs, out; B, K, D, S, s_real, packed; stream
    "ttasr_cross_attention_int8": [_P] * 6 + [_I] * 6 + [_P],
    # k, v, ks, vs, idx, out_k, out_v, out_ks, out_vs; L, BK, kv_row_bytes,
    # sc_row_bytes; stream
    "ttasr_gather_cache_rows": [_P] * 9 + [_I] * 4 + [_P],
    # x, attn, wo, wo_s, bo, lnc_s, lnc_b, wqc, wqc_s, bqc, ck, cks, cv, cvs,
    # xo, qc (scratch), cross; B, K, D, DC, S, s_real, packed; stream
    "ttasr_attnout_cross_int8": [_P] * 17 + [_I] * 7 + [_P],
    # x, w, w_scale, out; R, DL, M; stream
    "ttasr_matmul_int8_partial": [_P] * 4 + [_I] * 3 + [_P],
    # xo, lnc_s, lnc_b, wqc, wqc_s, bqc, ck, cks, cv, cvs, qc (scratch),
    # cross; B, K, D, DC, S, s_real, packed; stream
    "ttasr_ln_q_cross_int8": [_P] * 12 + [_I] * 7 + [_P],
    # x, ln_s, ln_b, w1, w1_s, b1, w2, w2_s, b2, h (scratch), out, part
    # (scratch), sync, sched; R, D, F, partial, n_blocks, max_units,
    # weight_bytes, part_numel, sync_numel; stream
    "ttasr_mlp_int8": [_P] * 14 + [_I] * 9 + [_P],
    # x, cross, woc, woc_s, boc, ln_s, ln_b, w1, w1_s, b1, w2, w2_s, b2,
    # x_mid (scratch), h (scratch), out, part (scratch), sync, sched; R, D,
    # F, n_blocks, max_units, weight_bytes, part_numel, sync_numel; stream
    "ttasr_mlp_crossout_int8": [_P] * 19 + [_I] * 8 + [_P],
    # qkv, k, ks, v, vs, anc (NULL = own row), pad, attn, k_new, ks_new,
    # v_new, vs_new; B, K, H, len, HP, slot, int4; stream
    "ttasr_self_attn_step": [_P] * 12 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(srcs, flags) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless the library for these sources and flags
    exists; return its path."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    lib = BUILD_DIR / f"libttasr_kernels_{_digest(srcs + headers, NVCC_FLAGS)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(srcs, objs)])
    tmp = lib.with_suffix(f".{tag}")
    _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process,
    with every entry point's argtypes registered."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; tensors
    pass as their data pointers, None as NULL.  Raises when the launch
    was refused."""
    import torch

    lib = load_library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device), _LAUNCH_LOCK:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*c_args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")


_LAUNCH_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` to ``fn.launches`` under a lock: two threads' ``+= 1``
    on the same attribute can otherwise lose one."""
    with _COUNT_LOCK:
        fn.launches += n
