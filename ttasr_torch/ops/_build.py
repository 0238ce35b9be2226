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
``c_void_p``, ints ``c_int``.  Each entry point launches on the stream it
is given and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int

# entry point -> argtypes, in the order of the C signature
ARGTYPES = {
    # q, k, v, out; B, T, D, t_real, dtype; stream
    "ttasr_encoder_attention": [_P] * 4 + [_I] * 5 + [_P],
    # x, ln_s, ln_b, w, w_scale, bias, out; R, D, M; stream
    "ttasr_qkv_int8": [_P] * 7 + [_I] * 3 + [_P],
    # x, attn, wo, wo_s, bo, lnc_s, lnc_b, wqc, wqc_s, bqc, ck, cks, cv, cvs,
    # xo, qc (scratch), cross; B, K, D, S, s_real, packed; stream
    "ttasr_attnout_cross_int8": [_P] * 17 + [_I] * 6 + [_P],
    # x, cross, woc, woc_s, boc, ln_s, ln_b, w1, w1_s, b1, w2, w2_s, b2,
    # x_mid (scratch), h (scratch), out; R, D, F; stream
    "ttasr_mlp_crossout_int8": [_P] * 16 + [_I] * 3 + [_P],
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
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*c_args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
