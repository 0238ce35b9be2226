"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` under ``ttasr_torch/csrc/`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded through ``ctypes``.  The library goes to ``ttasr_torch/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing is
built when a module is imported: the first kernel launch calls
:func:`load_library`.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


def build() -> Path:
    """Compile the kernels unless the library for these sources and flags
    exists; return its path."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    lib = BUILD_DIR / f"libttasr_kernels_{_digest(srcs, NVCC_FLAGS)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.ttasr_encoder_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
