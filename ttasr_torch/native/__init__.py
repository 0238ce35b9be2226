"""ctypes bindings for the port's C++ host helper library (port of
``ttasr/native/__init__.py``).

``ttasr_native.cpp`` (a copy of the JAX package's source) is built with
``g++`` at first use into ``ttasr_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once; the JAX package's
library is never loaded.  Every entry point returns None when the library
cannot be built (no ``g++``, a failed build), and its callers take their
pure-Python/numpy path: this is host code for host-side hot loops (ingest
resampling, corpus CER), not a device kernel.  :func:`status` says which
library was loaded, or why none was.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("ttasr_native.cpp")
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libttasr_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library unless it exists; return its path.  Raises
    RuntimeError without ``g++`` or when the compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is not built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@lru_cache(maxsize=1)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None), or (None, the reason it is absent)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        return None, str(exc)
    lib.ttasr_pcm16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ttasr_pcm16_to_f32.restype = None
    lib.ttasr_f32_to_pcm16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.ttasr_f32_to_pcm16.restype = None
    lib.ttasr_resample_out_len.restype = ctypes.c_int64
    lib.ttasr_resample_out_len.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ttasr_resample.restype = ctypes.c_int64
    lib.ttasr_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.ttasr_levenshtein_u32.restype = ctypes.c_int64
    lib.ttasr_levenshtein_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def status() -> dict:
    """Whether the library loaded: its path, the source it was built from
    and the compiler, or the reason it is absent."""
    lib, error = _load()
    out = {"built": lib is not None, "source": str(SOURCE), "compiler": "g++"}
    if lib is None:
        out["error"] = error
    else:
        out["library"] = str(library_path())
    return out


def resample(audio: np.ndarray, sr_from: int, sr_to: int,
             half_width: int = 32) -> Optional[np.ndarray]:
    """Native polyphase resample; None when the library isn't built."""
    lib = _load()[0]
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    n_out = lib.ttasr_resample_out_len(len(audio), sr_from, sr_to)
    out = np.empty(n_out, np.float32)
    produced = lib.ttasr_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio),
        sr_from, sr_to,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), half_width,
    )
    return out[:produced]


def levenshtein(a: str, b: str) -> Optional[int]:
    """Native Levenshtein over codepoints; None when not built."""
    lib = _load()[0]
    if lib is None:
        return None
    arr_a = np.frombuffer(a.encode("utf-32-le"), dtype=np.uint32)
    arr_b = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    return int(lib.ttasr_levenshtein_u32(
        arr_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(arr_a),
        arr_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(arr_b),
    ))


def pcm16_to_f32(data: bytes) -> Optional[np.ndarray]:
    lib = _load()[0]
    if lib is None:
        return None
    pcm = np.frombuffer(data, dtype=np.int16)
    out = np.empty(len(pcm), np.float32)
    lib.ttasr_pcm16_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(pcm),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
