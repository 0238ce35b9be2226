"""Whisper log-mel in one kernel (B18): the Hopper kernels and their plain
version.

Port of ``ttasr/ops/mel_pallas.py::log_mel_spectrogram_pallas``:
audio ``(n,)`` or ``(B, n)`` float32 is padded with zeros or cut to the
30 s window (480000 samples), reflect-padded by 200, framed at hop 160
with n_fft 400, and each frame's periodic-Hann-windowed 201-bin power
spectrum projected on the Slaney mel bank; ``log10(max(mel, 1e-10))``,
then the per-window max - 8 clamp and ``(x + 4) / 4``.  Returns
``(n_mels, 3000)`` or ``(B, n_mels, 3000)`` float32.

:func:`log_mel_spectrogram_fused` launches the two kernels of
``ttasr_torch/csrc/mel.cu`` for CUDA tensors and runs
:func:`log_mel_spectrogram_fused_ref` for CPU tensors.  The first kernel
computes each frame's 400-point real transform as a 200-point complex FFT
of the packed pairs ``x[2n] + i x[2n+1]`` (radix 8, then 5 x 5, and the
split step, in float64), the power, the mel projection over the
bank's nonzeros (CSR) and log10, and writes one max per tile of frames; the second reduces each
window's max from those and applies the clamp and rescale in place.  No
torch op runs on the output.  The wrapper counts both launches in
``log_mel_spectrogram_fused.launches``.  Its constants are built here on
the host: the float64 twiddles, the window (rounded once to float32: the
one the port's DFT basis in :mod:`ttasr_torch.ops.mel` folds in) and the
CSR form of :func:`ttasr_torch.ops.mel.mel_filter_bank`.  The engine's
frontend stays :func:`ttasr_torch.ops.mel.log_mel_spectrogram`, as the JAX
engine's stays ``ttasr/ops/mel.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ttasr_torch import resolve_device
from ttasr_torch.ops._build import count_launch
from ttasr_torch.ops.mel import (
    N_FFT,
    N_FRAMES,
    log_mel_spectrogram,
    mel_filter_bank,
)

N_FFT_HALF = N_FFT // 2  # 200: the complex FFT's length
TILE_FRAMES = 16  # frames per tile of the first kernel (mel.cu kFrames)
TILES = -(-N_FRAMES // TILE_FRAMES)  # tiles per window, each with its max
MAX_MELS = 128
MAX_NNZ = 2 * (N_FFT_HALF + 1)  # each bin lies in at most two triangles


def log_mel_spectrogram_fused_ref(audio, n_mels: int = 80):
    """Plain version: the port's matmul frontend on float input (the path
    the JAX golden test holds the Pallas kernel against), computed in
    float64 and rounded to float32 at the end.  Float64, because the
    low-power bins near the max - 8 floor cancel in the transform: on an
    H100 the frontend's float32 cuBLAS products land up to 2.7e-4 from the
    float64 values there, more than the 2e-4 contract."""
    return log_mel_spectrogram(audio.to(torch.float32), n_mels, dtype=torch.float64)


@lru_cache(maxsize=1)
def fft_tables() -> tuple:
    """(twiddles (301, 2) float64, window (400,) float32).  Rows 0-199 of
    the twiddles are W_200^e = exp(-2 pi i e / 200) as (cos, -sin), which
    also give the radix-8 and radix-5 butterflies' constants (e = 25, 40,
    80); rows 200-300 are W_400^k, k = 0..100, for the split step (past
    100 the kernel takes W_400^k = -conj(W_400^(200 - k))).  Float64, as the
    kernel's transform is.  The window is the periodic Hann window, rounded
    once to float32."""
    ang = np.concatenate([2.0 * np.pi * np.arange(N_FFT_HALF) / N_FFT_HALF,
                          2.0 * np.pi * np.arange(N_FFT_HALF // 2 + 1) / N_FFT])
    twiddles = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    return twiddles, window


@lru_cache(maxsize=4)
def mel_csr(n_mels: int) -> tuple:
    """The mel bank as CSR over mels whose nonzeros are runs of bins:
    (indptr (n_mels + 1,), first bin (n_mels,) int32, weights (nnz,)
    float32), mel m's weights those of bins first[m], first[m] + 1, ...
    (the float32 values of :func:`mel_filter_bank`).  A triangle's
    nonzeros are one run; raises if a bank's are not."""
    fb = mel_filter_bank(n_mels)  # (201, n_mels)
    mels, bins = np.nonzero(fb.T)  # row-major: by mel, then bin
    indptr = np.searchsorted(mels, np.arange(n_mels + 1))
    first = np.zeros(n_mels, np.int64)
    for m in range(n_mels):
        run = bins[indptr[m]:indptr[m + 1]]
        if run.size:
            if (np.diff(run) != 1).any():
                raise ValueError(f"mel {m}'s nonzeros are not one run of bins")
            first[m] = run[0]
    return (indptr.astype(np.int32), first.astype(np.int32),
            fb[bins, mels].astype(np.float32))


@lru_cache(maxsize=8)
def _kernel_constants(n_mels: int, device) -> tuple:
    """The twiddles, window and CSR bank on ``device``, copied once (a copy
    from host memory inside a CUDA graph capture would fail)."""
    arrays = (*fft_tables(), *mel_csr(n_mels))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def log_mel_spectrogram_fused(audio, n_mels: int = 80):
    """B18; see the module docstring.  ``audio``: a tensor (which stays on
    its device) or an array (moved to the card)."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(
            resolve_device("cuda"))
    if audio.dim() not in (1, 2) or audio.shape[-1] < 1:
        raise ValueError(f"audio must be (n,) or (B, n): {tuple(audio.shape)}")
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"n_mels={n_mels} outside [1, {MAX_MELS}]")
    if audio.device.type == "cpu":
        return log_mel_spectrogram_fused_ref(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"no kernel for device {audio.device}")
    x = audio.to(torch.float32)
    squeeze = x.dim() == 1
    x = x.reshape(-1, x.shape[-1]).contiguous()
    b, n = x.shape
    if b * n >= 2 ** 31:
        raise ValueError("audio too large for the kernel's int indexing")
    from ttasr_torch.ops._build import launch

    twiddles, window, indptr, first, weights = _kernel_constants(n_mels, x.device)
    out = torch.empty((b, n_mels, N_FRAMES), dtype=torch.float32, device=x.device)
    tile_max = torch.empty((b, TILES), dtype=torch.float32, device=x.device)
    launch("ttasr_log_mel", x.device, x, twiddles, window, indptr, first, weights,
           out, tile_max, b, n, n_mels, weights.numel())
    count_launch(log_mel_spectrogram_fused)
    launch("ttasr_log_mel_tail", x.device, out, tile_max, b, n_mels)
    count_launch(log_mel_spectrogram_fused)
    return out[0] if squeeze else out


log_mel_spectrogram_fused.launches = 0
