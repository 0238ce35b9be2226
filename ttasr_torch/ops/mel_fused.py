"""Whisper log-mel in one kernel (B18): the Hopper kernel and its plain
version.

Port of ``ttasr/ops/mel_pallas.py::log_mel_spectrogram_pallas``:
audio ``(n,)`` or ``(B, n)`` float32 is padded with zeros or cut to the
30 s window (480000 samples), reflect-padded by 200, framed at hop 160
with n_fft 400, and each frame's periodic-Hann-windowed 201-bin power
spectrum projected on the Slaney mel bank; ``log10(max(mel, 1e-10))``,
then the per-window max - 8 clamp and ``(x + 4) / 4``.  Returns
``(n_mels, 3000)`` or ``(B, n_mels, 3000)`` float32.

:func:`log_mel_spectrogram_fused` launches ``ttasr_torch/csrc/mel.cu``
for CUDA tensors (framing, DFT, power, mel projection and log10 in the
kernel's own float32 FMA; the clamp and rescale after it, as the TPU
version does them after its ``pallas_call``) and runs
:func:`log_mel_spectrogram_fused_ref` for CPU tensors; it counts its
launches in ``log_mel_spectrogram_fused.launches``.  The kernel's DFT basis
and filterbank are the port's copies in :mod:`ttasr_torch.ops.mel`.  The
engine's frontend stays :func:`ttasr_torch.ops.mel.log_mel_spectrogram`,
as the JAX engine's stays ``ttasr/ops/mel.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ttasr_torch import resolve_device
from ttasr_torch.ops.mel import (
    N_FRAMES,
    N_FREQS,
    _dft_basis,
    log_mel_spectrogram,
    mel_filter_bank,
)

FREQ_PAD = 224  # the kernel's frequency columns: 201 bins, 7 per lane
MAX_MELS = 128


def log_mel_spectrogram_fused_ref(audio, n_mels: int = 80):
    """Plain version: the port's matmul frontend on float input (the path
    the JAX golden test holds the Pallas kernel against), computed in
    float64 and rounded to float32 at the end.  Float64, because the
    low-power bins near the max - 8 floor cancel in the DFT: on an H100
    the frontend's float32 cuBLAS products land up to 2.7e-4 from the
    float64 values there, the kernel's FMA chains within 7.3e-5, so only a
    plain version nearer the exact values can hold the kernel to 2e-4."""
    return log_mel_spectrogram(audio.to(torch.float32), n_mels, dtype=torch.float64)


@lru_cache(maxsize=8)
def _kernel_constants(n_mels: int, device) -> tuple:
    """(400, 224, 2) interleaved (cos, sin) with the window folded in, zero
    past bin 200, and the (201, n_mels) filterbank, on ``device``."""
    cos, sin = _dft_basis()
    basis = np.zeros((cos.shape[0], FREQ_PAD, 2), np.float32)
    basis[:, :N_FREQS, 0] = cos
    basis[:, :N_FREQS, 1] = sin
    fb = np.ascontiguousarray(mel_filter_bank(n_mels))
    return tuple(torch.from_numpy(a).to(device) for a in (basis, fb))


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

    basis, fb = _kernel_constants(n_mels, x.device)
    log_spec = torch.empty((b, n_mels, N_FRAMES), dtype=torch.float32, device=x.device)
    launch("ttasr_log_mel", x.device, x, basis, fb, log_spec, b, n, n_mels)
    log_mel_spectrogram_fused.launches += 1
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    out = (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0
    return out[0] if squeeze else out


log_mel_spectrogram_fused.launches = 0
