"""Whisper log-mel frontend on the device (port of
``ttasr/ops/mel.py::log_mel_spectrogram``).

Same design and constants as the JAX version: framing by a strided view,
the windowed 400-point real DFT as two (400, 201) matmuls, the
(201, n_mels) Slaney mel projection, log10 with the per-example max-8
clamp and (x+4)/4.  The numpy DFT basis and filterbank come from
``ttasr.ops.mel`` (jax-free).  The matmuls run in full float32: the
device helper (``ttasr_torch.resolve_device``) turns TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ttasr.ops.mel import (
    CHUNK_LENGTH,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_FREQS,
    N_SAMPLES,
    SAMPLE_RATE,
    _device_constants,
)

__all__ = ["log_mel_spectrogram", "CHUNK_LENGTH", "HOP_LENGTH", "N_FFT",
           "N_FRAMES", "N_FREQS", "N_SAMPLES", "SAMPLE_RATE"]


def _constants(n_mels: int, device) -> tuple:
    cos, sin, fb = _device_constants(n_mels)
    return tuple(torch.from_numpy(x).to(device) for x in (cos, sin, fb))


def log_mel_spectrogram(audio, n_mels: int = 80, *, pad_to_chunk: bool = True,
                        device=None):
    """Whisper log-mel features.

    Args:
      audio: numpy array or tensor, shape ``(n,)`` or ``(batch, n)``;
        int16 PCM (scaled by 1/32768 on the device) or float.
      n_mels: 80 or 128 (large-v3).
      pad_to_chunk: zero-pad / truncate to the 30 s window (480000
        samples).
      device: where numpy input goes (tensors stay where they are).

    Returns:
      ``(n_mels, 3000)`` or ``(batch, n_mels, 3000)`` float32 features.
    """
    if isinstance(audio, torch.Tensor):
        x = audio
    else:
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = a.astype(np.float32, copy=False)
        x = torch.from_numpy(np.ascontiguousarray(a))
        if device is not None:
            x = x.to(device)
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * (1.0 / 32768.0)
    else:
        x = x.to(torch.float32)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if pad_to_chunk:
        n = x.shape[-1]
        if n < N_SAMPLES:
            x = F.pad(x, (0, N_SAMPLES - n))
        elif n > N_SAMPLES:
            x = x[..., :N_SAMPLES]

    n_frames = x.shape[-1] // HOP_LENGTH  # last frame dropped, as in HF
    half = N_FFT // 2
    padded = F.pad(x[:, None], (half, half), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # (B, F, 400)

    cos, sin, fb = _constants(n_mels, x.device)
    re = torch.matmul(frames, cos)
    im = torch.matmul(frames, sin)
    power = re * re + im * im                       # (B, F, 201)
    mel = torch.matmul(power, fb)                   # (B, F, n_mels)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    out = log_spec.transpose(1, 2)                  # (B, n_mels, F)
    return out[0] if squeeze else out
