"""Whisper log-mel frontend on the device (port of
``ttasr/ops/mel.py::log_mel_spectrogram``).

Same design and constants as the JAX version: framing by a strided view,
the windowed 400-point real DFT as two (400, 201) matmuls, the
(201, n_mels) Slaney mel projection, log10 with the per-example max-8
clamp and (x+4)/4.  The constants, the numpy DFT basis and the Slaney
filterbank are the port's copies of those in ``ttasr/ops/mel.py``.  The
matmuls run in full float32: the device helper
(``ttasr_torch.resolve_device``) turns TF32 off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per window
N_FREQS = N_FFT // 2 + 1  # 201 rFFT bins

__all__ = ["log_mel_spectrogram", "CHUNK_LENGTH", "HOP_LENGTH", "N_FFT",
           "N_FRAMES", "N_FREQS", "N_SAMPLES", "SAMPLE_RATE"]


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale mel: linear below 1 kHz, log above."""
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=4)
def mel_filter_bank(n_mels: int = 80, n_freqs: int = N_FREQS,
                    sample_rate: int = SAMPLE_RATE,
                    f_min: float = 0.0, f_max: float = 8000.0) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_freqs, n_mels)."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(f_min)), _hz_to_mel_slaney(np.array(f_max)),
        n_mels + 2,
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels+2)
    lower = -slopes[:, :-2] / fdiff[None, :-1]
    upper = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney energy normalization.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=2)
def _dft_basis(n_fft: int = N_FFT):
    """Windowed real-DFT basis: returns (cos, sin) each (n_fft, n_freqs)."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freqs)[None, :]
    angle = -2.0 * np.pi * k * f / n_fft
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann
    cos = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos, sin


@lru_cache(maxsize=4)
def _device_constants(n_mels: int):
    cos, sin = _dft_basis()
    return cos, sin, mel_filter_bank(n_mels)


@lru_cache(maxsize=8)
def _constants(n_mels: int, device) -> tuple:
    """The constants on ``device``, copied there once (a copy from host
    memory inside a CUDA graph capture would fail)."""
    cos, sin, fb = _device_constants(n_mels)
    return tuple(torch.from_numpy(x).to(device) for x in (cos, sin, fb))


def log_mel_spectrogram(audio, n_mels: int = 80, *, pad_to_chunk: bool = True,
                        device=None, dtype=torch.float32):
    """Whisper log-mel features.

    Args:
      audio: numpy array or tensor, shape ``(n,)`` or ``(batch, n)``;
        int16 PCM (scaled by 1/32768 on the device) or float.
      n_mels: 80 or 128 (large-v3).
      pad_to_chunk: zero-pad / truncate to the 30 s window (480000
        samples).
      device: where numpy input goes (tensors stay where they are).
      dtype: the arithmetic's type; float64 gives the fused kernel's
        plain version (``ops/mel_fused.py``) its reference precision.

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
        x = x.to(dtype) * (1.0 / 32768.0)
    else:
        x = x.to(dtype)
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

    cos, sin, fb = (c.to(dtype) for c in _constants(n_mels, x.device))
    re = torch.matmul(frames, cos)
    im = torch.matmul(frames, sin)
    power = re * re + im * im                       # (B, F, 201)
    mel = torch.matmul(power, fb)                   # (B, F, n_mels)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    out = log_spec.transpose(1, 2).to(torch.float32)  # (B, n_mels, F)
    return out[0] if squeeze else out
