"""Learned voice-activity model (the port of ``ttasr/audio/vad_model.py``):
the numpy inference half that serves ``vad_filter=True``, and the torch
forward and log-mel that ``ttasr_torch/tools/train_vad.py`` trains through
(the JAX package's ``_forward`` and ``log_mel_frames``).

Architecture: log-mel(64) -> per-utterance mean/var norm ->
conv1d(64->32,k5) -> relu -> conv1d(32->32,k5,dil2) -> relu ->
conv1d(32->1,k1) -> sigmoid.  ~16k params, receptive field ~13 frames
(~0.4 s).  The weights are the port's own copy,
``ttasr_torch/audio/data/vad_weights.npz``.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np

SAMPLE_RATE = 16000
WINDOW = 512          # 32 ms hop == frame (Silero v5 granularity)
N_FFT = 512
N_MELS = 64

_WEIGHTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "vad_weights.npz")


@functools.lru_cache(maxsize=1)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filterbank (n_mels, n_fft//2+1)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmin, fmax = 0.0, sr / 2
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c == l:
            c += 1
        if r == c:
            r += 1
        fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


def init_vad_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """He-initialised weights in the shipped layout: conv kernels (K, Cin,
    Cout), as the JAX package's ``WIO``."""
    rng = np.random.default_rng(seed)

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32
        )

    return {
        "w1": he((5, N_MELS, 32), 5 * N_MELS), "b1": np.zeros(32, np.float32),
        "w2": he((5, 32, 32), 5 * 32), "b2": np.zeros(32, np.float32),
        "w3": he((1, 32, 1), 32), "b3": np.zeros(1, np.float32),
    }


def forward(params, logmel):
    """logmel (T, N_MELS) or (B, T, N_MELS) tensor -> speech probability
    (T,) or (B, T), each utterance normalised on its own.  ``params``:
    tensors in the shipped (K, Cin, Cout) layout, on logmel's device."""
    import torch
    import torch.nn.functional as F

    x = logmel[None] if logmel.dim() == 2 else logmel
    # per-utterance normalization (jnp.std: ddof 0)
    mu = x.mean(dim=1, keepdim=True)
    sd = x.std(dim=1, keepdim=True, correction=0) + 1e-5
    x = ((x - mu) / sd).transpose(1, 2)  # (B, C, T)

    def conv(x, w, b, dilation=1):
        return F.conv1d(x, w.permute(2, 1, 0), b, dilation=dilation,
                        padding=dilation * (w.shape[0] // 2))

    x = torch.relu(conv(x, params["w1"], params["b1"]))
    x = torch.relu(conv(x, params["w2"], params["b2"], dilation=2))
    x = conv(x, params["w3"], params["b3"])
    probs = torch.sigmoid(x[:, 0])
    return probs[0] if logmel.dim() == 2 else probs


def log_mel_frames(audio, fb):
    """audio (..., n * WINDOW) tensor -> log-mel (..., n, N_MELS): a
    symmetric Hann window (``np.hanning``) and a 512-point real FFT per
    512-sample frame, power through the mel bank ``fb`` (N_MELS, 257)."""
    import torch

    n = audio.shape[-1] // WINDOW
    frames = audio[..., : n * WINDOW].reshape(*audio.shape[:-1], n, WINDOW)
    win = torch.from_numpy(np.hanning(WINDOW).astype(np.float32)).to(audio.device)
    spec = torch.fft.rfft(frames * win, n=N_FFT).abs() ** 2
    mel = spec @ torch.as_tensor(fb, device=audio.device).T
    return torch.log(mel + 1e-8)


@functools.lru_cache(maxsize=1)
def _load_weights() -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(_WEIGHTS_FILE):
        return None
    with np.load(_WEIGHTS_FILE) as z:
        return {k: z[k] for k in z.files}


def _conv1d_np(x, w, b, dilation=1):
    """x (T, Cin), w (K, Cin, Cout), 'same' padding.  K is 3-5 taps and
    T a few hundred frames — a tap loop is microseconds."""
    k = w.shape[0]
    pad = dilation * (k // 2)
    xp = np.pad(x, ((pad, pad), (0, 0)))
    t = x.shape[0]
    out = np.broadcast_to(b, (t, w.shape[2])).copy()
    for i in range(k):
        out += xp[i * dilation : i * dilation + t] @ w[i]
    return out


def _forward_np(params, logmel):
    """logmel (T, N_MELS) -> speech prob (T,)."""
    mu = logmel.mean(axis=0, keepdims=True)
    sd = logmel.std(axis=0, keepdims=True) + 1e-5
    x = (logmel - mu) / sd
    x = np.maximum(_conv1d_np(x, params["w1"], params["b1"]), 0.0)
    x = np.maximum(_conv1d_np(x, params["w2"], params["b2"], dilation=2), 0.0)
    x = _conv1d_np(x, params["w3"], params["b3"])
    return 1.0 / (1.0 + np.exp(-x[:, 0]))


def _log_mel_frames_np(audio, fb):
    n = audio.shape[0] // WINDOW
    frames = audio[: n * WINDOW].reshape(n, WINDOW)
    win = np.hanning(WINDOW).astype(np.float32)
    spec = np.abs(np.fft.rfft(frames * win, n=N_FFT)) ** 2
    return np.log(spec @ fb.T + 1e-8).astype(np.float32)


def vad_probabilities(audio: np.ndarray) -> Optional[np.ndarray]:
    """Per-frame speech probability from the learned model.

    Returns None when the weights file is absent (callers fall back to
    the energy heuristic).
    """
    params = _load_weights()
    if params is None:
        return None
    if len(audio) < WINDOW:
        return np.zeros((0,), np.float32)
    if audio.dtype == np.int16:  # raw PCM16 master: scale to [-1, 1]
        audio = audio.astype(np.float32) / 32768.0
    logmel = _log_mel_frames_np(np.asarray(audio, np.float32),
                                mel_filterbank())
    return _forward_np(params, logmel).astype(np.float32)
