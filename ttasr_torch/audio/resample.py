"""Sample-rate conversion on the host (the port's copy of the host path of
``ttasr/audio/resample.py``): the port's C++ resampler
(``ttasr_torch/native``), else polyphase filtering with scipy, else a
windowed-sinc numpy filter.
"""

from __future__ import annotations

import math

import numpy as np


def _gcd_ratio(sr_from: int, sr_to: int):
    g = math.gcd(int(sr_from), int(sr_to))
    return sr_to // g, sr_from // g  # (up, down)


def resample_poly_host(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resampling on host, float32 in/out.

    Order of preference: the port's C++ library (ttasr_torch/native), scipy,
    pure-numpy windowed sinc.
    """
    if sr_from == sr_to:
        return np.asarray(audio, dtype=np.float32)
    try:
        from ttasr_torch import native

        out = native.resample(np.asarray(audio, np.float32), sr_from, sr_to)
        if out is not None:
            return out
    except Exception:  # pragma: no cover - fall through to scipy
        pass
    up, down = _gcd_ratio(sr_from, sr_to)
    try:
        from scipy.signal import resample_poly

        out = resample_poly(np.asarray(audio, dtype=np.float64), up, down)
        return out.astype(np.float32)
    except ImportError:  # pragma: no cover
        return _resample_sinc_numpy(np.asarray(audio, dtype=np.float32), up, down)


def _resample_sinc_numpy(audio: np.ndarray, up: int, down: int,
                         half_width: int = 32) -> np.ndarray:
    """Windowed-sinc polyphase fallback (Kaiser window)."""
    n_out = int(np.ceil(len(audio) * up / down))
    cutoff = min(1.0 / up, 1.0 / down)
    t_out = np.arange(n_out) * (down / up)
    idx = np.floor(t_out).astype(np.int64)
    taps = np.arange(-half_width, half_width + 1)
    src = idx[:, None] + taps[None, :]
    frac = (t_out - idx)[:, None]
    x = taps[None, :] - frac
    kernel = np.sinc(x * up * cutoff) * np.kaiser(2 * half_width + 1, 8.0)[None, :]
    kernel *= up * cutoff
    src = np.clip(src, 0, len(audio) - 1)
    return (audio[src] * kernel).sum(axis=1).astype(np.float32)
