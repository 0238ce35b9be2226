"""Speech-like and non-speech audio from a seed: the synthesizer the VAD is
trained on and the recognition check transcribes (the port's copy of
``tools/train_vad.py``'s generators).

Speech: a glottal pulse train with pitch contour and jitter drives three
formant resonators, with syllabic amplitude modulation (2-8 Hz), pauses
and fricative-like noise bursts; frame labels mark where the speech
envelope is active.  Negatives: white and pink noise, hum with harmonics,
pure and vibrato tones, sustained chords, clicks, crowd babble, singing
over a chord bed and heavily reverberant speech.
"""

from __future__ import annotations

import numpy as np

from ttasr_torch.audio.vad_model import SAMPLE_RATE, WINDOW

SR = SAMPLE_RATE


def _formant_filter(x, freq, bw, sr=SR):
    """2nd-order resonator (all-pole)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    return lfilter([1.0], [1.0, -2 * r * np.cos(theta), r * r], x)


def synth_speech(rng, seconds=3.0):
    """Speech-like signal + per-frame labels."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    # pitch contour 80-300 Hz with slow wander + jitter
    f0 = rng.uniform(90, 250)
    contour = f0 * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t))
    contour *= 1 + 0.02 * rng.standard_normal(n).cumsum() / np.sqrt(np.arange(1, n + 1))
    phase = 2 * np.pi * np.cumsum(contour) / SR
    # glottal-ish pulse train: rectified+sharpened harmonic sum
    voiced = np.maximum(np.sin(phase), 0.0) ** 3
    # formants (F1-F3 random per "speaker")
    sig = np.zeros(n)
    for lo, hi, bw in ((300, 900, 80), (900, 2200, 120), (2200, 3200, 200)):
        sig += _formant_filter(voiced, rng.uniform(lo, hi), bw) * rng.uniform(0.5, 1.0)
    sig /= np.max(np.abs(sig)) + 1e-9
    # syllabic envelope: 2-8 Hz with hard pauses
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 8.0) * t + rng.uniform(0, 6)))
    env = env ** rng.uniform(1.0, 2.0)
    # utterance gating: speech bursts with silence gaps
    gate = np.zeros(n)
    pos = 0
    while pos < n:
        burst = int(SR * rng.uniform(0.4, 1.5))
        gap = int(SR * rng.uniform(0.2, 1.0))
        gate[pos : pos + burst] = 1.0
        pos += burst + gap
    # fricative bursts (unvoiced): high-passed noise in short spans
    fric = rng.standard_normal(n) * 0.15
    fric = np.diff(fric, prepend=0.0)  # crude high-pass
    fric_gate = (rng.random(n // (SR // 10) + 1) < 0.2).repeat(SR // 10)[:n]
    out = (sig * env + fric * fric_gate * env) * gate
    out = out / (np.max(np.abs(out)) + 1e-9) * rng.uniform(0.2, 0.9)
    # frame labels: envelope*gate active
    act = (env * gate)
    frames = act[: (n // WINDOW) * WINDOW].reshape(-1, WINDOW).mean(axis=1)
    labels = (frames > 0.25).astype(np.float32)
    return out.astype(np.float32), labels


def _reverb(x, rng, rt60=None):
    """Convolve with a synthetic exponentially-decaying noise IR."""
    from scipy.signal import fftconvolve

    rt60 = rt60 if rt60 is not None else rng.uniform(0.15, 0.6)
    ir_len = int(SR * rt60)
    ir = rng.standard_normal(ir_len) * np.exp(
        -6.9 * np.arange(ir_len) / ir_len)  # -60 dB at rt60
    ir[0] = 1.0  # direct path
    out = fftconvolve(x, ir)[: len(x)]
    return out / (np.max(np.abs(out)) + 1e-9) * np.max(np.abs(x))


def synth_babble(rng, seconds=3.0, n_speakers=6):
    """Crowd babble: many overlapped speakers lose the syllabic
    structure a VAD keys on — the classic hard negative (VERDICT
    round-2 #9).  Heavy reverb smears it further."""
    n = int(SR * seconds)
    out = np.zeros(n)
    for _ in range(n_speakers):
        sp, _ = synth_speech(rng, seconds)
        shift = rng.integers(0, n // 2)
        out += np.roll(sp, shift) * rng.uniform(0.4, 1.0)
    out = _reverb(out, rng, rt60=rng.uniform(0.4, 1.0))
    return (out / (np.max(np.abs(out)) + 1e-9)
            * rng.uniform(0.1, 0.6)).astype(np.float32)


def synth_vocal_music(rng, seconds=3.0):
    """Singing-like negative: a glottal+formant source on a musical
    pitch grid with vibrato and SUSTAINED envelope (no syllabic gating),
    over a chord bed — spectrally speech-like, temporally music."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    # melody: semitone-grid notes, 0.4-1 s each, with vibrato
    root = rng.uniform(150, 350)
    f0 = np.empty(n)
    pos = 0
    while pos < n:
        dur = int(SR * rng.uniform(0.4, 1.0))
        note = root * 2 ** (rng.integers(-5, 8) / 12.0)
        f0[pos : pos + dur] = note
        pos += dur
    f0 = f0[:n] * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = np.maximum(np.sin(phase), 0.0) ** 3
    sig = np.zeros(n)
    for lo, hi, bw in ((300, 900, 80), (900, 2200, 120), (2200, 3200, 200)):
        sig += _formant_filter(voiced, rng.uniform(lo, hi), bw) \
            * rng.uniform(0.5, 1.0)
    sig /= np.max(np.abs(sig)) + 1e-9
    sig *= 0.7 + 0.3 * np.sin(2 * np.pi * 0.4 * t)  # slow swell, no pauses
    # chord accompaniment
    chord = np.zeros(n)
    for ratio in (1.0, 1.5, 2.0):
        chord += np.sin(2 * np.pi * root / 2 * ratio * t + rng.uniform(0, 6))
    chord /= np.max(np.abs(chord)) + 1e-9
    out = sig + 0.5 * chord
    return (out / (np.max(np.abs(out)) + 1e-9)
            * rng.uniform(0.1, 0.6)).astype(np.float32)


def synth_negative(rng, seconds=3.0, kind=None):
    """Non-speech signal + zero labels."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    kind = rng.integers(0, 9) if kind is None else kind
    if kind == 6:    # babble (crowd)
        return synth_babble(rng, seconds), np.zeros(n // WINDOW, np.float32)
    if kind == 7:    # vocal music
        return synth_vocal_music(rng, seconds), np.zeros(
            n // WINDOW, np.float32)
    if kind == 8:    # cathedral-wash reverberant speech (unintelligible
        # mush; MILD reverb on positives stays labeled speech, see
        # make_example)
        sp, _ = synth_speech(rng, seconds)
        out = _reverb(sp, rng, rt60=rng.uniform(2.0, 4.0))
        out = (out / (np.max(np.abs(out)) + 1e-9)
               * rng.uniform(0.1, 0.5)).astype(np.float32)
        return out, np.zeros(n // WINDOW, np.float32)
    if kind == 0:    # white noise
        out = rng.standard_normal(n) * rng.uniform(0.05, 0.5)
    elif kind == 1:  # pink-ish noise
        w = rng.standard_normal(n)
        out = np.cumsum(w) / np.sqrt(np.arange(1, n + 1))
        out = out / (np.max(np.abs(out)) + 1e-9) * rng.uniform(0.1, 0.6)
    elif kind == 2:  # hum + harmonics
        f = rng.choice([50.0, 60.0])
        out = sum(np.sin(2 * np.pi * f * k * t) / k for k in range(1, 6))
        out = out / np.max(np.abs(out)) * rng.uniform(0.1, 0.5)
    elif kind == 3:  # pure/vibrato tone
        f = rng.uniform(200, 2000)
        vib = 1 + 0.01 * np.sin(2 * np.pi * 5.5 * t)
        out = np.sin(2 * np.pi * f * vib * t) * rng.uniform(0.1, 0.6)
    elif kind == 4:  # music-like sustained chord (harmonic, no syllabic AM)
        root = rng.uniform(110, 440)
        out = np.zeros(n)
        for ratio in (1.0, 1.25, 1.5, 2.0):
            for h in range(1, 4):
                out += np.sin(2 * np.pi * root * ratio * h * t + rng.uniform(0, 6)) / h
        out = out / np.max(np.abs(out)) * rng.uniform(0.1, 0.6)
        out *= 0.8 + 0.2 * np.sin(2 * np.pi * 0.3 * t)  # slow swell only
    else:            # clicks over silence
        out = np.zeros(n)
        for _ in range(rng.integers(2, 8)):
            p = rng.integers(0, n - 100)
            out[p : p + 50] = rng.standard_normal(50) * 0.8
    labels = np.zeros(n // WINDOW, np.float32)
    return out.astype(np.float32), labels


def make_example(rng, seconds=3.0):
    """Speech at random SNR over a negative background, or pure negative.

    1/3 of positives get mild room reverb (rt60 0.15-0.5 s) with labels
    kept — real rooms must not gate speech away (the VAD fronts every
    default inference path)."""
    if rng.random() < 0.55:
        sp, lab = synth_speech(rng, seconds)
        if rng.random() < 0.33:
            sp = _reverb(sp, rng, rt60=rng.uniform(0.15, 0.5)).astype(
                np.float32)
        bg, _ = synth_negative(rng, seconds)
        snr_db = rng.uniform(0, 30)
        sp_pow = np.mean(sp ** 2) + 1e-9
        bg_pow = np.mean(bg ** 2) + 1e-9
        bg = bg * np.sqrt(sp_pow / bg_pow / (10 ** (snr_db / 10)))
        return (sp + bg).astype(np.float32), lab
    return synth_negative(rng, seconds)


def _auc(labels, scores):
    """Frame-level ROC AUC (rank statistic, no sklearn)."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
    ranks = np.empty(len(order))
    ranks[order] = np.arange(1, len(order) + 1)
    r_pos = ranks[len(neg):].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))
