"""B18's Hopper design (``ttasr_torch/csrc/mel.cu``) emulated on the CPU.

The kernel computes each frame's 400-point real transform as a 200-point
complex FFT of the packed pairs ``z[n] = x[2n] + i x[2n+1]`` (a radix-8
stage with the W_200 twiddles, stored as float32, then a 25-point
transform as two radix-5 stages, in float64), a float64 split step to bins
0..200, the power,
the float32 mel projection over the bank's CSR nonzeros in bin order,
log10, and the window's max - 8 clamp and rescale.  :func:`emulate`
repeats that order in numpy (the same butterflies, index maps and
precisions, the host's float32 twiddle table
``mel_fused.fft_tables``, the CSR bank ``mel_fused.mel_csr``), and the
tests hold it to the Pallas ``log_mel_spectrogram_pallas`` in interpret
mode and to the float64 plain version at 2e-4 absolute (the Pallas
kernel's contract), on the cases of ``tests/test_torch_mel_fused.py``,
a 30 s clip whose loud onset puts the max - 8 floor in play, and a loud
tone over faint noise.  The
kernel itself is held to the plain version on the card by
``chip_smoke.py``.  The CSR bank rebuilds the dense bank bit for bit, the
float64 twiddles hold to closed forms within an ulp, and a mutation of the design
(a twiddle's sign flipped, the split step's conjugate dropped) fails the
tolerance.  About 12 s on one worker.
"""

import numpy as np
import pytest
import torch

from ttasr.ops.mel_pallas import log_mel_spectrogram_pallas
from ttasr_torch.ops import mel_fused as t_mel
from ttasr_torch.ops.mel import N_FRAMES, N_SAMPLES, mel_filter_bank

TOL = 2e-4
F32 = np.float32


def _tone(n):
    rng = np.random.default_rng(1)
    return (0.2 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _noise(seed, shape):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _onset():
    """30 s: faint noise, then at 12 s a loud chirp over it: a fifth of
    the window's values sit at the max - 8 floor, most just above it."""
    rng = np.random.default_rng(5)
    t = np.arange(N_SAMPLES) / 16000
    x = 1e-3 * rng.standard_normal(N_SAMPLES)
    on = t >= 12.0
    x[on] += 0.8 * np.sin(2 * np.pi * (200 + 150 * (t[on] - 12.0)) * t[on])
    return x.astype(np.float32)


def _tone_over_noise():
    """30 s of a loud 7 kHz tone over faint noise: the quiet bins near the
    floor share the FFT's packed pairs with the tone's mirror bins."""
    rng = np.random.default_rng(7)
    t = np.arange(N_SAMPLES) / 16000
    return (0.9 * np.sin(2 * np.pi * 7000 * t)
            + 3e-4 * rng.standard_normal(N_SAMPLES)).astype(np.float32)


CASES = {
    "tone 2 s, 80 mels": (lambda: _tone(32000), 80),
    "tone 2 s, 128 mels": (lambda: _tone(32000), 128),
    "batch of 2, 1 s": (lambda: _noise(2, (2, 16000)), 80),
    "31.5 s (cut)": (lambda: _tone(504000), 128),
    "0.5 s (padded)": (lambda: _noise(4, (8000,)), 80),
    "30 s, loud onset": (_onset, 128),
    "30 s, 7 kHz tone over faint noise": (_tone_over_noise, 128),
}


# --- the kernel's arithmetic on (re, im) pairs of float32 arrays ----------

def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _mul(a, w):
    """a times the twiddle w = (cos, -sin) (broadcast)."""
    return a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0]


def _neg_i(a):
    """-i a."""
    return a[1], -a[0]


def _scale(a, s):
    return a[0] * s, a[1] * s


def _dft4(c0, c1, c2, c3):
    d0, d1, d2, d3 = _add(c0, c2), _sub(c0, c2), _add(c1, c3), _neg_i(_sub(c1, c3))
    return _add(d0, d2), _add(d1, d3), _sub(d0, d2), _sub(d1, d3)


def _dft8(a, c):
    """mel.cu dft8: a radix-2 split, W_8^1..3 on the odd half (c = the
    table's cos(pi / 4)), two radix-4 transforms."""
    b = [_add(a[i], a[i + 4]) for i in range(4)] + [_sub(a[i], a[i + 4]) for i in range(4)]
    b[5] = (c * (b[5][0] + b[5][1]), c * (b[5][1] - b[5][0]))
    b[6] = _neg_i(b[6])
    b[7] = (c * (b[7][1] - b[7][0]), -c * (b[7][0] + b[7][1]))
    even, odd = _dft4(*b[:4]), _dft4(*b[4:])
    return [v for pair in zip(even, odd) for v in pair]


def _dft5(c, k):
    """mel.cu dft5: k = (cos 72, sin 72, cos 144, sin 144) from the table."""
    c1, s1, c2, s2 = k
    t1, t2 = _add(c[1], c[4]), _add(c[2], c[3])
    t3, t4 = _sub(c[1], c[4]), _sub(c[2], c[3])
    x0 = _add(_add(c[0], t1), t2)
    a1 = (c[0][0] + c1 * t1[0] + c2 * t2[0], c[0][1] + c1 * t1[1] + c2 * t2[1])
    b1 = (s1 * t3[0] + s2 * t4[0], s1 * t3[1] + s2 * t4[1])
    a2 = (c[0][0] + c2 * t1[0] + c1 * t2[0], c[0][1] + c2 * t1[1] + c1 * t2[1])
    b2 = (s2 * t3[0] - s1 * t4[0], s2 * t3[1] - s1 * t4[1])
    return [x0, _add(a1, _neg_i(b1)), _add(a2, _neg_i(b2)), _sub(a2, _neg_i(b2)),
            _sub(a1, _neg_i(b1))]


def _frames(audio):
    """(B, 3000, 400) float32 frames: the window padded or cut to 30 s and
    reflect-padded by 200, as mel.cu stages them by index."""
    x = np.atleast_2d(audio).astype(np.float32)[:, :N_SAMPLES]
    x = np.pad(x, ((0, 0), (0, N_SAMPLES - x.shape[1])))
    x = np.pad(x, ((0, 0), (200, 200)), mode="reflect")
    idx = 160 * np.arange(N_FRAMES)[:, None] + np.arange(400)[None, :]
    return x[:, idx]


def emulate(audio, n_mels, twiddles=None, conj=True):
    """The kernel's order: both FFT stages and the split in float64 (the
    host's float64 twiddles) from the float32 window products, stage 1's
    output stored as float32; ``twiddles`` replaces the host table
    and ``conj=False`` drops the split step's conjugate (mutations)."""
    tw, window = t_mel.fft_tables()
    tw = tw if twiddles is None else twiddles
    r = _frames(audio) * window                              # (B, F, 400)
    z = r.reshape(*r.shape[:2], 8, 25, 2)                    # n = 25 n1 + n2
    w64 = np.asarray(tw, np.float64)
    # stage 1, float64 from the float32 products, stored as float32: radix 8
    # over n1 for each n2, then W_200^(n2 k1)
    z = z.astype(np.float64)
    y = _dft8([(z[..., n1, :, 0], z[..., n1, :, 1]) for n1 in range(8)], w64[25, 0])
    n2 = np.arange(25)
    y = [_mul(y[k1], (w64[n2 * k1, 0], w64[n2 * k1, 1])) for k1 in range(8)]
    y = [(re.astype(F32), im.astype(F32)) for re, im in y]
    # stage 2, float64: 25 points over n2 = 5 m1 + m2 for each k1: radix 5
    # over m1, W_200^(8 m2 q1), radix 5 over m2; Z[k1 + 8 (q1 + 5 q2)]
    k5 = (w64[40, 0], -w64[40, 1], w64[80, 0], -w64[80, 1])
    zk = np.empty((2, *r.shape[:2], 200))
    for k1 in range(8):
        a = [(y[k1][0][..., m].astype(np.float64), y[k1][1][..., m].astype(np.float64))
             for m in range(25)]
        col = [_dft5([a[5 * m1 + m2] for m1 in range(5)], k5) for m2 in range(5)]
        for m2 in range(1, 5):
            for q1 in range(1, 5):
                col[m2][q1] = _mul(col[m2][q1], w64[8 * m2 * q1])
        for q1 in range(5):
            out = _dft5([col[m2][q1] for m2 in range(5)], k5)
            for q2 in range(5):
                zk[:, ..., k1 + 8 * (q1 + 5 * q2)] = out[q2]
    # split, float64: X[k] = E + W_400^k O for k = 0..199, X[200] = E - O at 0
    k = np.arange(200)
    a = (zk[0][..., k], zk[1][..., k])
    bz = (zk[0][..., (200 - k) % 200], zk[1][..., (200 - k) % 200])
    bc = (bz[0], -bz[1]) if conj else bz
    e = _scale(_add(a, bc), 0.5)
    d = _sub(a, bc)
    o = (0.5 * d[1], -0.5 * d[0])
    # W_400^k = -conj(W_400^(200 - k)) past k = 100
    w4 = w64[200 + np.minimum(k, 200 - k)]
    xk = _add(e, _mul(o, (np.where(k <= 100, w4[:, 0], -w4[:, 0]), w4[:, 1])))
    xn = _sub(e, o)
    power = np.empty((*r.shape[:2], 201), np.float32)
    power[..., :200] = xk[0] * xk[0] + xk[1] * xk[1]
    power[..., 200] = xn[0][..., 0] ** 2 + xn[1][..., 0] ** 2
    # CSR projection in bin order, log10, the window's max - 8 and rescale
    indptr, first, weights = t_mel.mel_csr(n_mels)
    mel = np.zeros((*r.shape[:2], n_mels), np.float32)
    for m in range(n_mels):
        for i in range(indptr[m + 1] - indptr[m]):
            mel[..., m] += weights[indptr[m] + i] * power[..., first[m] + i]
    log = np.log10(np.maximum(mel, F32(1e-10)))
    peak = log.max(axis=(1, 2), keepdims=True)
    out = ((np.maximum(log, peak - F32(8.0)) + F32(4.0)) * F32(0.25)).transpose(0, 2, 1)
    return out[0] if np.ndim(audio) == 1 else out


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_pallas_and_plain(case):
    make, n_mels = CASES[case]
    audio = make()
    got = emulate(audio, n_mels)
    assert got.dtype == np.float32 and got.shape == audio.shape[:-1] + (n_mels, 3000)
    want = t_mel.log_mel_spectrogram_fused_ref(torch.from_numpy(audio), n_mels).numpy()
    assert np.abs(got - want).max() < TOL
    pallas = np.asarray(log_mel_spectrogram_pallas(audio, n_mels=n_mels, interpret=True))
    assert np.abs(got - pallas).max() < TOL


def test_onset_puts_the_floor_in_play():
    out = t_mel.log_mel_spectrogram_fused_ref(torch.from_numpy(_onset()), 128).numpy()
    floor = out.min()
    assert (out == floor).mean() > 0.1  # clamped values
    assert ((out > floor) & (out < floor + 0.25)).mean() > 0.5  # just above it


@pytest.mark.parametrize("n_mels", [80, 128])
def test_csr_rebuilds_the_dense_bank(n_mels):
    indptr, first, weights = t_mel.mel_csr(n_mels)
    assert indptr.dtype == first.dtype == np.int32 and weights.dtype == np.float32
    assert indptr[0] == 0 and indptr[-1] == weights.size <= t_mel.MAX_NNZ
    dense = np.zeros((201, n_mels), np.float32)
    for m in range(n_mels):
        count = indptr[m + 1] - indptr[m]
        assert count >= 1 and first[m] + count <= 201
        dense[first[m]:first[m] + count, m] = weights[indptr[m]:indptr[m + 1]]
    np.testing.assert_array_equal(dense, mel_filter_bank(n_mels))
    assert (weights != 0).all()


def test_twiddles_are_float64_and_exact_to_an_ulp():
    tw, window = t_mel.fft_tables()
    assert tw.dtype == np.float64 and tw.shape == (301, 2)
    ulp = np.spacing(1.0)
    np.testing.assert_allclose(np.hypot(tw[:, 0], tw[:, 1]), 1.0, rtol=0, atol=2 * ulp)
    # W_400^(2k) = W_200^k, and the butterflies' constants in closed form:
    # cos(pi / 4); cos and sin of 72 and 144 degrees (W_5 = W_200^40)
    np.testing.assert_allclose(tw[200::2], tw[:51], rtol=0, atol=ulp)
    r5 = np.sqrt(5.0)
    for got, want in ((tw[25, 0], np.sqrt(0.5)), (-tw[25, 1], np.sqrt(0.5)),
                      (tw[40, 0], (r5 - 1) / 4), (-tw[40, 1], np.sqrt(10 + 2 * r5) / 4),
                      (tw[80, 0], -(r5 + 1) / 4), (-tw[80, 1], np.sqrt(10 - 2 * r5) / 4)):
        assert abs(got - want) <= ulp, (got, want)
    np.testing.assert_array_equal(window, np.hanning(401)[:-1].astype(np.float32))


@pytest.mark.parametrize("mutation", ["twiddle sign", "split conjugate"])
def test_a_mutation_fails(mutation):
    audio = _tone(32000)
    want = t_mel.log_mel_spectrogram_fused_ref(torch.from_numpy(audio), 80).numpy()
    if mutation == "twiddle sign":
        tw = t_mel.fft_tables()[0].copy()
        tw[7, 1] = -tw[7, 1]
        got = emulate(audio, 80, twiddles=tw)
    else:
        got = emulate(audio, 80, conj=False)
    assert np.abs(got - want).max() > 10 * TOL
