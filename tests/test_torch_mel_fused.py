"""B18 in the port, ``log_mel_spectrogram_fused``, against the Pallas
kernel ``ttasr.ops.mel_pallas.log_mel_spectrogram_pallas`` in interpret
mode, on seeded audio: the golden test's 2 s tone at 80 and 128 mels, a
batch of two, a clip over 30 s (cut) and one of 0.5 s (padded).  On the CPU
the wrapper runs its plain version; the CUDA kernel is held to that plain
version on the card by ``chip_smoke.py``.  Tolerance 2e-4 absolute, the
Pallas kernel's own contract against the XLA path.
"""

import numpy as np
import pytest
import torch

from ttasr.ops.mel_pallas import log_mel_spectrogram_pallas
from ttasr_torch.ops import mel_fused as t_mel

TOL = 2e-4


def _tone(n):
    rng = np.random.default_rng(1)
    return (0.2 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _noise(seed, shape):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


CASES = {
    "tone 2 s, 80 mels": (lambda: _tone(32000), 80),
    "tone 2 s, 128 mels": (lambda: _tone(32000), 128),
    "batch of 2, 1 s": (lambda: _noise(2, (2, 16000)), 80),
    "31.5 s (cut)": (lambda: _tone(504000), 128),
    "0.5 s (padded)": (lambda: _noise(4, (8000,)), 80),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_interpret(case):
    make, n_mels = CASES[case]
    audio = make()
    want = np.asarray(log_mel_spectrogram_pallas(audio, n_mels=n_mels,
                                                 interpret=True))
    before = t_mel.log_mel_spectrogram_fused.launches
    got = t_mel.log_mel_spectrogram_fused(torch.from_numpy(audio), n_mels)
    assert t_mel.log_mel_spectrogram_fused.launches == before  # plain version
    assert got.dtype == torch.float32
    assert got.shape == want.shape == audio.shape[:-1] + (n_mels, 3000)
    assert np.abs(got.numpy() - want).max() < TOL


def test_kernel_constants_are_the_ports_copies():
    """The kernel's tables on the device are the host's: the window that
    ``ops/mel.py``'s DFT basis folds in (its cos(0) column), the float64
    twiddles W_200^e (e < 200) and W_400^k (k <= 100) of the FFT's length
    and the frame's, and the CSR form of the port's filterbank (each mel a
    run of bins from its first)."""
    from ttasr_torch.ops.mel import N_FFT, _dft_basis, mel_filter_bank

    tw, window, indptr, first, weights = t_mel._kernel_constants(128, torch.device("cpu"))
    assert all(t.is_contiguous() for t in (tw, window, indptr, first, weights))
    assert tw.dtype == torch.float64 and window.dtype == weights.dtype == torch.float32
    assert indptr.dtype == first.dtype == torch.int32
    np.testing.assert_array_equal(window.numpy(), _dft_basis()[0][:, 0])
    assert t_mel.N_FFT_HALF == N_FFT // 2 and tw.shape == (N_FFT // 2 + N_FFT // 4 + 1, 2)
    ang = np.concatenate([2 * np.pi * np.arange(N_FFT // 2) / (N_FFT // 2),
                          2 * np.pi * np.arange(N_FFT // 4 + 1) / N_FFT])
    np.testing.assert_array_equal(tw.numpy(), np.stack([np.cos(ang), -np.sin(ang)], 1))
    dense = np.zeros((201, 128), np.float32)
    for m in range(128):
        lo, hi = indptr[m].item(), indptr[m + 1].item()
        dense[first[m]:first[m] + hi - lo, m] = weights[lo:hi].numpy()
    np.testing.assert_array_equal(dense, mel_filter_bank(128))
    assert weights.numel() == np.count_nonzero(mel_filter_bank(128)) == 394


def test_wrapper_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="meta"):
        t_mel.log_mel_spectrogram_fused(torch.empty(16000, device="meta"))
    with pytest.raises(ValueError, match="n_mels"):
        t_mel.log_mel_spectrogram_fused(torch.zeros(16000), n_mels=129)
    with pytest.raises(ValueError, match="audio"):
        t_mel.log_mel_spectrogram_fused(torch.zeros(2, 2, 16000))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mel.log_mel_spectrogram_fused(np.zeros(16000, np.float32))
