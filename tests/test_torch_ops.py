"""The port's device ops against the JAX package on the CPU.

- Encoder attention (B11): the wrapper on CPU tensors runs its plain
  PyTorch version, held against the TPU kernel in interpret mode (bf16,
  the shapes of test_decoder_kernels.py) and against JAX ``_attention``
  (f32).  The CUDA kernel itself is checked against the same plain version
  on the card by ``chip_smoke.py``.
- Log-mel: int16 and float32 input, with and without chunk padding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttasr.models.whisper.model import _attention as j_attention
from ttasr.ops.encoder_attention_pallas import encoder_attention_merged as j_merged
from ttasr.ops.mel import log_mel_spectrogram as j_mel
from ttasr_torch.ops.encoder_attention import (
    encoder_attention_merged,
    encoder_attention_merged_ref,
)
from ttasr_torch.ops.mel import log_mel_spectrogram


def _qkv(rng, b, t, d):
    return [(rng.standard_normal((b, t, d)) * 0.5).astype(np.float32)
            for _ in range(3)]


def test_encoder_attention_plain_matches_tpu_kernel_bf16():
    rng = np.random.default_rng(9)
    b, t_pad, t_real, h, dh = 2, 512, 500, 4, 64
    q, k, v = _qkv(rng, b, t_pad, h * dh)
    qs = q * dh ** -0.5
    want = np.asarray(j_merged(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), t_real, interpret=True)).astype(np.float32)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    launches = encoder_attention_merged.launches
    got = encoder_attention_merged(bf(qs), bf(k), bf(v), t_real).float().numpy()
    assert encoder_attention_merged.launches == launches  # CPU: no kernel
    g, w = got[:, :t_real], want[:, :t_real]  # pad rows are junk in JAX
    rel = np.abs(g - w).max() / np.abs(w).max()
    assert rel < 3e-2, rel


@pytest.mark.parametrize("t_real", [96, 77])
def test_encoder_attention_plain_matches_jax_attention_f32(t_real):
    rng = np.random.default_rng(t_real)
    b, t, h, dh = 2, 96, 3, 64
    q, k, v = _qkv(rng, b, t, h * dh)
    mask = (np.arange(t) < t_real)[None, None, None, :]
    want = np.asarray(j_attention(
        *(jnp.asarray(x.reshape(b, t, h, dh)) for x in (q, k, v)),
        jnp.asarray(mask))).reshape(b, t, h * dh)
    got = encoder_attention_merged(
        torch.from_numpy(q * dh ** -0.5), torch.from_numpy(k),
        torch.from_numpy(v), t_real).numpy()
    np.testing.assert_allclose(got[:, :t_real], want[:, :t_real],
                               rtol=1e-5, atol=1e-5)


def test_encoder_attention_wrapper_rejects_bad_inputs():
    x = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError):
        encoder_attention_merged(x, x, torch.zeros((1, 8, 64)), 8)
    with pytest.raises(ValueError):
        encoder_attention_merged(torch.zeros((1, 8, 96)),
                                 torch.zeros((1, 8, 96)),
                                 torch.zeros((1, 8, 96)), 8)
    with pytest.raises(ValueError):
        encoder_attention_merged(x, x, x, 0)
    with pytest.raises(ValueError):
        encoder_attention_merged(x, x, x, 9)
    with pytest.raises(TypeError):
        encoder_attention_merged(x.half(), x.half(), x.half(), 8)
    with pytest.raises(TypeError):
        encoder_attention_merged(x, x.bfloat16(), x, 8)


def test_encoder_attention_plain_masks_keys_past_t_real():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 40, 128))
    k2, v2 = k.clone(), v.clone()
    k2[:, 30:] = 100.0  # keys past t_real must not matter
    v2[:, 30:] = -7.0
    a = encoder_attention_merged_ref(q, k, v, 30)
    b = encoder_attention_merged_ref(q, k2, v2, 30)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _audio(rng, n, dtype):
    a = 0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000)
    a = a + 0.05 * rng.standard_normal(n)
    if dtype == np.int16:
        return (a * 32767).astype(np.int16)
    return a.astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "f32"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(dtype, n_mels):
    rng = np.random.default_rng(1)
    audio = _audio(rng, 2 * 16000 + 123, dtype)
    want = np.asarray(j_mel(audio, n_mels=n_mels))
    got = log_mel_spectrogram(audio, n_mels=n_mels).numpy()
    assert got.shape == want.shape == (n_mels, 3000)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "f32"])
def test_log_mel_unpadded_batch_matches_jax(dtype):
    rng = np.random.default_rng(2)
    audio = np.stack([_audio(rng, 32000, dtype), _audio(rng, 32000, dtype)])
    want = np.asarray(j_mel(jnp.asarray(audio), n_mels=80, pad_to_chunk=False))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80,
                              pad_to_chunk=False).numpy()
    assert got.shape == want.shape == (2, 80, 200)
    assert np.abs(got - want).max() <= 1e-4


def test_log_mel_truncates_long_audio():
    rng = np.random.default_rng(4)
    audio = _audio(rng, 31 * 16000, np.float32)
    want = np.asarray(j_mel(audio))
    got = log_mel_spectrogram(audio).numpy()
    assert np.abs(got - want).max() <= 1e-4
