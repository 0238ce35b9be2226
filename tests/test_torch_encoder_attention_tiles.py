"""The contract of the encoder attention's Hopper kernel
(``ttasr_torch/csrc/encoder_attention.cuh``), on the CPU.

The kernel cannot run here; these tests pin the arithmetic it relies on.

- B19 scales the scores instead of q: 64**-0.5 = 2**-3 is a power of two,
  so round_bf16(q * 0.125) equals round_bf16(q) * 0.125 bit for bit
  (float32 and bf16 inputs, magnitudes from 2**-123 up to the top of the
  bf16 range: below 2**-123 the product would be subnormal), and the
  plain version with 0.125 on the f32 scores equals
  ``encoder_self_attention_ref`` bit for bit.
- ``_kernel_order`` emulates the kernel's order of work in torch: tiles of
  128 queries x 128 keys, a running maximum and sum in f32 per query row,
  the unnormalised probabilities exp2(scale log2(e) (s - m)) rounded to
  bf16 per tile before the value product, the f32 output divided by the
  sum once at the end.  It is held against the three Pallas kernels it
  replaces, in interpret mode, at 4 heads (D = 256): B11
  ``encoder_attention_merged``, B6 ``encoder_attention_merged_qkv`` and
  B19 ``encoder_self_attention``, at T = 300 (a ragged last tile of 44
  keys) and T = 600 with ``t_real`` = 550 (real keys masked) and B = 2.
  Tolerance 2e-3 absolute, the existing tests' bound
  (``test_torch_encoder_self_attention.py``); the merged kernels need T a
  multiple of 256, so their inputs are padded with zeros and rows >= T
  dropped.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import encoder_attention_pallas as j_att
from ttasr_torch.ops import encoder_attention as t_att

TOL = 2e-3
DH = 64
HEADS = 4
TILE = 128  # the kernel's query and key tile


def _kernel_order(q, k, v, t_real: int, scale: float):
    """The kernel's arithmetic on merged (B, T, D) bf16 q/k/v: returns the
    f32 output before its rounding to the output type."""
    b, t, d = q.shape
    h = d // DH

    def heads(x):
        return x.reshape(b, t, h, DH).transpose(1, 2).float()  # (B, H, T, dh)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    out = torch.empty((b, h, t, DH), dtype=torch.float32)
    for q0 in range(0, t, TILE):
        qt = qh[:, :, q0:q0 + TILE]
        rows = qt.shape[2]
        m = torch.full((b, h, rows, 1), -math.inf)
        l = torch.zeros((b, h, rows, 1))
        o = torch.zeros((b, h, rows, DH))
        for k0 in range(0, t_real, TILE):
            s = qt @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
            keys = torch.arange(k0, k0 + s.shape[-1])
            s = s.masked_fill(keys >= t_real, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * scale_log2)
            p = torch.exp2(s * scale_log2 - m_new * scale_log2)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + p.to(torch.bfloat16).float() @ vh[:, :, k0:k0 + TILE]
            m = m_new
        out[:, :, q0:q0 + TILE] = o / l
    return out.transpose(1, 2).reshape(b, t, d)


def _inputs(b, t, seed):
    """Seeded q/k/v (B, T, HEADS, 64) as float32 numpy, bf16-exact."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, t, HEADS, DH)) * 0.5 for _ in range(3)]
    return [np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
            for x in xs]


def _padded(x, t_pad):
    """(B, T, ...) numpy zero-padded to T = t_pad, as a bf16 jax array."""
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, t_pad - x.shape[1])
    return jnp.asarray(np.pad(x, pad), jnp.float32).astype(jnp.bfloat16)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


# ---------------------------------------------------------------------------
# B19: the scale moves from q to the scores
# ---------------------------------------------------------------------------


def _wide_range(seed):
    """float32 values with exponents -123..127, both signs, and zeros."""
    rng = np.random.default_rng(seed)
    exp = rng.integers(-123, 127, size=4096)
    x = rng.uniform(1.0, 2.0, size=4096) * np.exp2(exp.astype(np.float64))
    x = np.minimum(x, np.float32(3.3e38)) * rng.choice([-1.0, 1.0], size=4096)
    x[::97] = 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q_scale_commutes_with_bf16_rounding(dtype):
    q = _wide_range(11).to(dtype)
    scaled_then_rounded = (q * 0.125).to(torch.bfloat16)  # B19's TPU order
    rounded_then_scaled = q.to(torch.bfloat16) * 0.125    # the kernel's
    assert torch.equal(scaled_then_rounded.view(torch.int16),
                       rounded_then_scaled.view(torch.int16))


def _plain_score_scale(q, k, v):
    """B19's plain version with 64**-0.5 applied to the f32 scores instead
    of q (the kernel's order of the scale)."""
    def heads(x):
        return x.to(torch.bfloat16).transpose(1, 2).float()

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * 0.125
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.matmul(probs, heads(v)).to(torch.bfloat16)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_scale_equals_q_scale_bit_for_bit(dtype):
    rng = np.random.default_rng(12)
    # rows of different magnitude (1e-3 to 8), f32 values not bf16-exact
    q, k, v = [torch.from_numpy((rng.standard_normal((2, 200, HEADS, DH))
                                 * rng.uniform(1e-3, 8.0, (2, 200, HEADS, 1)))
                                .astype(np.float32)).to(dtype) for _ in range(3)]
    want = t_att.encoder_self_attention_ref(q, k, v)
    got = _plain_score_scale(q, k, v)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The kernel's order against the Pallas kernels
# ---------------------------------------------------------------------------

CASES = [(1, 300, 300), (2, 600, 550)]  # (B, T, t_real)


@pytest.mark.parametrize("b,t,t_real", CASES)
def test_kernel_order_matches_pallas_merged(b, t, t_real):
    q, k, v = _inputs(b, t, 20 + t)
    q = q * 0.125  # pre-scaled, as the encoder's projection emits it
    t_pad = -(-t // j_att.TQ_MERGED) * j_att.TQ_MERGED
    merged = [x.reshape(b, t, HEADS * DH) for x in (q, k, v)]
    want = np.asarray(j_att.encoder_attention_merged(
        *[_padded(x, t_pad) for x in merged], t_real, interpret=True)
        .astype(jnp.float32))[:, :t]
    tq, tk, tv = [torch.from_numpy(x).to(torch.bfloat16) for x in merged]
    got = _kernel_order(tq, tk, tv, t_real, 1.0).to(torch.bfloat16)
    err = _err(got.float(), want)
    print(f"B11 B={b} T={t} t_real={t_real}: max |kernel order - Pallas| = {err:.3e}")
    assert err < TOL
    plain = t_att.encoder_attention_merged(tq, tk, tv, t_real)
    assert _err(got.float(), plain.float()) < TOL


@pytest.mark.parametrize("b,t,t_real", CASES)
def test_kernel_order_matches_pallas_merged_qkv(b, t, t_real):
    q, k, v = _inputs(b, t, 30 + t)
    q = q * 0.125
    qkv = np.concatenate([x.reshape(b, t, HEADS * DH) for x in (q, k, v)], axis=-1)
    t_pad = -(-t // j_att.TQ_MERGED) * j_att.TQ_MERGED
    want = np.asarray(j_att.encoder_attention_merged_qkv(
        _padded(qkv, t_pad), t_real, interpret=True).astype(jnp.float32))[:, :t]
    tqkv = torch.from_numpy(qkv).to(torch.bfloat16)
    d = HEADS * DH
    got = _kernel_order(tqkv[..., :d], tqkv[..., d:2 * d], tqkv[..., 2 * d:], t_real,
                        1.0).to(torch.bfloat16)
    err = _err(got.float(), want)
    print(f"B6 B={b} T={t} t_real={t_real}: max |kernel order - Pallas| = {err:.3e}")
    assert err < TOL
    plain = t_att.encoder_attention_merged_qkv(tqkv, t_real)
    assert _err(got.float(), plain.float()) < TOL


@pytest.mark.parametrize("b,t", [(1, 300), (2, 600)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_order_matches_pallas_self_attention(dtype, b, t):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(40 + t)
    xs = [rng.standard_normal((b, t, HEADS, DH)).astype(np.float32) * 0.3 for _ in range(3)]
    want = np.asarray(j_att.encoder_self_attention(
        *[jnp.asarray(x).astype(jdt) for x in xs], interpret=True), np.float32)
    # B19's kernel: q/k/v rounded to bf16 (a float32 input by its own pass),
    # 64**-0.5 on the scores, the output rounded to bf16 and cast back
    tq, tk, tv = [torch.from_numpy(x).to(tdt).to(torch.bfloat16).reshape(b, t, HEADS * DH)
                  for x in xs]
    got = _kernel_order(tq, tk, tv, t, DH ** -0.5).to(torch.bfloat16).to(tdt)
    got = got.reshape(b, t, HEADS, DH)
    err = _err(got.float(), want)
    print(f"B19 {dtype} B={b} T={t}: max |kernel order - Pallas| = {err:.3e}")
    assert err < TOL
    plain = t_att.encoder_self_attention(*[torch.from_numpy(x).to(tdt) for x in xs])
    assert _err(got.float(), plain.float()) < TOL
