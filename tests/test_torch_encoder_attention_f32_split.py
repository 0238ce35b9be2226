"""The float32 path of the encoder attention's Hopper kernel
(``ttasr_torch/csrc/encoder_attention.cuh``, ``Tf32Tiles``),
its arithmetic on the CPU.

The kernel cannot run here; these tests pin the 3xTF32 order it relies on.

- ``_split`` is the kernel's ``split_tf32``: ``cvt.rna.tf32.f32`` as
  ``(bits + 0x1000) & ~0x1FFF`` on the int32 view (round to nearest, ties
  away from zero, on the magnitude), hi = rna(a), lo = rna(a - hi).  hi +
  lo gives a back within 2**-21 of |a| over the exponent sweep of
  ``test_torch_encoder_attention_tiles.py`` wherever lo is a normal f32;
  below that lo's subnormal steps of 2**-136 bound it instead.
- ``_kernel_order`` emulates the kernel's work in torch: 64-key tiles,
  S = q_hi k_hi + q_hi k_lo + q_lo k_hi per tile (products of two tf32
  values are exact in f32), the online softmax of the bf16 kernel (f32
  running maximum and sum, exp2 with the scale folded into one multiply,
  keys >= t_real masked), the unnormalised probabilities split into hi and
  lo (kept f32, never rounded to bf16), O += P_hi V_hi + P_hi V_lo +
  P_lo V_hi, the output divided by the sum once at the end.
- At B = 1, T = 300, t_real = 257 (a masked tail inside the last tile),
  2 heads, the emulation stays within 1e-5 x max|out| of float64, and
  within ``F32_REL`` = 1e-4 x max of JAX ``model._attention`` in float32
  (the math of the plain version, and ``chip_smoke.py``'s bound for the
  kernel on the card).  A 1xTF32 control (hi products only) lies beyond
  1e-5 x max of float64, so the float64 bound tells the orders apart.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder_attention_tiles import _wide_range

from ttasr.models.whisper import model as j_model
from ttasr_torch.ops import encoder_attention as t_att

DH = 64
HEADS = 2
KEYS = 64       # the kernel's key tile (KEYS_F32)
F32_REL = 1e-4  # chip_smoke.py's bound for the f32 kernel
F64_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small matmuls run faster on one thread, and the suite runs several
    workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """cvt.rna.tf32.f32 on float32 ``x``: the 13 low mantissa bits rounded
    off, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _kernel_order(q, k, v, t_real: int, products: int = 3):
    """The f32 kernel's arithmetic on merged (B, T, D) float32 q/k/v (q
    pre-scaled, the scores' scale 1): 3xTF32 products, or the hi products
    alone with ``products=1``."""
    b, t, d = q.shape
    h = d // DH

    def heads(x):
        return x.reshape(b, t, h, DH).transpose(1, 2)  # (B, H, T, dh)

    def mm(a, b_):
        (ah, al), (bh, bl) = _split(a), _split(b_)
        if products == 1:
            return ah @ bh
        return ah @ bh + ah @ bl + al @ bh

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale_log2 = torch.tensor(math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, h, t, 1), -math.inf)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, DH))
    for k0 in range(0, t_real, KEYS):
        s = mm(qh, kh[:, :, k0:k0 + KEYS].transpose(-1, -2))
        keys = torch.arange(k0, k0 + s.shape[-1])
        s = s.masked_fill(keys >= t_real, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - m_new * scale_log2)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vh[:, :, k0:k0 + KEYS])
        m = m_new
    return (o / l).transpose(1, 2).reshape(b, t, d)


def _inputs(seed=0, b=1, t=300):
    """Seeded float32 q/k/v (B, T, 2 x 64), q pre-scaled by 64**-0.5, as the
    encoder hands them to B11; none of them tf32-exact."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, HEADS * DH)).astype(np.float32) for _ in range(3))
    return np.float32(DH ** -0.5) * q, k, v


def _float64(q, k, v, t_real):
    """The attention in float64 (the plain version computes in f32)."""
    b, t, d = q.shape

    def heads(x):
        return torch.from_numpy(x).double().reshape(b, t, HEADS, DH).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2)
    scores = scores.masked_fill(torch.arange(t) >= t_real, -math.inf)
    out = torch.softmax(scores, dim=-1) @ heads(v)
    return out.transpose(1, 2).reshape(b, t, d).numpy()


def _rel(got, want, t_real):
    got, want = np.asarray(got, np.float64)[:, :t_real], np.asarray(want, np.float64)[:, :t_real]
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_split_reconstructs_f32():
    x = _wide_range(11)
    hi, lo = _split(x)
    # both halves are tf32: the 13 low mantissa bits are zero
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    a, err = x.double(), (hi.double() + lo.double() - x.double()).abs()
    normal_lo = a.abs() >= 2.0 ** -100
    assert normal_lo.sum() > 3000
    assert (err[normal_lo] <= 2.0 ** -21 * a.abs()[normal_lo]).all()
    assert (err <= 2.0 ** -21 * a.abs() + 2.0 ** -136).all()
    # a single tf32 value keeps ~2**-11: the split is what carries f32
    assert ((hi.double() - a).abs()[normal_lo] > 2.0 ** -16 * a.abs()[normal_lo]).any()


def test_3xtf32_order_holds_float64():
    q, k, v = _inputs()
    t_real = 257
    want = _float64(q, k, v, t_real)
    got = _kernel_order(*(torch.from_numpy(x) for x in (q, k, v)), t_real)
    assert _rel(got.numpy(), want, t_real) <= F64_REL
    # the control: one TF32 product per term misses the float64 bound
    one = _kernel_order(*(torch.from_numpy(x) for x in (q, k, v)), t_real, products=1)
    assert _rel(one.numpy(), want, t_real) > F64_REL


def test_3xtf32_order_holds_jax_attention():
    q, k, v = _inputs(seed=1)
    t_real = 257
    b, t, d = q.shape
    mask = (jnp.arange(t) < t_real)[None, None, None, :]
    # model._attention scales q by 64**-0.5 itself: hand it q * 8, exact
    want = j_model._attention(*(jnp.asarray(x.reshape(b, t, HEADS, DH))
                                for x in (q * np.float32(8.0), k, v)), mask)
    want = np.asarray(jax.device_get(want)).reshape(b, t, d)
    got = _kernel_order(*(torch.from_numpy(x) for x in (q, k, v)), t_real)
    assert _rel(got.numpy(), want, t_real) <= F32_REL
    plain = t_att.encoder_attention_merged_ref(*(torch.from_numpy(x) for x in (q, k, v)), t_real)
    assert _rel(plain.numpy(), want, t_real) <= F32_REL
