"""The plain versions of the int8 decode kernels (B1, B2, B3, B4, B10)
against the JAX Pallas kernels run with ``interpret=True``, as
``tests/test_decoder_kernels.py`` runs them, on the same seeded numpy
inputs.  The CUDA kernels themselves run only on the card; there
``chip_smoke.py`` holds each of them against the same plain version.

New K/V codes and scales must match exactly.  Float outputs are held to
``FLOAT_REL`` x max|JAX|: both sides take the same bf16 rounding points
(LN outputs, GELU outputs, pre-scaled queries, scale-folded
probabilities) with f32 products and sums in another order, so an f32
last-bit difference can flip a bf16 rounding of an intermediate and
move an output by about one bf16 step of one term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import decoder_blocks_pallas as jblk
from ttasr.ops import decoder_mlp_pallas as jmlp
from ttasr.ops import self_attention_pallas as jsa
from ttasr.ops.int4 import pack_int4, pack_int4_lanes
from ttasr.ops.quant import quantize_kv_sym, quantize_tensor
from ttasr_torch.ops import decoder_blocks as tblk
from ttasr_torch.ops import decoder_mlp as tmlp
from ttasr_torch.ops import self_attention as tsa

FLOAT_REL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=FLOAT_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _weight(rng, shape, scale=0.05):
    w = quantize_tensor((rng.standard_normal(shape) * scale).astype(np.float32))
    return np.asarray(w["q"]), np.asarray(w["s"])


def _vec(rng, n, scale=0.02, offset=0.0):
    return (rng.standard_normal(n) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("r", [5, 16])
def test_qkv_int8_fused_matches_pallas(r):
    rng = np.random.default_rng(r)
    d = 256
    x = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
    ln_s, ln_b = _vec(rng, d, 0.1, 1.0), _vec(rng, d, 0.1)
    wq, ws = _weight(rng, (d, 3 * d))
    b = _vec(rng, 3 * d)
    want = jblk.qkv_int8_fused(jnp.asarray(x), ln_s, ln_b, wq, ws, b,
                               interpret=True)
    got = tblk.qkv_int8_fused(*map(_t, (x, ln_s, ln_b, wq, ws, b)))
    assert got.dtype == torch.float32 and got.shape == (r, 3 * d)
    _close(got, want)


def _cross_inputs(seed, b, k, h, s, int4):
    rng = np.random.default_rng(seed)
    d = h * 64
    x = (rng.standard_normal((b, k, d)) * 0.3).astype(np.float32)
    attn = (rng.standard_normal((b, k, d)) * 0.3).astype(np.float32)
    wo, wo_s = _weight(rng, (d, d))
    wqc, wqc_s = _weight(rng, (d, d))
    kv = (rng.standard_normal((2, b, s, h, 64)) * 0.5).astype(np.float32)
    codes, scales = [], []
    for i in range(2):
        c, sc = quantize_kv_sym(jnp.asarray(kv[i]), 7 if int4 else 127)
        c = jnp.asarray(c).reshape(b, s, d)
        codes.append(np.asarray(pack_int4(c) if int4 else c))
        scales.append(np.ascontiguousarray(np.swapaxes(np.asarray(sc), 1, 2)))
    return (x, attn, wo, wo_s, _vec(rng, d), _vec(rng, d, 0.1, 1.0),
            _vec(rng, d, 0.1), wqc, wqc_s, _vec(rng, d),
            codes[0], scales[0], codes[1], scales[1])


@pytest.mark.parametrize("b,k", [(1, 5), (2, 3), (3, 1)])
@pytest.mark.parametrize("int4", [True, False])
def test_attnout_ln_q_cross_int8_matches_pallas(b, k, int4):
    h, s, s_real = 4, 48, 45
    args = _cross_inputs(b * 10 + k, b, k, h, s, int4)
    xo_j, cross_j = jblk.attnout_ln_q_cross_int8(
        *map(jnp.asarray, args), s_real=s_real, interpret=True)
    xo_t, cross_t = tblk.attnout_ln_q_cross_int8(*map(_t, args),
                                                 s_real=s_real)
    _close(xo_t, xo_j)
    _close(cross_t, cross_j)


@pytest.mark.parametrize("r", [5, 8])
def test_mlp_with_crossout_int8_matches_pallas(r):
    rng = np.random.default_rng(40 + r)
    d, f = 256, 1024
    x = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
    cross = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
    woc, woc_s = _weight(rng, (d, d))
    w1, w1s = _weight(rng, (d, f))
    w2, w2s = _weight(rng, (f, d))
    args = (x, cross, woc, woc_s, _vec(rng, d), _vec(rng, d, 0.1, 1.0),
            _vec(rng, d, 0.1), w1, w1s, _vec(rng, f), w2, w2s, _vec(rng, d))
    # tile=256 splits the ffn sum over 4 grid steps, as large-v3 does over 2
    want = jmlp.mlp_with_crossout_int8(*map(jnp.asarray, args), tile=256,
                                       interpret=True)
    got = tmlp.mlp_with_crossout_int8(*map(_t, args))
    _close(got, want)


def test_gelu_is_the_kernels_polynomial():
    """The plain GELU is the A&S polynomial of decoder_mlp_pallas.py, not
    the exact erf; the two differ by less than the polynomial's 1.5e-7
    erf bound times |h|."""
    h = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jmlp._gelu_exact(jnp.asarray(h)))
    got = tmlp.gelu_as(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    exact = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
    assert np.abs(got - exact).max() <= 1.5e-7 * 6 + 1e-6


def _self_inputs(seed, b, k, h, s_len, slot, pads, int4, anc):
    rng = np.random.default_rng(seed)
    d = h * 64
    hp = ((h + 7) // 8) * 8
    lv = 7 if int4 else 127
    qkv = (rng.standard_normal((b, k, 3 * d)) * 0.5).astype(np.float32)
    qkv[0, 0, d:d + 4] = [0.5, -0.5, 1.5, 2.5]  # exact .5 ratios at |x|max
    qkv[0, 0, d + 4] = 3.5 if int4 else 63.5
    caches = []
    for _ in range(2):
        kv = (rng.standard_normal((b * k, s_len, h, 64)) * 0.5).astype(np.float32)
        c, sc = quantize_kv_sym(jnp.asarray(kv), lv)
        c = np.array(c).reshape(b * k, s_len, d)
        junk = np.arange(s_len) >= slot  # not yet written: must not matter
        c[:, junk] = rng.integers(-lv, lv + 1, c[:, junk].shape)
        if int4:
            c = np.asarray(pack_int4_lanes(jnp.asarray(c)))
        sc = np.pad(np.swapaxes(np.asarray(sc), 1, 2),
                    ((0, 0), (0, hp - h), (0, 0)))
        caches += [c.reshape(b, k, s_len, -1),
                   np.ascontiguousarray(sc.reshape(b, k, hp, s_len))]
    pad = np.array(pads, np.int32).reshape(b, k)
    anc_arr = (rng.integers(0, k, (b, k, s_len)).astype(np.int32)
               if anc else None)
    return qkv, caches, pad, anc_arr


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("k,pads", [(1, [0, 3]), (3, [0, 2, 0, 5, 5, 5])])
@pytest.mark.parametrize("indirect", [False, True])
def test_self_attn_step_matches_pallas(int4, k, pads, indirect):
    b, h, s_len, slot = 2, 2, 24, 17
    qkv, (k8, ks, v8, vs), pad, anc = _self_inputs(
        7 * k + int4, b, k, h, s_len, slot, pads, int4, indirect)
    if indirect:
        want = jsa.self_attn_step_indirect_int8(
            jnp.asarray(qkv), k8, ks, v8, vs, anc, pad, slot,
            n_heads=h, int4=int4, interpret=True)
        got = tsa.self_attn_step_indirect_int8(
            *map(_t, (qkv, k8, ks, v8, vs, anc, pad)), slot, n_heads=h,
            int4=int4)
    else:
        want = jsa.self_attn_step_int8(
            jnp.asarray(qkv), k8, ks, v8, vs, pad, slot, n_heads=h,
            int4=int4, interpret=True)
        got = tsa.self_attn_step_int8(
            *map(_t, (qkv, k8, ks, v8, vs, pad)), slot, n_heads=h, int4=int4)
    _close(got[0], want[0])
    for i in (1, 2, 3, 4):  # new codes and scales: exact
        assert got[i].numpy().dtype == np.asarray(want[i]).dtype
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_indirect_with_identity_ancestry_is_the_direct_step():
    b, k, h, s_len, slot = 1, 3, 2, 16, 11
    qkv, (k8, ks, v8, vs), pad, _ = _self_inputs(
        3, b, k, h, s_len, slot, [1, 1, 1], True, False)
    anc = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :, None],
                          (b, k, s_len))
    direct = tsa.self_attn_step_int8(*map(_t, (qkv, k8, ks, v8, vs, pad)),
                                     slot, n_heads=h, int4=True)
    indirect = tsa.self_attn_step_indirect_int8(
        *map(_t, (qkv, k8, ks, v8, vs, anc, pad)), slot, n_heads=h, int4=True)
    for a, c in zip(direct, indirect):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_wrappers_reject_other_devices():
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tblk.qkv_int8_fused(x, x[0], x[0], x, x, x)
