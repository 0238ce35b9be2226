"""The plain versions of the tensor-parallel decode kernels (B14
``mlp_int8_fused``, B15 ``matmul_int8_partial``, B16 ``ln_q_cross_int8``)
and B3 at a shard's cross width, against the JAX Pallas kernels run with
``interpret=True`` on the same seeded numpy inputs.  The CUDA kernels run
only on the card, where ``chip_smoke.py`` holds each against the same plain
version.

Shapes are those of ``tests/test_parallel.py``'s TP configuration (d_model
256, 4 heads, ffn 512) cut by a model axis of 2: a shard's 128 input rows
of wo (B15), its 256 hidden columns (B14), its 2 or 4 local heads (B16).
Floats are held to ``FLOAT_REL`` x max|JAX|, the bound of
``tests/test_torch_decoder_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import decoder_blocks_pallas as jblk
from ttasr.ops import decoder_mlp_pallas as jmlp
from ttasr.ops.int4 import pack_int4
from ttasr.ops.quant import quantize_kv_sym, quantize_tensor
from ttasr_torch.ops import decoder_blocks as tblk
from ttasr_torch.ops import decoder_mlp as tmlp

FLOAT_REL = 2e-3
D = 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=FLOAT_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _weight(rng, shape, scale=0.05):
    w = quantize_tensor((rng.standard_normal(shape) * scale).astype(np.float32))
    return np.asarray(w["q"]), np.asarray(w["s"])


def _vec(rng, n, scale=0.02, offset=0.0):
    return (rng.standard_normal(n) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("r", [5, 16])
def test_matmul_int8_partial_matches_pallas(r):
    rng = np.random.default_rng(r)
    x = (rng.standard_normal((r, D // 2)) * 0.3).astype(np.float32)
    wq, _ = _weight(rng, (D // 2, D))
    _, ws = _weight(rng, (D, D))  # the full width's column scales
    want = jblk.matmul_int8_partial(jnp.asarray(x), wq, ws, interpret=True)
    got = tblk.matmul_int8_partial(*map(_t, (x, wq, ws)))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("partial", [True, False])
def test_mlp_int8_fused_matches_pallas(partial):
    rng = np.random.default_rng(7 + partial)
    r, f = 8, 256  # a shard's half of ffn 512
    x = (rng.standard_normal((r, D)) * 0.3).astype(np.float32)
    w1, w1s = _weight(rng, (D, f))
    w2, _ = _weight(rng, (f, D))
    _, w2s = _weight(rng, (2 * f, D))
    args = (x, _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1), w1, w1s,
            _vec(rng, f), w2, w2s, _vec(rng, D))
    # tile=128 splits the hidden sum over 2 grid steps
    want = jmlp.mlp_int8_fused(*map(jnp.asarray, args), tile=128,
                               interpret=True, partial=partial)
    got = tmlp.mlp_int8_fused(*map(_t, args), partial=partial)
    assert got.dtype == torch.float32
    _close(got, want)


def _cross_kv(rng, b, s, h, int4):
    kv = (rng.standard_normal((2, b, s, h, 64)) * 0.5).astype(np.float32)
    out = []
    for i in range(2):
        c, sc = quantize_kv_sym(jnp.asarray(kv[i]), 7 if int4 else 127)
        c = jnp.asarray(c).reshape(b, s, h * 64)
        out += [np.asarray(pack_int4(c) if int4 else c),
                np.ascontiguousarray(np.swapaxes(np.asarray(sc), 1, 2))]
    return out


# every pair of (local heads, (B, K), int4 or int8) in four cases
@pytest.mark.parametrize("h_loc,b,k,int4", [(2, 1, 3, True), (4, 2, 1, True),
                                           (2, 2, 1, False), (4, 1, 3, False)])
def test_ln_q_cross_int8_matches_pallas(h_loc, b, k, int4):
    s, s_real = 48, 45
    dc = h_loc * 64
    rng = np.random.default_rng(100 * h_loc + 10 * b + k)
    xo = (rng.standard_normal((b, k, D)) * 0.3).astype(np.float32)
    wqc, wqc_s = _weight(rng, (D, dc))
    ck, cks, cv, cvs = _cross_kv(rng, b, s, h_loc, int4)
    args = (xo, _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1), wqc, wqc_s,
            _vec(rng, dc), ck, cks, cv, cvs)
    want = jblk.ln_q_cross_int8(*map(jnp.asarray, args), s_real=s_real,
                                interpret=True)
    got = tblk.ln_q_cross_int8(*map(_t, args), s_real=s_real)
    assert got.shape == (b, k, dc)
    _close(got, want)


@pytest.mark.parametrize("int4", [True, False])
def test_attnout_ln_q_cross_int8_at_a_shard_width(int4):
    """B3 under TP v1: full-width x, attn and wo, the shard's 2 heads of
    cross query and cross-KV (DC = 128 < D)."""
    b, k, h_loc, s, s_real = 1, 3, 2, 48, 45
    rng = np.random.default_rng(11 + int4)
    x = (rng.standard_normal((b, k, D)) * 0.3).astype(np.float32)
    attn = (rng.standard_normal((b, k, D)) * 0.3).astype(np.float32)
    wo, wo_s = _weight(rng, (D, D))
    wqc, wqc_s = _weight(rng, (D, h_loc * 64))
    ck, cks, cv, cvs = _cross_kv(rng, b, s, h_loc, int4)
    args = (x, attn, wo, wo_s, _vec(rng, D), _vec(rng, D, 0.1, 1.0),
            _vec(rng, D, 0.1), wqc, wqc_s, _vec(rng, h_loc * 64),
            ck, cks, cv, cvs)
    xo_j, cross_j = jblk.attnout_ln_q_cross_int8(
        *map(jnp.asarray, args), s_real=s_real, interpret=True)
    xo_t, cross_t = tblk.attnout_ln_q_cross_int8(*map(_t, args), s_real=s_real)
    _close(xo_t, xo_j)
    _close(cross_t, cross_j)


def test_tp_wrappers_reject_other_devices():
    """On anything but a CPU tensor the wrappers launch their kernel or
    raise; they never fall back to the plain version."""
    rng = np.random.default_rng(0)
    x = torch.zeros((5, D // 2), device="meta")
    wq, ws = map(_t, _weight(rng, (D // 2, D)))
    with pytest.raises(ValueError, match="no kernel"):
        tblk.matmul_int8_partial(x, wq, ws)
    with pytest.raises(ValueError, match="no kernel"):
        tmlp.mlp_int8_fused(torch.zeros((5, D), device="meta"), *([None] * 8))
    with pytest.raises(ValueError, match="no kernel"):
        tblk.ln_q_cross_int8(torch.zeros((1, 3, D), device="meta"), *([None] * 9),
                             s_real=1)
