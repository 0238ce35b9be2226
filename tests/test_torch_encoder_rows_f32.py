"""The s8 x s8 encoder's row kernels on float32 rows (the int8 engine on
float32 params, ROADMAP C9) on the CPU against the JAX package.

The Pallas kernels read rows of any float type and write the residual in
its own (``ttasr/ops/encoder_fused_pallas.py``); the port's kernels take
bf16 or float32 rows since the row template was instantiated for both.
Here the port's plain versions of B5 ``ln_quant``, B7 ``quant_only``, B8
``add_ln_quant`` and B9 ``gelu_quant`` on seeded float32 rows (not bf16
values) against the Pallas kernels in interpret mode: B7's and B9's codes
equal, B5's and B8's within the JAX tests' envelope (their LayerNorm's sums
run in another order, so a code on a rounding boundary moves by one: 1 of
262144 here; ``tests/test_encoder_fused.py`` bounds it at 0.1 %), row
scales within rtol 1e-6, and B8's float32 residual bit for bit.  The wrappers keep the rows' type:
a float32 residual comes back float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import encoder_fused_pallas as j_fused
from ttasr_torch.ops import encoder_fused as t_fused


def _f32(shape, seed, scale=1.0):
    """Seeded float32 rows of different magnitude as (jax array, tensor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * scale * rng.uniform(0.05, 4.0, shape[:-1] + (1,))
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _ln_params(d, seed):
    (js, ts), (jb, tb) = _f32((d,), seed, 0.1), _f32((d,), seed + 1, 0.1)
    return js + 1.0, ts + 1.0, jb, tb


def _assert_same(got_q, got_s, want_q, want_s, exact=True):
    if exact:
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    else:
        dq = got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32)
        assert np.abs(dq).max() <= 1, np.abs(dq).max()
        assert (dq != 0).mean() < 1e-3, (dq != 0).mean()
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_ln_quant_on_f32_rows_matches_jax(seed):
    jx, tx = _f32((2, 512, 256), seed)
    js, ts, jb, tb = _ln_params(256, seed + 10)
    _assert_same(*t_fused.ln_quant(tx, ts, tb),
                 *j_fused.ln_quant(jx, js, jb, interpret=True), exact=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_add_ln_quant_on_f32_rows_matches_jax(seed):
    jx, tx = _f32((2, 512, 256), seed)
    jy, ty = _f32((2, 512, 256), seed + 5, 0.5)
    js, ts, jb, tb = _ln_params(256, seed + 10)
    resid, q, s = t_fused.add_ln_quant(tx, ty, ts, tb)
    j_resid, jq, jsc = j_fused.add_ln_quant(jx, jy, js, jb, interpret=True)
    assert resid.dtype == torch.float32 and j_resid.dtype == jnp.float32
    np.testing.assert_array_equal(resid.numpy(), np.asarray(j_resid))
    _assert_same(q, s, jq, jsc, exact=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_quant_only_on_f32_rows_matches_jax(seed):
    jx, tx = _f32((2, 512, 256), seed)
    _assert_same(*t_fused.quant_only(tx), *j_fused.quant_only(jx, interpret=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_gelu_quant_on_f32_rows_matches_jax(seed):
    jh, th = _f32((2, 256, 512), seed, 2.0)
    _assert_same(*t_fused.gelu_quant(th), *j_fused.gelu_quant(jh, interpret=True))


@pytest.mark.parametrize("name", ["ln_quant", "add_ln_quant", "gelu_quant",
                                  "quant_only", "ln_quant_acc", "add_ln_quant_acc",
                                  "qkv_epilogue_acc"])
def test_wrappers_take_f32_rows_off_cpu_too(name):
    """A float32 operand on another device passes the type check and stops
    at the device check (the card's wrappers took bf16 rows only)."""
    x = torch.empty((1, 32, 192), device="meta")
    acc = torch.empty((1, 32, 192), dtype=torch.int32, device="meta")
    xs, v = torch.empty((1, 32, 1), device="meta"), torch.empty(192, device="meta")
    calls = {"ln_quant": lambda: t_fused.ln_quant(x, v, v),
             "add_ln_quant": lambda: t_fused.add_ln_quant(x, x, v, v),
             "gelu_quant": lambda: t_fused.gelu_quant(x),
             "quant_only": lambda: t_fused.quant_only(x),
             "ln_quant_acc": lambda: t_fused.ln_quant_acc(x, acc, xs, v, v, v, v),
             "add_ln_quant_acc": lambda: t_fused.add_ln_quant_acc(x, acc, xs, v, v, v, v),
             "qkv_epilogue_acc": lambda: t_fused.qkv_epilogue_acc(
                 acc, xs, v, v, 0.125, torch.float32)}
    with pytest.raises(ValueError, match="meta"):
        calls[name]()
