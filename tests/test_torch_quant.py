"""The port's int8 weights, K/V quantizers, int4 packings and quantized
caches against the JAX package, bit for bit, on ``micro64-test`` and seeded
numpy inputs.

The JAX decode quantizes its caches only inside jitted programs, where XLA
turns ``max(absmax, 1e-8) / levels`` into a multiply by the f32 reciprocal
of the constant ``levels``; the port computes the scale that way too, so
its cache quantizers are compared with the jitted JAX functions.  Weight
quantization runs eagerly in the JAX engine, and is compared eagerly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.ops import int4 as jint4
from ttasr.ops import quant as jquant
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops import int4 as tint4
from ttasr_torch.ops import quant as tquant

NAME = "micro64-test"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_leaf(port, want, where):
    """A port leaf (tensor or {"q", "s"}) equals the JAX leaf exactly."""
    if isinstance(want, dict):
        assert set(port) == {"q", "s"}, where
        assert port["q"].dtype == torch.int8, where
        assert port["s"].dtype == torch.float32, where
        np.testing.assert_array_equal(port["q"].numpy(), want["q"], err_msg=where)
        np.testing.assert_array_equal(port["s"].numpy(), want["s"], err_msg=where)
    else:
        np.testing.assert_array_equal(port.float().numpy(),
                                      np.asarray(want, np.float32), err_msg=where)


def _assert_tree(port, want):
    """Port params (per-layer lists) equal a stacked JAX tree leaf by leaf."""
    for part in ("encoder", "decoder"):
        for key, leaf in want[part].items():
            if key != "blocks":
                _assert_leaf(port[part][key], leaf, f"{part}.{key}")
                continue
            assert len(port[part]["blocks"]) == len(
                next(iter(leaf.values()))["q"] if isinstance(
                    next(iter(leaf.values())), dict) else next(iter(leaf.values())))
            for i, blk in enumerate(port[part]["blocks"]):
                assert set(blk) == set(leaf), (part, i)
                for name, stacked in leaf.items():
                    layer = ({k: v[i] for k, v in stacked.items()}
                             if isinstance(stacked, dict) else stacked[i])
                    _assert_leaf(blk[name], layer, f"{part}.blocks[{i}].{name}")


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(J_PRESETS[NAME], seed=0)


def test_params_from_jax_carries_the_int8_tree(jax_params):
    """fuse_qkv(quantize_params(...)) from JAX: {"q", "s"} leaves stay int8
    codes and f32 scales whatever the float dtype, unstacked per layer."""
    jq = _np_tree(jquant.fuse_qkv(jquant.quantize_params(jax_params)))
    assert "wqkv" in jq["decoder"]["blocks"] and "wqkv" in jq["encoder"]["blocks"]
    _assert_tree(params_from_jax(jq), jq)
    bf16 = params_from_jax(jq, dtype=torch.bfloat16)
    blk = bf16["decoder"]["blocks"][1]
    assert blk["wqkv"]["q"].dtype == torch.int8
    assert blk["wqkv"]["s"].dtype == torch.float32
    assert blk["ln1_s"].dtype == torch.bfloat16
    assert bf16["decoder"]["embed"]["q"].shape == jq["decoder"]["embed"]["q"].shape


def test_quantize_params_and_fuse_qkv_match_jax(jax_params):
    want = _np_tree(jquant.fuse_qkv(jquant.quantize_params(jax_params)))
    got = tquant.fuse_qkv(tquant.quantize_params(
        params_from_jax(_np_tree(jax_params))))
    _assert_tree(got, want)
    # embed: one scale per vocab row; the fused k-bias slot is zero
    emb = got["decoder"]["embed"]
    assert emb["s"].shape == (emb["q"].shape[0], 1)
    d = J_PRESETS[NAME].d_model
    assert not got["decoder"]["blocks"][0]["bqkv"][d:2 * d].any()
    # unquantized params pass fuse_qkv unchanged
    plain = params_from_jax(_np_tree(jax_params))
    assert tquant.fuse_qkv(plain) is plain


@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_kv_sym_matches_jax(levels):
    rng = np.random.default_rng(levels)
    x = (rng.standard_normal((3, 12, 4, 64)) * 2).astype(np.float32)
    # heads whose scale is exactly 1/8: the max at levels/8, the rest at
    # (k + 0.5)/8, so x / scale lands exactly on .5 and rounds to even
    x[0, :, 0] = (rng.integers(-levels, levels, (12, 64)) + 0.5) / 8
    x[0, :, 0, 0] = levels / 8
    want_q, want_s = jax.jit(partial(jquant.quantize_kv_sym, levels=levels))(x)
    got_q, got_s = tquant.quantize_kv_sym(torch.from_numpy(x), levels)
    ratio = x[0, :, 0] / np.asarray(want_s)[0, :, 0, None]
    assert (np.abs(ratio - np.trunc(ratio)) == 0.5).sum() > 100  # ties hit
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.abs(got_q.numpy()).max() <= levels


def test_quantize_tensor_matches_jax_on_ties():
    """Weight codes round half to even like jnp.round (eager, as the JAX
    engine quantizes)."""
    rng = np.random.default_rng(3)
    w = (rng.integers(-126, 126, (64, 48)) + 0.5).astype(np.float32) / 127
    w[0] = 1.0  # absmax 1 per column -> scale 1/127, ratios k + 0.5
    want = jquant.quantize_tensor(w)
    got = tquant.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(tquant.dequantize_tensor(got).numpy(),
                                  np.asarray(jquant.dequantize_tensor(want)))
    assert tquant.is_quantized(got) and not tquant.is_quantized(got["q"])


@pytest.mark.parametrize("lanes", [False, True])
def test_int4_packings_match_jax(lanes):
    rng = np.random.default_rng(int(lanes))
    q = rng.integers(-8, 8, (3, 32, 40)).astype(np.int8)
    jpack, junpack = ((jint4.pack_int4_lanes, jint4.unpack_int4_lanes) if lanes
                      else (jint4.pack_int4, jint4.unpack_int4))
    tpack, tunpack = ((tint4.pack_int4_lanes, tint4.unpack_int4_lanes) if lanes
                      else (tint4.pack_int4, tint4.unpack_int4))
    want = np.asarray(jpack(jnp.asarray(q)))
    got = tpack(torch.from_numpy(q))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tunpack(got).numpy(), q)
    lo, hi = tint4._nibble_decode(got)
    jlo, jhi = jint4._nibble_decode(jnp.asarray(want))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("cross_int4,self_int4", [(True, True), (False, False)])
def test_init_cache_quantized_matches_jax(jax_params, cross_int4, self_int4):
    """The flat self-KV (zeros in the fused kernels' layout) and the
    quantized cross-KV of every layer, S padded to a multiple of 16 (int4)
    or 8, scales in the (B, H, S) kernel layout."""
    cfg = J_PRESETS[NAME]
    jp = jquant.fuse_qkv(jquant.quantize_params(jax_params))
    tp = params_from_jax(_np_tree(jp))
    enc = (np.random.default_rng(5).standard_normal((2, 1500, cfg.d_model))
           * 0.5).astype(np.float32)
    flags = dict(max_len=48, beam_expand=3, kv_int8=True, cross_kv_int8=True,
                 cross_kv_int4=cross_int4, flat_kv=True, kv_int4=self_int4)
    want = jax.jit(partial(jm.init_cache, cfg=cfg, **flags))(jp, enc_out=enc)
    got = tm.init_cache(tp, T_PRESETS[NAME], torch.from_numpy(enc), **flags)
    assert got.flat and got.quantized and got.cross_quantized
    assert got.self_int4 == self_int4
    s_pad = 1504  # 1500 padded to a multiple of 16 (int4) or of 8
    assert got.cross_k.shape == (2, 2, s_pad // 2 if cross_int4 else s_pad, 128)
    assert got.cks.shape == (2, 2, 2, s_pad)
    assert got.k.shape == (2, 6, 48, 64 if self_int4 else 128)
    assert got.ks.shape == (2, 6, 8, 48)
    for name in ("k", "v", "cross_k", "cross_v", "ks", "vs", "cks", "cvs"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert str(g.dtype).endswith(str(w.dtype)), (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
