"""B9 and B5 reading the s8 x s8 GEMM's int32 accumulators, on the CPU.

``gelu_quant_acc`` and ``ln_quant_acc`` (``ttasr_torch/ops/encoder_fused.py``)
fold W1's and W2's epilogue (``acc * xs * w_scale + b``, rounded to bf16)
and, for B5, the residual add into the row kernels.  Their plain versions:

- equal the composite of today's plain pieces bit for bit
  (``quant_matmul_act8`` then ``gelu_quant``; ``quant_matmul_act8``, the
  bf16 ``x + y`` and ``ln_quant``), on rows of different magnitude, some
  accumulators beyond 2**24 where the int -> float conversion rounds;
- agree with the JAX package on the same int8 codes:
  ``ttasr.ops.quant.quant_matmul_act8`` (eager), the bf16 add for B5, and
  the Pallas ``gelu_quant`` / ``ln_quant`` in interpret mode, within the JAX
  tests' envelope (codes |delta| <= 1 on under 0.1 % of entries, row scales
  rtol 1e-6) and ``x'`` bit for bit.

The port's fused-quant ``encode`` is bit-identical to an explicit loop of
today's route (``ln_quant`` + attention + ``add_ln_quant`` +
``quant_matmul_act8`` + ``gelu_quant`` + ``quant_matmul_act8`` + ``x + y``
per layer) on micro-size quantized weights with random biases and
LayerNorms, at 1 layer (layer 0 is the last) and 3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ttasr.ops import encoder_fused_pallas as j_fused
from ttasr.ops import quant as j_quant
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS
from ttasr_torch.ops import encoder_fused as t_fused
from ttasr_torch.ops import quant as t_quant

K_BIG = 1056  # 127 * 127 * 1056 > 2**24: the accumulator -> f32 rounds


def _case(seed, k, n, rows):
    """Seeded int8 codes (2, rows, k) with row scales of different
    magnitude, a quantized (k, n) weight and a bf16 bias; a few rows and
    columns all +-127, so some accumulators reach 127 * 127 * k."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (2, rows, k), dtype=np.int8)
    xq[0, :3] = 127
    xq[1, 5] = -127
    xs = (rng.uniform(1e-3, 2e-2, (2, rows, 1))
          * rng.uniform(0.05, 4.0, (2, rows, 1))).astype(np.float32)
    w = rng.standard_normal((k, n)) * 0.02
    w[:, :4] = np.abs(w[:, :4]).max()  # columns of code 127
    leaf = j_quant.quantize_tensor(jnp.asarray(w, jnp.float32))
    b = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16)
    tleaf = {"q": torch.tensor(np.asarray(leaf["q"])),
             "s": torch.tensor(np.asarray(leaf["s"]))}
    tb = torch.tensor(np.asarray(b.astype(jnp.float32))).to(torch.bfloat16)
    return xq, xs, leaf, b, tleaf, tb


def _bf16(jx):
    return torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)


def _assert_envelope(got_q, got_s, want_q, want_s):
    dq = got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32)
    assert np.abs(dq).max() <= 1, np.abs(dq).max()
    assert (dq != 0).mean() < 1e-3, (dq != 0).mean()
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


def _accumulators(xq, tleaf):
    acc = t_quant.int8_accumulators(torch.from_numpy(xq), tleaf)
    assert acc.dtype == torch.int32
    return acc


@pytest.mark.parametrize("k", [256, K_BIG])
def test_gelu_quant_acc_ref_is_the_parent_route(k):
    xq, xs, _, _, tleaf, tb = _case(k, k, 512, 256)
    acc = _accumulators(xq, tleaf)
    assert acc.abs().max().item() > (2 ** 24 if k == K_BIG else 0)
    txs = torch.from_numpy(xs)
    h = t_quant.quant_matmul_act8(torch.from_numpy(xq), txs, tleaf, tb,
                                  out_dtype=torch.bfloat16)
    want = t_fused.gelu_quant_ref(h)
    got = t_fused.gelu_quant_acc(acc, txs, tleaf["s"], tb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("k", [512, K_BIG])
def test_ln_quant_acc_ref_is_the_parent_route(k):
    d = 256
    xq, xs, _, _, tleaf, tb = _case(k + 1, k, d, 512)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((2, 512, d)).astype(np.float32)
                         * 2.0).to(torch.bfloat16)
    ln_s = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(np.float32)).to(
        torch.bfloat16)
    ln_b = torch.from_numpy(0.1 * rng.standard_normal(d).astype(np.float32)).to(
        torch.bfloat16)
    acc = _accumulators(xq, tleaf)
    txs = torch.from_numpy(xs)
    y = t_quant.quant_matmul_act8(torch.from_numpy(xq), txs, tleaf, tb,
                                  out_dtype=torch.bfloat16)
    x2 = x + y
    want = (x2, *t_fused.ln_quant_ref(x2, ln_s, ln_b))
    got = t_fused.ln_quant_acc(x, acc, txs, tleaf["s"], tb, ln_s, ln_b)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("k", [256, K_BIG])
def test_gelu_quant_acc_matches_jax(k):
    xq, xs, leaf, b, tleaf, tb = _case(k + 2, k, 512, 256)
    h = j_quant.quant_matmul_act8(xq, xs, leaf, b, out_dtype=jnp.bfloat16)
    want = j_fused.gelu_quant(h, interpret=True)
    got = t_fused.gelu_quant_acc(_accumulators(xq, tleaf), torch.from_numpy(xs),
                                 tleaf["s"], tb)
    _assert_envelope(*got, *want)


@pytest.mark.parametrize("k", [512, K_BIG])
def test_ln_quant_acc_matches_jax(k):
    d = 256
    xq, xs, leaf, b, tleaf, tb = _case(k + 3, k, d, 512)
    rng = np.random.default_rng(k + 4)
    jx = jnp.asarray(rng.standard_normal((2, 512, d)) * 2.0, jnp.bfloat16)
    js = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.bfloat16)
    jb = jnp.asarray(0.1 * rng.standard_normal(d), jnp.bfloat16)
    jx2 = jx + j_quant.quant_matmul_act8(xq, xs, leaf, b, out_dtype=jnp.bfloat16)
    jq, jsc = j_fused.ln_quant(jx2, js, jb, interpret=True)
    x2, q, s = t_fused.ln_quant_acc(_bf16(jx), _accumulators(xq, tleaf),
                                    torch.from_numpy(xs), tleaf["s"], tb,
                                    _bf16(js), _bf16(jb))
    np.testing.assert_array_equal(x2.float().numpy(),
                                  np.asarray(jx2.astype(jnp.float32)))
    _assert_envelope(q, s, jq, jsc)


def _weights(layers: int, fuse: bool):
    """micro64-test widths, ``layers`` encoder layers, bf16, quantized as
    the int8 engine does, with seeded biases and LayerNorms."""
    cfg = dataclasses.replace(PRESETS["micro64-test"], encoder_layers=layers)
    params = tm.init_params(cfg, seed=3, dtype=torch.bfloat16)
    rng = np.random.default_rng(layers)
    for blk in params["encoder"]["blocks"]:
        for name in ("bq", "bv", "bo", "b1", "b2", "ln1_b", "ln2_b"):
            blk[name] = torch.from_numpy(rng.standard_normal(blk[name].shape).astype(
                np.float32) * 0.1).to(torch.bfloat16)
        for name in ("ln1_s", "ln2_s"):
            blk[name] = torch.from_numpy(1 + rng.standard_normal(blk[name].shape).astype(
                np.float32) * 0.1).to(torch.bfloat16)
    params = t_quant.quantize_params(params)
    if fuse:
        params = t_quant.fuse_qkv(params)
    params = t_quant.kmajor_encoder_codes(params)
    mel = torch.from_numpy((np.random.default_rng(7).standard_normal((2, 80, 600))
                            * 0.5).astype(np.float32))
    return cfg, params, mel


def _parent_encode(params, cfg, mel):
    """Today's fused-quant route, written out: the bf16 W1 and W2 outputs,
    ``gelu_quant``, the eager residual add and ``ln_quant`` every layer."""
    enc = params["encoder"]
    x = mel.to(torch.bfloat16)
    x = F.gelu(F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), enc["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), enc["conv2_b"],
                        stride=2, padding=1))
    x = x.transpose(1, 2)
    x = (x.to(enc["pos"].dtype) + enc["pos"][: x.shape[1]]).contiguous()
    t_real = x.shape[1]
    for blk in enc["blocks"]:
        q1, s1 = t_fused.ln_quant(x, blk["ln1_s"], blk["ln1_b"])
        attn = tm._self_attn_act8(x, blk, cfg.encoder_heads, t_real, x_quant=(q1, s1),
                                  fused_quant=True)
        x, q2, s2 = t_fused.add_ln_quant(x, attn, blk["ln2_s"], blk["ln2_b"])
        h = t_quant.quant_matmul_act8(q2, s2, blk["w1"], blk["b1"],
                                      out_dtype=torch.bfloat16)
        hq, hs = t_fused.gelu_quant(h)
        x = x + t_quant.quant_matmul_act8(hq, hs, blk["w2"], blk["b2"],
                                          out_dtype=torch.bfloat16)
    return tm._ln(x, enc["ln_s"], enc["ln_b"])


@pytest.mark.parametrize("layers,fuse", [(1, True), (3, True), (3, False)],
                         ids=["1-layer", "3-layers", "3-layers-separate-qkv"])
def test_fused_quant_encode_is_the_parent_route(layers, fuse):
    cfg, params, mel = _weights(layers, fuse)
    want = _parent_encode(params, cfg, mel)
    got = tm.encode(params, cfg, mel)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["gelu_quant_acc", "ln_quant_acc"])
def test_acc_wrappers_raise_off_cpu_and_cuda(name):
    x = torch.empty((1, 32, 192), dtype=torch.bfloat16, device="meta")
    acc = torch.empty((1, 32, 192), dtype=torch.int32, device="meta")
    xs = torch.empty((1, 32, 1), device="meta")
    v = torch.empty(192, device="meta")
    calls = {"gelu_quant_acc": lambda: t_fused.gelu_quant_acc(acc, xs, v, v),
             "ln_quant_acc": lambda: t_fused.ln_quant_acc(x, acc, xs, v, v, v, v)}
    with pytest.raises(ValueError, match="meta"):
        calls[name]()
