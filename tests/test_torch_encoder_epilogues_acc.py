"""B8 and the qkv GEMM's epilogue reading the s8 x s8 GEMM's int32
accumulators, on the CPU.

``add_ln_quant_acc`` folds wo's epilogue (``acc * xs * w_scale + b``,
rounded to bf16) into B8, whose LayerNorm reads the f32 sum of x and that
output; ``qkv_epilogue_acc`` writes the fused qkv GEMM's bf16 output, the
buffer B6 reads, with the dh**-0.5 query scale folded into the q third of
the weight scales and bias (``ttasr_torch/ops/encoder_fused.py``).  Their
plain versions:

- equal the parent route's pieces bit for bit (``act8_epilogue`` then
  ``add_ln_quant``; the per-call column scale, then ``quant_matmul_act8``),
  on rows of different magnitude, some accumulators beyond 2**24 where the
  int -> float conversion rounds;
- agree with the JAX package on the same int8 codes: its eager
  ``quant_matmul_act8`` then the Pallas ``add_ln_quant`` in interpret mode
  (the residual bit for bit, codes |delta| <= 1 on under 0.1 % of entries,
  row scales rtol 1e-6), and its eager ``quant_matmul_act8`` on the scaled
  leaf and bias (``ttasr/models/whisper/model.py:264-269``) bit for bit.

The port's fused-quant ``encode`` is bit-identical to an explicit loop of
the parent route (the qkv and wo torch epilogues, the bf16
``add_ln_quant``) on micro-size quantized weights with random biases and
LayerNorms, at 1 layer and 3, and with separate q/k/v leaves, where only
wo's epilogue moves; and on float32 weights, where the two epilogues
round to float32 as the parent's did (the JAX encoder's ``out_dtype=
x.dtype``), not to bf16.  W1's and W2's outputs, by contrast, are bf16 on an
f32 layer in both packages (``_mlp_act8`` with ``x_quant``): an f32 layer's
MLP through JAX and through the port, h and y held to each other.
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
from ttasr_torch.ops.encoder_attention import (
    encoder_attention_merged,
    encoder_attention_merged_qkv,
)

K_BIG = 1056  # 127 * 127 * 1056 > 2**24: the accumulator -> f32 rounds
ROWS = 512  # two of the Pallas kernels' 256-row tiles


def _case(seed, k, n, bias=True):
    """Seeded int8 codes (2, ROWS, k) with row scales of different
    magnitude, a quantized (k, n) weight and a bf16 bias (or None); a few
    rows and columns all +-127, so some accumulators reach 127 * 127 * k.
    Returns the JAX operands, the port's, and the port's accumulators."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (2, ROWS, k), dtype=np.int8)
    xq[0, :3] = 127
    xq[1, 5] = -127
    xs = (rng.uniform(1e-3, 2e-2, (2, ROWS, 1))
          * rng.uniform(0.05, 4.0, (2, ROWS, 1))).astype(np.float32)
    w = rng.standard_normal((k, n)) * 0.02
    w[:, :4] = np.abs(w[:, :4]).max()  # columns of code 127
    leaf = j_quant.quantize_tensor(jnp.asarray(w, jnp.float32))
    b = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16) if bias else None
    tleaf = {"q": torch.tensor(np.asarray(leaf["q"])),
             "s": torch.tensor(np.asarray(leaf["s"]))}
    tb = None if b is None else _bf16(b)
    acc = t_quant.int8_accumulators(torch.from_numpy(xq), tleaf)
    assert acc.dtype == torch.int32
    assert acc.abs().max().item() > (2 ** 24 if k == K_BIG else 0)
    return (xq, xs, leaf, b), (torch.from_numpy(xq), torch.from_numpy(xs), tleaf, tb), acc


def _bf16(jx):
    return torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)


def _residual_and_ln(seed, d):
    """bf16 x (2, ROWS, d) and LayerNorm scale and bias, as JAX arrays."""
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((2, ROWS, d)) * 2.0, jnp.bfloat16),
            jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.bfloat16),
            jnp.asarray(0.1 * rng.standard_normal(d), jnp.bfloat16))


def _assert_envelope(got_q, got_s, want_q, want_s):
    dq = got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32)
    assert np.abs(dq).max() <= 1, np.abs(dq).max()
    assert (dq != 0).mean() < 1e-3, (dq != 0).mean()
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


@pytest.mark.parametrize("k,bias", [(512, True), (K_BIG, True), (K_BIG, False)])
def test_add_ln_quant_acc_ref_is_the_parent_route(k, bias):
    d = 256
    _, (xq, xs, tleaf, tb), acc = _case(k, k, d, bias)
    x, ln_s, ln_b = map(_bf16, _residual_and_ln(k + 1, d))
    y = t_quant.quant_matmul_act8(xq, xs, tleaf, tb, out_dtype=torch.bfloat16)
    want = t_fused.add_ln_quant_ref(x, y, ln_s, ln_b)
    got = t_fused.add_ln_quant_acc(x, acc, xs, tleaf["s"], tb, ln_s, ln_b)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("k", [512, K_BIG])
def test_add_ln_quant_acc_matches_jax(k):
    d = 256
    (jxq, jxs, leaf, b), (_, xs, tleaf, tb), acc = _case(k + 2, k, d)
    jx, js, jb = _residual_and_ln(k + 3, d)
    jy = j_quant.quant_matmul_act8(jxq, jxs, leaf, b, out_dtype=jnp.bfloat16)
    jx2, jq, jsc = j_fused.add_ln_quant(jx, jy, js, jb, interpret=True)
    x2, q, s = t_fused.add_ln_quant_acc(_bf16(jx), acc, xs, tleaf["s"], tb,
                                        _bf16(js), _bf16(jb))
    np.testing.assert_array_equal(x2.float().numpy(),
                                  np.asarray(jx2.astype(jnp.float32)))
    _assert_envelope(q, s, jq, jsc)


def _colscale(n, q_scale):
    colscale = torch.ones(n, dtype=torch.float32)
    colscale[: n // 3] = q_scale
    return colscale


# 64**-0.5 is large-v3's (exact in f32); 80**-0.5 is not a power of two
@pytest.mark.parametrize("k,q_scale,bias", [(384, 64 ** -0.5, True),
                                            (K_BIG, 64 ** -0.5, True),
                                            (K_BIG, 80 ** -0.5, False)])
def test_qkv_epilogue_acc_ref_is_the_parent_route(k, q_scale, bias):
    n = 3 * 128
    _, (xq, xs, tleaf, tb), acc = _case(k + 4, k, n, bias)
    colscale = _colscale(n, q_scale)
    leaf = {"q": tleaf["q"], "s": tleaf["s"] * colscale}
    want = t_quant.quant_matmul_act8(xq, xs, leaf, None if tb is None else tb * colscale,
                                     out_dtype=torch.bfloat16)
    got = t_fused.qkv_epilogue_acc(acc, xs, tleaf["s"], tb, q_scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,q_scale", [(384, 64 ** -0.5), (K_BIG, 64 ** -0.5),
                                       (K_BIG, 80 ** -0.5)])
def test_qkv_epilogue_acc_matches_jax(k, q_scale):
    n = 3 * 128
    (jxq, jxs, leaf, b), (_, xs, tleaf, tb), acc = _case(k + 5, k, n)
    colscale = jnp.concatenate([jnp.full((n // 3,), q_scale, jnp.float32),
                                jnp.ones((2 * n // 3,), jnp.float32)])
    want = j_quant.quant_matmul_act8(jxq, jxs, {"q": leaf["q"], "s": leaf["s"] * colscale},
                                     b * colscale, out_dtype=jnp.bfloat16)
    got = t_fused.qkv_epilogue_acc(acc, xs, tleaf["s"], tb, q_scale)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _weights(layers: int, fuse: bool, dtype=torch.bfloat16):
    """micro64-test widths, ``layers`` encoder layers in ``dtype``,
    quantized as the int8 engine does, with seeded biases and
    LayerNorms."""
    cfg = dataclasses.replace(PRESETS["micro64-test"], encoder_layers=layers)
    params = tm.init_params(cfg, seed=5, dtype=dtype)
    rng = np.random.default_rng(layers + 10)
    for blk in params["encoder"]["blocks"]:
        for name in ("bq", "bv", "bo", "b1", "b2", "ln1_b", "ln2_b"):
            blk[name] = torch.from_numpy(rng.standard_normal(blk[name].shape).astype(
                np.float32) * 0.1).to(dtype)
        for name in ("ln1_s", "ln2_s"):
            blk[name] = torch.from_numpy(1 + rng.standard_normal(blk[name].shape).astype(
                np.float32) * 0.1).to(dtype)
    params = t_quant.quantize_params(params)
    if fuse:
        params = t_quant.fuse_qkv(params)
    params = t_quant.kmajor_encoder_codes(params)
    mel = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 80, 600))
                            * 0.5).astype(np.float32))
    return cfg, params, mel


def _parent_attention(x, blk, n_heads, t_real, x_quant):
    """The parent route's attention block: the dh**-0.5 column scale built
    per call and the qkv GEMM's torch epilogue (or three GEMMs for separate
    q/k/v leaves), B6 (or B11), ``quant_only`` and wo's torch epilogue."""
    xq, xs = x_quant
    d = x.shape[-1]
    qs = (d // n_heads) ** -0.5
    dt = x.dtype
    if "wqkv" in blk:
        w = blk["wqkv"]
        colscale = _colscale(3 * d, qs)
        qkv = t_quant.quant_matmul_act8(xq, xs, {"q": w["q"], "s": w["s"] * colscale},
                                        blk["bqkv"] * colscale, out_dtype=dt)
        out_m = encoder_attention_merged_qkv(qkv, t_real)
    else:
        qm = t_quant.quant_matmul_act8(xq, xs * qs, blk["wq"], blk["bq"] * qs,
                                       out_dtype=dt)
        km = t_quant.quant_matmul_act8(xq, xs, blk["wk"], out_dtype=dt)
        vm = t_quant.quant_matmul_act8(xq, xs, blk["wv"], blk["bv"], out_dtype=dt)
        out_m = encoder_attention_merged(qm, km, vm, t_real)
    oq, os_ = t_fused.quant_only(out_m)
    return t_quant.quant_matmul_act8(oq, os_, blk["wo"], blk["bo"], out_dtype=dt)


def _parent_encode(params, cfg, mel):
    """The parent's fused-quant route, written out: B5 from x, then from
    W2's accumulators, the parent attention block, the eager wo output into
    the bf16 ``add_ln_quant``, W1's accumulators into ``gelu_quant_acc``."""
    enc = params["encoder"]
    x = mel.to(enc["conv1_w"].dtype)
    x = F.gelu(F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), enc["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), enc["conv2_b"],
                        stride=2, padding=1))
    x = x.transpose(1, 2)
    x = (x.to(enc["pos"].dtype) + enc["pos"][: x.shape[1]]).contiguous()
    t_real = x.shape[1]
    w2 = None
    for blk in enc["blocks"]:
        if w2 is None:
            q1, s1 = t_fused.ln_quant(x, blk["ln1_s"], blk["ln1_b"])
        else:
            x, q1, s1 = t_fused.ln_quant_acc(x, *w2, blk["ln1_s"], blk["ln1_b"])
        attn = _parent_attention(x, blk, cfg.encoder_heads, t_real, (q1, s1))
        x, q2, s2 = t_fused.add_ln_quant(x, attn, blk["ln2_s"], blk["ln2_b"])
        hq, hs = t_fused.gelu_quant_acc(t_quant.int8_accumulators(q2, blk["w1"]), s2,
                                        blk["w1"]["s"], blk["b1"])
        w2 = t_quant.int8_accumulators(hq, blk["w2"]), hs, blk["w2"]["s"], blk["b2"]
    x = x + t_quant.act8_epilogue(*w2, out_dtype=torch.bfloat16)
    return tm._ln(x, enc["ln_s"], enc["ln_b"])


@pytest.mark.parametrize("layers,fuse,dtype", [
    (1, True, torch.bfloat16), (3, True, torch.bfloat16), (3, False, torch.bfloat16),
    (3, True, torch.float32)],
    ids=["1-layer", "3-layers", "3-layers-separate-qkv", "3-layers-f32"])
def test_fused_quant_encode_is_the_parent_route(layers, fuse, dtype):
    cfg, params, mel = _weights(layers, fuse, dtype)
    want = _parent_encode(params, cfg, mel)
    got = tm.encode(params, cfg, mel)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["add_ln_quant_acc", "qkv_epilogue_acc"])
def test_epilogue_wrappers_raise_off_cpu_and_cuda(name):
    x = torch.empty((1, 32, 192), dtype=torch.bfloat16, device="meta")
    acc = torch.empty((1, 32, 192), dtype=torch.int32, device="meta")
    xs = torch.empty((1, 32, 1), device="meta")
    v = torch.empty(192, device="meta")
    calls = {"add_ln_quant_acc": lambda: t_fused.add_ln_quant_acc(x, acc, xs, v, v, v, v),
             "qkv_epilogue_acc": lambda: t_fused.qkv_epilogue_acc(acc, xs, v, v, 0.125)}
    with pytest.raises(ValueError, match="meta"):
        calls[name]()


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_layer_mlp_rounds_h_and_y_to_bf16_as_jax_does(seed):
    """An f32 fused-quant encoder layer's MLP: JAX's ``_mlp_act8`` with
    ``x_quant`` given takes ``out_dtype=bfloat16`` for W1 and ``h.dtype``
    for W2 (``ttasr/models/whisper/model.py:313-323``), so h and y are bf16
    on float32 weights too; the port's ``_mlp_act8_acc`` (``gelu_quant_acc``
    on W1's accumulators) and W2's epilogue tail (``encode``'s last layer,
    ``ln_quant_acc``'s add in the next) round them alike.  On the same
    seeded codes and f32 weights and biases: h bit for bit, the hidden codes
    within the envelope (|delta| <= 1 on under 0.1 %, scales rtol 1e-6),
    y bit for bit on rows whose codes agree and within 1e-2 x max |y|
    elsewhere (a code one step off moves its row), and the next layer's
    residual x + y in f32 alike."""
    from ttasr.models.whisper.model import _mlp_act8 as j_mlp_act8

    d, f = 256, 1024
    rng = np.random.default_rng(seed)
    q2 = rng.integers(-127, 128, (2, ROWS, d), dtype=np.int8)
    s2 = (rng.uniform(1e-3, 2e-2, (2, ROWS, 1))
          * rng.uniform(0.05, 4.0, (2, ROWS, 1))).astype(np.float32)
    w1, w2 = (j_quant.quantize_tensor(jnp.asarray(rng.standard_normal(shape) * 0.05,
                                                  jnp.float32))
              for shape in ((d, f), (f, d)))
    b1, b2 = (jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32) for n in (f, d))
    x = jnp.asarray(rng.standard_normal((2, ROWS, d)), jnp.float32)
    jq = (jnp.asarray(q2), jnp.asarray(s2))
    jy = j_mlp_act8(x, {"w1": w1, "b1": b1, "w2": w2, "b2": b2}, x_quant=jq,
                    fused_quant=True, interpret=True)
    jh = j_quant.quant_matmul_act8(*jq, w1, b1, out_dtype=jnp.bfloat16)  # _mlp_act8's h
    jhq, jhs = j_fused.gelu_quant(jh, interpret=True)

    def leaf(w):
        return {"q": torch.tensor(np.asarray(w["q"])), "s": torch.tensor(np.asarray(w["s"]))}

    blk = {"w1": leaf(w1), "w2": leaf(w2), "b1": torch.tensor(np.asarray(b1)),
           "b2": torch.tensor(np.asarray(b2))}
    tq = (torch.from_numpy(q2), torch.from_numpy(s2))
    acc1 = t_quant.int8_accumulators(tq[0], blk["w1"])
    h = t_quant.act8_epilogue(acc1, tq[1], blk["w1"]["s"], blk["b1"], torch.bfloat16)
    hq, hs = t_fused.gelu_quant_acc(acc1, tq[1], blk["w1"]["s"], blk["b1"])
    w2_ops = tm._mlp_act8_acc(blk, tq)
    y = t_quant.act8_epilogue(*w2_ops, out_dtype=torch.bfloat16)
    assert jh.dtype == jy.dtype == jnp.bfloat16 and y.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(), np.asarray(jh.astype(jnp.float32)))
    _assert_envelope(hq, hs, jhq, jhs)
    torch.testing.assert_close(w2_ops[1], hs, rtol=0, atol=0)
    jyf, yf = np.asarray(jy.astype(jnp.float32)), y.float().numpy()
    same = (hq.numpy() == np.asarray(jhq)).all(-1)
    np.testing.assert_array_equal(yf[same], jyf[same])
    assert np.abs(yf - jyf).max() <= 1e-2 * np.abs(jyf).max()
    # not the float32 rounding of the layer's own type
    assert not np.array_equal(t_quant.act8_epilogue(*w2_ops, out_dtype=torch.float32).numpy(),
                              jyf)
    tx = torch.from_numpy(np.asarray(x))
    ln_s, ln_b = torch.ones(d), torch.zeros(d)
    x2 = t_fused.ln_quant_acc_ref(tx, *w2_ops, ln_s, ln_b)[0]
    assert x2.dtype == torch.float32
    np.testing.assert_array_equal(x2[torch.from_numpy(same)].numpy(),
                                  np.asarray(x + jy)[same])
