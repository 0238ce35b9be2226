"""int8 weight quantization (port of ``ttasr/ops/quant.py``).

Symmetric per-output-channel absmax: a quantized leaf is
``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}``.  Codes are
``clip(round(w / scale), -127, 127)`` with ``scale = max(absmax, 1e-8) /
127``; ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
codes match the JAX package bit for bit.  LayerNorms, biases, the conv
stem and the positional tables stay in the model type.

The port keeps layers as a list of per-layer dicts, so the walk below
quantizes each layer's leaf on its own; per-output-channel scales make
that identical to quantizing the stacked JAX leaf.

The s8 x s8 encoder quantizes its activations per row (``quantize_act``)
and multiplies int8 by int8 into exact int32 sums (``quant_matmul_act8``):
on the card through ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM,
a library call as the JAX package leaves this dot to XLA), on the CPU as
an exact float64 product; the encoder's W1 and W2 hand their int32
accumulators (``int8_accumulators``) straight to the row kernels, which
apply the epilogue themselves.  ``_int_mm`` takes the weight codes K-major
(column-major (K, N)); :func:`kmajor_encoder_codes` lays the encoder's
codes out so once, when the engine quantizes its weights.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ttasr_torch.ops._build import count_launch

# matmul weight leaves eligible for quantization
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2",
    "wq_c", "wk_c", "wv_c", "wo_c", "embed",
})


def quantize_tensor(w, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Symmetric int8 quantization with one scale per output channel;
    ``axis`` is the contraction (input) dimension the scales reduce."""
    w = w.float()
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_tensor(leaf, dtype=torch.float32):
    return (leaf["q"].float() * leaf["s"]).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf.keys()) == {"q", "s"}


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every matmul weight of a port parameter dict.  ``embed``
    is quantized over its feature axis (one scale per vocab row: it is
    both the embedding table and the logits projection)."""

    def walk(tree):
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, (dict, list)):
                out[key] = walk(leaf)
            elif key == "embed":
                out[key] = quantize_tensor(leaf, axis=-1)
            elif key in QUANT_KEYS:
                out[key] = quantize_tensor(leaf, axis=-2)
            else:
                out[key] = leaf
        return out

    return walk(params)


def _fuse_block(blk: dict) -> dict:
    """One layer's q/k/v leaves -> ``wqkv`` (D, 3D) int8 + scales and
    ``bqkv`` with a zero k-bias slot (Whisper's k projection has none)."""
    out = dict(blk)
    wq, wk, wv = (out.pop(k) for k in ("wq", "wk", "wv"))
    out["wqkv"] = {"q": torch.cat([wq["q"], wk["q"], wv["q"]], dim=-1),
                   "s": torch.cat([wq["s"], wk["s"], wv["s"]], dim=-1)}
    bq, bv = out.pop("bq"), out.pop("bv")
    out["bqkv"] = torch.cat([bq, torch.zeros_like(bq), bv], dim=-1)
    return out


def fuse_qkv(params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate the quantized q/k/v projections of every decoder layer
    (and, when quantized too, every encoder layer) into one ``wqkv`` leaf,
    the layout the fused decode kernels read.  Per-output-channel scales
    concatenate exactly.  Unquantized params come back unchanged."""
    out = dict(params)
    for part in ("decoder", "encoder"):
        sub = params.get(part)
        if not sub or not all(is_quantized(sub["blocks"][0].get(k))
                              for k in ("wq", "wk", "wv")):
            if part == "decoder":
                return params
            continue
        out[part] = dict(sub, blocks=[_fuse_block(b) for b in sub["blocks"]])
    return out


def quantize_kv_sym(x, levels: int):
    """Per (row, slot, head) symmetric K/V-entry quantization.

    x: (..., Dh) -> (int8 codes in [-levels, levels], f32 scales (...)).
    ``levels=127`` is the int8 cache, ``levels=7`` the int4 one.

    The scale is ``max(absmax, 1e-8)`` times the f32 reciprocal of
    ``levels``: the JAX package quantizes its caches only inside jitted
    decode programs (and its Pallas kernels), where XLA turns the division
    by the constant level count into exactly that multiply; the codes then
    divide by the scale (a true division).  So the port's cache codes and
    scales are the ones the JAX decode computes, bit for bit."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) * (1.0 / levels)
    q = torch.clamp(torch.round(xf / scale[..., None]), -levels, levels)
    return q.to(torch.int8), scale


def quant_matmul(x, leaf):
    """x @ W for a quantized leaf: the codes go to f32 (int8 and bf16
    values are exact there), f32 products and sums, then the per-column
    scale; returns f32 as the reference's ``preferred_element_type``."""
    out = torch.matmul(x.float(), leaf["q"].float())
    return out * leaf["s"].reshape(leaf["s"].shape[-1])


def row_absmax(xf):
    """The absmax of each row of f32 (..., K), (..., 1)."""
    return xf.abs().amax(dim=-1, keepdim=True)


def quantize_rows_at(xf, absmax):
    """f32 (..., K) -> (int8 codes, f32 row scales (..., 1)) at the given
    row absmax (..., 1): ``scale = max(absmax, 1e-8) * f32(1/127)``, codes
    ``round(x / scale)`` half to even.  With the absmax of a whole row whose
    columns a mesh axis splits (the MAX over the axis of each rank's
    :func:`row_absmax`), a rank's codes are the whole row's at its columns."""
    scale = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_rows(xf):
    """f32 (..., K) -> (int8 codes, f32 row scales (..., 1)): per-row
    symmetric absmax (:func:`quantize_rows_at` of the row's own absmax).
    The multiply by the reciprocal is what the JAX package computes
    wherever it quantizes activations (the encoder's Pallas kernels, and
    ``quantize_act`` under jit: XLA rewrites the division by the
    constant)."""
    return quantize_rows_at(xf, row_absmax(xf))


def quantize_act(x):
    """Per-row symmetric int8 activation quantization (port of
    ``ttasr/ops/quant.py::quantize_act`` as its jitted programs compute
    it): x (..., K) -> (int8 (..., K), f32 row scale (..., 1))."""
    return quantize_rows(x.float())


def kmajor(q):
    """The same (K, N) int8 codes stored K-major: a transposed view of a
    contiguous (N, K) copy, the layout ``torch._int_mm`` reads without a
    copy per call."""
    return q.t().contiguous().t()


def kmajor_encoder_codes(params: Dict[str, Any]) -> Dict[str, Any]:
    """Lay every quantized encoder weight's codes out K-major (values and
    shapes unchanged: a no-op for the CPU products, no copy per GEMM on the
    card)."""
    enc = params.get("encoder")
    if not enc:
        return params
    blocks = [{k: ({"q": kmajor(v["q"]), "s": v["s"]} if is_quantized(v) else v)
               for k, v in blk.items()} for blk in enc["blocks"]]
    return dict(params, encoder=dict(enc, blocks=blocks))


def _int8_product(a, q):
    """Exact int32 (M, N) product of int8 (M, K) codes and int8 (K, N)
    codes: ``torch._int_mm`` on the card, a float64 product on the CPU
    (|sum| <= 127 * 127 * K < 2**53, so exact)."""
    if a.device.type == "cpu":
        return torch.matmul(a.double(), q.double()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"no int8 GEMM for device {a.device}")
    m, k = a.shape
    n = q.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"the int8 GEMM needs K and N multiples of 8: K={k} N={n}")
    if q.stride(0) != 1 or q.stride(1) != k:
        raise ValueError("int8 GEMM weight codes must be K-major "
                         "(ops.quant.kmajor_encoder_codes)")
    if m <= 16:  # _int_mm takes more than 16 rows
        a = torch.cat([a, a.new_zeros((17 - m, k))])
    acc = torch._int_mm(a.contiguous(), q)
    count_launch(quant_matmul_act8)
    return acc[:m]


def act8_epilogue(acc, xs, w_scale, b=None, out_dtype=torch.bfloat16):
    """The s8 x s8 GEMM's epilogue in the JAX package's order:
    ``acc.float() * xs * w_scale``, then ``+ b.float()``, then the cast to
    ``out_dtype``.  acc (..., M, N) int32, xs (..., M, 1) f32, w_scale
    (1, N) f32.  The row kernels that read the accumulators
    (``encoder_fused.gelu_quant_acc``, ``ln_quant_acc``,
    ``add_ln_quant_acc``, ``qkv_epilogue_acc``) compute this expression,
    one rounding per operation, before their producer."""
    out = acc.float() * xs * w_scale.reshape(acc.shape[-1])
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype)


def int8_accumulators(xq, leaf):
    """The exact int32 (..., M, N) product of int8 codes xq (..., M, K) and
    a quantized weight's (K, N) codes: the GEMM without its epilogue."""
    q = leaf["q"]
    k, n = q.shape
    return _int8_product(xq.reshape(-1, k), q).reshape(*xq.shape[:-1], n)


def quant_matmul_act8(xq, xs, leaf, b=None, out_dtype=torch.bfloat16):
    """s8 x s8 -> s32 matmul with the JAX package's epilogue
    (:func:`act8_epilogue`).

    xq (..., M, K) int8 with row scales xs (..., M, 1); ``leaf`` a quantized
    weight {"q": (K, N) int8, "s": (1, N)}.  Counts its launches on the card
    in ``quant_matmul_act8.launches``, as do the bare products of
    :func:`int8_accumulators`."""
    return act8_epilogue(int8_accumulators(xq, leaf), xs, leaf["s"], b, out_dtype)


quant_matmul_act8.launches = 0
