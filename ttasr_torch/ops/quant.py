"""int8 weight quantization (port of ``ttasr/ops/quant.py``).

Symmetric per-output-channel absmax: a quantized leaf is
``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}``.  Codes are
``clip(round(w / scale), -127, 127)`` with ``scale = max(absmax, 1e-8) /
127``; ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
codes match the JAX package bit for bit.  LayerNorms, biases, the conv
stem and the positional tables stay in the model type.

The port keeps layers as a list of per-layer dicts, so the walk below
quantizes each layer's leaf on its own; per-output-channel scales make
that identical to quantizing the stacked JAX leaf.  The activation
quantizers of the int8 encoder (``quantize_act``, ``quant_matmul_act8``)
belong to its slice and are not here yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

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
