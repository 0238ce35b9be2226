"""Tensor-parallel fused int8 decode over ``torch.distributed`` (port of
``ttasr/parallel/tp.py``).

The JAX package runs the fused decode kernels per shard inside
``shard_map``; here each rank is a process holding its own shard and runs
the port's ``beam_decode``/``greedy_decode`` with ``opts.tp_axis="model"``
bound to the mesh's model group:

- the batch splits over the ``data`` axis (padded to fill it);
- attention heads split over the ``model`` axis: a shard's decoder carries
  only its heads' q/k/v, cross-q and cross-KV columns, so the self- and
  cross-KV caches split across ranks;
- v1 (``row_parallel=False``): wo, wo_c and the MLP stay replicated and the
  merged attention and cross outputs all-gather before them (B1, B2 or
  B10, B3 and B4 per layer, two all-gathers);
- v2 (row-parallel, the default when the shapes divide): wo, wo_c and w2
  are split by rows and w1/b1 by columns, so every rank streams 1/n of
  those weights; B15 ``matmul_int8_partial``, B16 ``ln_q_cross_int8`` and
  B14 ``mlp_int8_fused(partial=True)`` compute partial sums that three
  all-reduces per layer add up, the biases added once after each.

The unembedding stays replicated.  Every rank returns the whole batch.
:class:`MeshDecoder` holds what the GSPMD decode
(:class:`ttasr_torch.parallel.gspmd.ShardedDecoder`) shares: the batch
split, the axis binding and the gathers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ttasr_torch.models.whisper.decode import beam_decode, greedy_decode
from ttasr_torch.ops.quant import is_quantized
from ttasr_torch.parallel.sharding import bind_axes

_COL_SPLIT_KEYS = ("wq_c", "wk_c", "wv_c")
_COL_BIAS_KEYS = ("bq_c", "bv_c")
OUTPUTS = ("tokens", "lengths", "sum_logprob", "no_speech_prob")


def tp_eligible(params, cfg, mesh) -> bool:
    """The fused TP decode needs quantized unfused decoder weights, 64-wide
    heads, and heads that divide over the model axis into an even local
    count (the cross kernels pair heads)."""
    if mesh is None or "model" not in mesh.shape:
        return False
    n = mesh.shape["model"]
    blk = params["decoder"]["blocks"][0]
    if not ("wq" in blk and is_quantized(blk["wq"])):
        return False
    h = cfg.decoder_heads
    if cfg.d_model // h != 64:
        return False
    if n == 1:
        return True
    return h % n == 0 and (h // n) % 2 == 0


def _split_cols(leaf, n: int, part: int):
    """Shard ``part``'s slice of a column-split (output axis) weight or
    bias; a quantized leaf slices its codes and scales together."""
    def sl(x):
        width = x.shape[-1] // n
        return x[..., part * width:(part + 1) * width].contiguous()

    if is_quantized(leaf):
        return {"q": sl(leaf["q"]), "s": sl(leaf["s"])}
    return sl(leaf)


def _split_rows(leaf, n: int, part: int):
    """Shard ``part``'s slice of a row-split (input axis) weight: only the
    codes' rows split; the per-output-column scales stay whole (each shard
    applies them to its partial sum)."""
    def sl(x):
        width = x.shape[-2] // n
        return x[..., part * width:(part + 1) * width, :].contiguous()

    if is_quantized(leaf):
        return {"q": sl(leaf["q"]), "s": leaf["s"]}
    return sl(leaf)


def _shard_block(blk: dict, n: int, part: int, row_parallel: bool) -> dict:
    """One decoder layer's shard: the q/k/v column slices fused into
    ``wqkv``/``bqkv`` (a zero k-bias third), the cross-attention columns
    split, and with ``row_parallel`` wo/wo_c/w2 row-split and w1/b1
    column-split; everything else replicated."""
    q, k, v = (_split_cols(blk[name], n, part) for name in ("wq", "wk", "wv"))
    out = {"wqkv": {"q": torch.cat([q["q"], k["q"], v["q"]], dim=-1),
                    "s": torch.cat([q["s"], k["s"], v["s"]], dim=-1)}}
    bq = _split_cols(blk["bq"], n, part)
    out["bqkv"] = torch.cat([bq, torch.zeros_like(bq),
                             _split_cols(blk["bv"], n, part)], dim=-1)
    row_split = ("wo", "wo_c", "w2") if row_parallel else ()
    col_extra = ("w1", "b1") if row_parallel else ()
    for key, leaf in blk.items():
        if key in ("wq", "wk", "wv", "bq", "bv"):
            continue
        if key in _COL_SPLIT_KEYS + _COL_BIAS_KEYS + col_extra:
            out[key] = _split_cols(leaf, n, part)
        elif key in row_split:
            out[key] = _split_rows(leaf, n, part)
        else:
            out[key] = leaf
    return out


def build_tp_shard(params, n_shards: int, part: int,
                   row_parallel: bool = False) -> Dict[str, Any]:
    """Shard ``part`` of ``n_shards`` of a quantized, unfused decoder
    (``quantize_params`` output): ``{"decoder": ...}`` with each layer's
    blocks cut by :func:`_shard_block`; embeddings and final LayerNorm
    replicated.  Every slice is contiguous (the kernels read contiguous
    operands)."""
    dec = params["decoder"]
    blocks = [_shard_block(b, n_shards, part, row_parallel)
              for b in dec["blocks"]]
    return {"decoder": dict(dec, blocks=blocks)}


def build_tp_decoder(params, n_shards: int,
                     row_parallel: bool = False) -> List[Dict[str, Any]]:
    """Every shard, in model-axis order (the JAX package stacks them on a
    leading axis; a rank keeps only its own, :class:`TPDecoder`)."""
    return [build_tp_shard(params, n_shards, i, row_parallel)
            for i in range(n_shards)]


def _all_gather_rows(x, group):
    """Concatenate the ranks' ``x`` along axis 0, in group rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class MeshDecoder:
    """This rank's decoder shard (``params``) and the mesh it decodes on:
    the batch split over ``data``, the decode run with the model axis bound
    to the mesh's model group.  ``beam``/``greedy`` take the signatures of
    ``decode.beam_decode``/``decode.greedy_decode`` minus the params, and
    return the whole batch on every rank.  ``row_parallel`` is the decode's
    ``tp_row_parallel``."""

    params: Dict[str, Any]
    cfg: Any
    mesh: Any
    row_parallel: bool = False

    def _decode_params(self):
        """The params a decode reads (inside the axis binding)."""
        return self.params

    def _run(self, fn, enc_out, prompt, pad_len, opts, ti, temperature=None,
             **kw):
        """Pad the batch to a multiple of ``data``, decode this rank's rows
        with the model axis bound, gather the outputs over ``data`` and drop
        the padding.  ``temperature``: a per-row (B,) array, split as the
        batch is, or None (beam search)."""
        data_n, di = self.mesh.shape["data"], self.mesh.coords["data"]
        b = enc_out.shape[0]
        b_pad = -(-b // data_n) * data_n
        idx = np.concatenate([np.arange(b), np.zeros(b_pad - b, np.int64)])
        rows = idx[di * (b_pad // data_n):(di + 1) * (b_pad // data_n)]
        if temperature is not None:
            kw["temperature"] = temperature[rows]
        tp_opts = dataclasses.replace(opts, tp_axis="model",
                                      tp_row_parallel=self.row_parallel)
        sel = torch.as_tensor(rows, device=enc_out.device)
        with bind_axes({"model": self.mesh.groups["model"]}):
            out = fn(self._decode_params(), self.cfg, enc_out.index_select(0, sel),
                     np.asarray(prompt)[rows], np.asarray(pad_len)[rows],
                     opts=tp_opts, ti=ti, **kw)
        group = self.mesh.groups["data"]
        gathered = {k: _all_gather_rows(out[k], group)[:b] for k in OUTPUTS}
        stats = _all_gather_rows(torch.tensor(
            [[out["steps"], int(out["logits_finite"])]],
            device=enc_out.device), group)
        return dict(gathered, steps=int(stats[:, 0].max()),
                    logits_finite=bool(stats[:, 1].all()))

    def beam(self, enc_out, prompt, pad_len, rng=None, *, opts, ti):
        return self._run(beam_decode, enc_out, prompt, pad_len, opts, ti,
                         rng=rng)

    def greedy(self, enc_out, prompt, pad_len, rng, temperature, *, opts, ti):
        b = enc_out.shape[0]
        temps = np.broadcast_to(np.asarray(
            opts.temperature if temperature is None else temperature,
            np.float32), (b,))
        if rng is not None:
            # each data rank draws its own noise: fold the data index into
            # the generator, as the JAX package folds axis_index("data")
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                                     device=rng.device))
            rng = torch.Generator(device=rng.device).manual_seed(
                seed + self.mesh.coords["data"])
        return self._run(greedy_decode, enc_out, prompt, pad_len, opts, ti,
                         temperature=temps, rng=rng)


class TPDecoder(MeshDecoder):
    """The fused TP decode: this rank's shard of a quantized, unfused
    decoder (:func:`build_tp_shard`).  ``row_parallel=None`` takes v2 when
    the model axis is wider than 1 and ffn and d_model divide over it,
    unless ``TTASR_TP_ROW_PARALLEL`` is 0/false/no (read here, once).
    """

    def __init__(self, params_quantized, cfg, mesh,
                 row_parallel: Optional[bool] = None):
        n = mesh.shape["model"]
        if row_parallel is None:
            env = os.environ.get("TTASR_TP_ROW_PARALLEL", "1")
            row_parallel = (env.lower() not in ("0", "false", "no")
                            and n > 1 and cfg.ffn_dim % n == 0
                            and cfg.d_model % n == 0)
        self.row_parallel = bool(row_parallel)
        self.params = build_tp_shard(params_quantized, n, mesh.coords["model"],
                                     self.row_parallel)
        self.cfg = cfg
        self.mesh = mesh
