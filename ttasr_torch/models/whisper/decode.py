"""Whisper decoding: greedy and beam search with CT2-parity logit rules
(port of ``ttasr/models/whisper/decode.py``: every single-card path).

Same rule set and semantics as the reference: static suppress list,
SuppressBlank, the timestamp rules (pairing, monotonicity,
``max_initial_timestamp``, probability mass), beam search with the openai
finished-set semantics and the GoogleNMT length penalty, a left-padded
prompt buffer, and a self-KV cache that grows in buckets.  The token loop
runs on the host (one device step per token); the JAX version's
``lax.while_loop`` conditions become Python ``while`` tests.

Ties break as in JAX: top-k and the survivor sort are stable sorts
(lower index first, as ``lax.top_k`` and ``jnp.argsort``), argmax takes
the first maximum.

With fused int8 weights (``quantize_params`` + ``fuse_qkv``) and
``kv_int8`` the decode runs the reference's flat fused path
(``scan_block_fused``): per token and layer B1 ``qkv_int8_fused`` -> B2
``self_attn_step_indirect_int8`` (beam, through the ancestry map) or B10
``self_attn_step_int8`` (greedy, or beam with ``beam_indirect=False``) ->
B3 ``attnout_ln_q_cross_int8`` -> B4 ``mlp_with_crossout_int8``, over an
int8 or int4 lane-packed flat self-KV cache and an int8 or int4 cross-KV
cache.  Where B3's condition fails (a bf16 cross-KV, more than 8 beams per
audio, an odd head count) B12 ``attnout_ln_q_fused`` takes its place and
the cross-attention runs outside the kernel.  Beam search permutes a
(rows, len) ancestry map instead of the caches, or with
``beam_indirect=False`` copies the cache rows with B17
``gather_cache_rows`` after each top-k.  Without fused weights ``kv_int8``
runs the unfused int8 graph (``scan_block``): a 5-D int8 self-KV and the
plain quantized attention, with B13 ``cross_attention_int8`` over an int8
cross-KV.

Tensor parallelism (``opts.tp_axis``, bound to a process group by
:class:`ttasr_torch.parallel.tp.TPDecoder` or
:class:`ttasr_torch.parallel.gspmd.ShardedDecoder`): a rank's decoder
carries its local heads' columns, so the attentions and caches run on those
heads.  v1 all-gathers the merged attention and cross outputs before the
replicated wo/wo_c/MLP (B3, or B12, and B4); v2 (``opts.tp_row_parallel``)
runs B15 ``matmul_int8_partial`` for wo and wo_c, B16 ``ln_q_cross_int8``
(or B1 on the cross query and the cross-attention outside the kernel where
B3's condition fails) and B14 ``mlp_int8_fused(partial=True)`` on row- and
column-split weights, each partial sum all-reduced and its bias added once
after the sum.

The GSPMD layout (``ShardedDecoder``: ``shard_params``' slices, float or
unfused int8 weights) runs the plain layer loop, which reads the layout
from the shard's shapes, as XLA reads it from the shardings: q/k/v and the
cross q/k/v column-split, so the attentions and caches (float, or the 5-D
int8 self-KV and an int8 cross-KV with B13) run on the local heads, any
count; wo, wo_c and w2 row-split, each partial product summed over the
ranks in f32 with its bias added once after the sum; w1/b1 column-split; a
vocabulary-split ``embed`` looked up with the other ranks' rows as zeros
and summed, and its logits all-gathered in rank order before the rules.
Where ``sanitize_spec`` replicated a leaf (a width the axis does not
divide), that projection runs whole, with no collective.

``TTASR_UNFUSED_RULES`` (read when :func:`greedy_decode` or
:func:`beam_decode` is called, as in the reference) or
``opts.unfused_rules`` selects the two-stage rules path, the reference's
A/B control: :func:`_apply_rules`, then ``log_softmax``, in place of the
one-pass :func:`_apply_rules_logprobs`.

The host-side pieces (``DecodingOptions``, ``TokenizerInfo``,
``build_prompt``, ``pad_prompts``, ``compression_ratio`` and the
constants) are declared again because the reference module imports jax;
``tests/test_torch_config.py`` pins them to the originals.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.model import (
    DecodeCache,
    _attention,
    _cross_attention,
    _embed_lookup,
    _in_rows,
    _ln,
    _merge_heads,
    _mlp,
    _model_dtype,
    _proj,
    _quant_self_attention,
    _split_heads,
    _unembed,
    _width,
    init_cache,
    local_heads,
    quantize_kv,
)
from ttasr_torch.ops.beam_gather import gather_cache_rows
from ttasr_torch.ops.cross_attention import cross_attention_int8
from ttasr_torch.ops.decoder_blocks import (
    DH,
    MAX_BEAMS,
    attnout_ln_q_cross_int8,
    attnout_ln_q_fused,
    ln_q_cross_int8,
    matmul_int8_partial,
    qkv_int8_fused,
)
from ttasr_torch.ops.decoder_mlp import mlp_int8_fused, mlp_with_crossout_int8
from ttasr_torch.ops.int4 import pack_int4_lanes, quantize_kv4, unpack_int4
from ttasr_torch.ops.quant import is_quantized, quant_matmul
from ttasr_torch.parallel.collectives import all_reduce_sum, gather_last
from ttasr_torch.ops.self_attention import (
    self_attn_step_indirect_int8,
    self_attn_step_int8,
)

NEG_INF = float(np.finfo(np.float32).min)

# Fixed prompt buffer and per-window token budget, as the reference.
MAX_PROMPT = 256   # left-padded prompt buffer
SAMPLE_LEN = 224   # max new tokens per window (n_ctx // 2)


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    """Decode configuration.  Same fields and defaults as the reference.
    ``tp_axis`` names a mesh axis that must be bound to a process group
    (:func:`ttasr_torch.parallel.sharding.bind_axes`, as ``TPDecoder``
    does); ``unfused_rules`` (or ``TTASR_UNFUSED_RULES``) runs the
    two-stage rules path (:func:`_apply_rules`)."""

    beam_size: int = 5
    temperature: float = 0.0  # 0 = deterministic; >0 enables sampling
    length_penalty: float = 1.0
    patience: float = 1.0
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    sample_len: int = SAMPLE_LEN
    max_prompt: int = MAX_PROMPT
    kv_int8: bool = False
    cross_kv_int8: bool = False
    beam_indirect: bool = True
    cross_kv_int4: bool = False
    kv_int4: bool = False
    unfused_rules: bool = False
    tp_axis: Optional[str] = None
    tp_row_parallel: bool = False
    growth_min_cap: int = 32


@dataclasses.dataclass(frozen=True)
class TokenizerInfo:
    """The token ids decoding needs."""

    eot: int
    sot: int
    no_timestamps: int
    timestamp_begin: int
    no_speech: Optional[int]
    blank: Tuple[int, ...]          # ids of " " (for SuppressBlank)
    suppress: Tuple[int, ...]       # static suppress list
    n_vocab: int
    # First id of the model's vocab padding (ids past the tokenizer's id
    # space); the static mask bans them.  None when the tokenizer covers
    # the full model vocab.
    pad_vocab_begin: Optional[int] = None

    @classmethod
    def from_tokenizer(cls, tok, n_vocab: Optional[int] = None) -> "TokenizerInfo":
        n_vocab = n_vocab or tok.vocab_size
        ts_end = None
        if tok.timestamp_begin is not None:
            ts_end = tok.timestamp_begin + 1501  # <|0.00|>..<|30.00|>
        id_space_end = max(tok.vocab_size, ts_end or 0)
        return cls(
            eot=tok.eot,
            sot=tok.sot,
            no_timestamps=tok.no_timestamps,
            timestamp_begin=tok.timestamp_begin,
            no_speech=tok.no_speech,
            blank=tuple(tok.encode(" ")),
            suppress=tuple(tok.suppress_tokens_default()),
            n_vocab=n_vocab,
            pad_vocab_begin=(id_space_end if n_vocab > id_space_end else None),
        )


def _use_flat_kv(params, cfg: WhisperConfig, opts: DecodingOptions) -> bool:
    """Flat int8 self-KV: only with the fused int8 weights and 64-wide
    heads.  The one test of the fused decode kernels: a flat cache is
    what sends a step to ``_step_fused``."""
    return (opts.kv_int8 and "wqkv" in params["decoder"]["blocks"][0]
            and cfg.d_model // cfg.decoder_heads == 64)


def _even_heads(params, cfg: WhisperConfig) -> bool:
    """An even count of the heads the decoder's weights carry (the
    shard's under tensor parallelism)."""
    return local_heads(params["decoder"]["blocks"][0], cfg) % 2 == 0


def _use_cross_int4(params, cfg: WhisperConfig, opts: DecodingOptions) -> bool:
    """int4 cross-KV: a sub-mode of ``cross_kv_int8`` on the flat path."""
    return (opts.cross_kv_int4 and opts.cross_kv_int8
            and _use_flat_kv(params, cfg, opts) and _even_heads(params, cfg))


def _use_self_int4(params, cfg: WhisperConfig, opts: DecodingOptions) -> bool:
    """int4 lane-packed self-KV: a sub-mode of ``kv_int8`` on the flat
    path, with an even head count (the D/2 split lands on a head)."""
    return (opts.kv_int4 and opts.kv_int8
            and _use_flat_kv(params, cfg, opts) and _even_heads(params, cfg))


def _f32_decoder_vectors(params):
    """The decoder layers' LayerNorm scales and biases in f32: the fused
    kernels take them in f32 (the TPU kernels upcast them), so this runs
    once per decode instead of per kernel call.  Model-type values are
    exact in f32 and the prefill casts them back, so no result changes."""
    dec = params["decoder"]
    blocks = [{k: (v.float() if torch.is_tensor(v) and v.dim() == 1 else v)
               for k, v in blk.items()} for blk in dec["blocks"]]
    return dict(params, decoder=dict(dec, blocks=blocks))


def _tp_setup(params, cfg: WhisperConfig, opts: DecodingOptions):
    """(process group of ``opts.tp_axis`` or None, row-parallel).  Raises
    when the axis is not bound to a group (a decode that names an axis
    never runs unsharded), for ``tp_row_parallel`` without an axis, and
    for v2 off the flat fused path (the only step with its branch)."""
    if opts.tp_axis is None:
        if opts.tp_row_parallel:
            raise ValueError("DecodingOptions tp_row_parallel needs tp_axis")
        return None, False
    from ttasr_torch.parallel.sharding import axis_group

    try:
        group = axis_group(opts.tp_axis)
    except RuntimeError as exc:
        raise RuntimeError(f"DecodingOptions tp_axis={opts.tp_axis!r}: {exc}") from None
    if opts.tp_row_parallel and not _use_flat_kv(params, cfg, opts):
        raise ValueError("tp_row_parallel runs the fused int8 step: it needs "
                         "kv_int8, fused wqkv weights and 64-wide heads")
    return group, opts.tp_row_parallel


# ---------------------------------------------------------------------------
# Prefill with left-padded prompt
# ---------------------------------------------------------------------------

def _qkv_proj(h, blk, cfg: WhisperConfig):
    """Self-attention q/k/v, through the fused ``wqkv`` leaf when present;
    the head count comes from the weight's width (a tensor-parallel
    shard's local heads)."""
    n = local_heads(blk, cfg)
    if "wqkv" in blk:
        qkv = _proj(h, blk["wqkv"], blk["bqkv"])
        return tuple(_split_heads(t, n) for t in qkv.chunk(3, dim=-1))
    return (_split_heads(_proj(h, blk["wq"], blk["bq"]), n),
            _split_heads(_proj(h, blk["wk"]), n),
            _split_heads(_proj(h, blk["wv"], blk["bv"]), n))


def _sum_proj(x_local, w, b, group):
    """A row-split projection of the GSPMD layout: the shard's partial
    product of its input slice and its rows in f32, summed over the ranks,
    the bias added once in f32, one rounding to x's type (on one card
    ``_proj`` rounds once too; only the order of the sum differs)."""
    if is_quantized(w):
        part = quant_matmul(x_local, w)
    else:
        part = torch.matmul(x_local.float(), w.float())
    out = _psum(part.contiguous(), group)
    if b is not None:
        out = out + b.float()
    return out.to(x_local.dtype)


def _out_proj(merged, w, b, group, whole: int, row_parallel: bool):
    """An attention's output projection after its merged heads ``merged``:
    TP v2's row-parallel sum (``row_parallel``); where the heads are whole,
    the whole projection (one card, or a layer the mesh replicates) or, over
    w's row slice, the rank's columns of them summed; the GSPMD sum where
    both are the shard's; else TP v1's all-gather of the heads before the
    replicated w."""
    if row_parallel:
        return _rp_proj(merged, w, b, group)
    rows = _in_rows(w)
    if merged.shape[-1] == whole and rows < whole:
        # whole heads (gathered where the split cuts a head) before w's
        # rows: this rank's columns of them
        r = dist.get_rank(group)
        return _sum_proj(merged[..., r * rows:(r + 1) * rows], w, b, group)
    if merged.shape[-1] == whole:
        return _proj(merged, w, b)
    if rows < whole:
        return _sum_proj(merged, w, b, group)
    return _proj(_tp_gather(merged, group), w, b)


def _block_mlp(xln, blk, group, ffn: int, row_parallel: bool):
    """The MLP: TP v2's row-parallel sum (``row_parallel``), the GSPMD
    layout's (w1/b1 column-split: the local hidden slice, then w2's rows
    summed over the ranks), or whole."""
    if row_parallel:
        return _rp_mlp(xln, blk, group)
    if _width(blk["w1"]) < ffn:
        return _sum_proj(F.gelu(_proj(xln, blk["w1"], blk["b1"])), blk["w2"],
                         blk["b2"], group)
    return _mlp(xln, blk)


def _vocab_shard(dec, cfg: WhisperConfig, group):
    """(first id, count) of this rank's rows of a vocabulary-split
    ``embed`` (``shard_params`` splits it where the model axis divides the
    vocabulary; the rank's index on the axis is its rank in ``group``), or
    None where the embedding is whole."""
    e = dec["embed"]
    rows = (e["q"] if is_quantized(e) else e).shape[0]
    if group is None or rows == cfg.vocab_size:
        return None
    return dist.get_rank(group) * rows, rows


def _local_embed(e, lo: int, n: int):
    """The shard's rows of ``embed`` as (codes or values, per-row scales or
    None): a quantized leaf keeps its scales whole (JAX's rule replicates
    the scales of a weight that is not column-split), so the rank slices
    its rows' scales."""
    if not is_quantized(e):
        return e, None
    return e["q"], e["s"][lo:lo + n]


def _embed_tokens(dec, cfg: WhisperConfig, tokens, group):
    """Token embeddings: ``_embed_lookup``, or over a vocabulary-split
    ``embed`` each rank's rows with the others' ids as zeros, summed over
    the ranks in f32 (one non-zero term: exact)."""
    shard = _vocab_shard(dec, cfg, group)
    if shard is None:
        return _embed_lookup(dec, tokens)
    lo, n = shard
    codes, scales = _local_embed(dec["embed"], lo, n)
    local = tokens - lo
    inside = (local >= 0) & (local < n)
    idx = torch.where(inside, local, 0)
    rows = codes[idx].float()
    if scales is not None:
        rows = rows * scales[idx]
    rows = torch.where(inside[..., None], rows, 0.0).contiguous()
    return _psum(rows, group).to(_model_dtype(dec))


def _tp_gather(x, group):
    """Concatenate the ranks' head blocks along the last axis, in rank
    order (rank i holds heads [i * h_loc, (i + 1) * h_loc)); identity
    without tensor parallelism."""
    return x if group is None else gather_last(x, group)


def _psum(x, group):
    """Sum of the ranks' partial sums ``x`` (a fresh f32 tensor, reduced
    in place)."""
    return all_reduce_sum(x, group)


def _rp_proj(x_local, w, b, group):
    """Row-parallel projection (TP v2): the local input slice times the
    shard's row slice, summed over the ranks, the bias added once."""
    out = _psum(_proj(x_local, w).float(), group)
    return (out + b.float()).to(x_local.dtype)


def _rp_mlp(xln, blk, group):
    """Row-parallel MLP (TP v2): w1/b1 column-split (the local hidden
    slice), w2 row-split; partial sums summed over the ranks, b2 added
    once."""
    h = F.gelu(_proj(xln, blk["w1"], blk["b1"]))
    out = _psum(_proj(h, blk["w2"]).float(), group)
    return (out + blk["b2"].float()).to(xln.dtype)


def _cross_attn_quantized(qc, ck8, cks_t, cv8, cvs_t, s_real: int):
    """Cross-attention over one layer's quantized cross-KV outside the
    fused B3 kernel.  One token with at most 8 beam rows per audio and
    64-wide heads (any count: a shard's odd local heads too) runs B13
    (``cross_attention_int8``); other shapes (the prompt prefill, more
    than 8 beams) take the reference's XLA branch, with the int4 cache
    unpacked and slots >= ``s_real`` masked.  qc: (rows, T, H, Dh);
    ck8/cv8: (B, S, D) int8 or (B, S/2, D) uint8; cks_t/cvs_t: (B, H, S).
    Returns qc's dtype."""
    bk, t, h, dh = qc.shape
    b = ck8.shape[0]
    group = bk // b
    if t == 1 and group <= MAX_BEAMS and dh == 64:
        out = cross_attention_int8(qc.reshape(b, group, h, dh), ck8, cks_t,
                                   cv8, cvs_t, s_real)
        return out.reshape(bk, t, h, dh).to(qc.dtype)
    if ck8.dtype == torch.uint8:
        ck8, cv8 = unpack_int4(ck8), unpack_int4(cv8)
    s = ck8.shape[1]
    mask = (torch.arange(s, device=qc.device) < s_real)[None, None, None, :]
    out = _quant_self_attention(
        qc.reshape(b, group * t, h, dh), ck8.reshape(b, s, h, dh),
        cks_t.transpose(1, 2), cv8.reshape(b, s, h, dh),
        cvs_t.transpose(1, 2), mask)
    return out.reshape(bk, t, h, dh)


def _write_kv5(cache: DecodeCache, i: int, k_new, v_new, start: int):
    """Quantize K/V (B, T, H, Dh) into slots ``start..start+T-1`` of layer
    i of the 5-D int8 cache (codes (B, T, H, Dh), scales (B, T, H))."""
    t = k_new.shape[1]
    for codes, scales, new in ((cache.k, cache.ks, k_new),
                               (cache.v, cache.vs, v_new)):
        q, sc = quantize_kv(new)
        codes[i, :, start:start + t] = q
        scales[i, :, start:start + t] = sc


def _write_prefill_kv(cache: DecodeCache, i: int, k_new, v_new, t: int):
    """Store the prompt's K/V (B, T, H, Dh) in slots 0..T-1 of layer i:
    as they are, quantized into the 5-D int8 layout, or quantized into the
    flat int8/int4 layout with the scales transposed to (rows, H, T)."""
    if not cache.quantized:
        cache.k[i, :, :t] = k_new
        cache.v[i, :, :t] = v_new
        return
    if not cache.flat:
        _write_kv5(cache, i, k_new, v_new, 0)
        return
    int4 = cache.self_int4
    h = k_new.shape[2]
    for codes, scales, new in ((cache.k, cache.ks, k_new),
                               (cache.v, cache.vs, v_new)):
        q, sc = (quantize_kv4 if int4 else quantize_kv)(new)
        q = _merge_heads(q)
        codes[i, :, :t] = pack_int4_lanes(q) if int4 else q
        scales[i, :, :h, :t] = sc.transpose(1, 2)


def _prefill(params, cfg: WhisperConfig, tokens, pad_len, cache: DecodeCache,
             s_real: Optional[int] = None, tp_group=None,
             tp_row_parallel: bool = False):
    """Teacher-forced pass over the left-padded prompt buffer.

    tokens: (B, W) long, real tokens at positions ``pad_len..W-1`` with
    positional indices ``0..real-1``; pad_len: (B,) long.  Writes slots
    ``0..W-1`` of the self cache in place (quantized on the flat int8
    path).  ``s_real``: valid cross-attention slots of a quantized
    cross-KV (the encoder length; default ``cfg.max_source_positions``).
    ``tp_group``: the tensor-parallel process group (attention on the local
    heads; v1 all-gathers the merged outputs before the replicated
    wo/wo_c/MLP, v2 with ``tp_row_parallel`` sums row-parallel partials,
    the GSPMD layout sums the partials of its row-split leaves, read from
    their shapes; :func:`_out_proj`, :func:`_block_mlp`).
    Returns (final-LN hidden states (B, W, d), cache).
    """
    if s_real is None:
        s_real = cfg.max_source_positions
    dec = params["decoder"]
    b, t = tokens.shape
    ar = torch.arange(t, device=tokens.device)
    pos_ids = torch.clamp(ar[None, :] - pad_len[:, None], min=0)
    x = (_embed_tokens(dec, cfg, tokens, tp_group) + dec["pos"][pos_ids]
         ).to(_model_dtype(dec))
    valid = ar[None, None, :] >= pad_len[:, None, None]   # pad slots never attend
    causal = ar[None, None, :] <= ar[None, :, None]
    mask = (causal & valid)[:, None]                       # (B, 1, T, T)
    for i, blk in enumerate(dec["blocks"]):
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q, k_new, v_new = _qkv_proj(h, blk, cfg)
        _write_prefill_kv(cache, i, k_new, v_new, t)
        attn = _attention(q, k_new, v_new, mask)  # its own exact K/V block
        x = x + _out_proj(_merge_heads(attn), blk["wo"], blk["bo"], tp_group,
                          cfg.d_model, tp_row_parallel)
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        qc = _proj(hc, blk["wq_c"], blk["bq_c"])
        qc = _split_heads(qc, qc.shape[-1] // q.shape[-1])
        if cache.cross_quantized:
            cross = _cross_attn_quantized(qc, cache.cross_k[i], cache.cks[i],
                                          cache.cross_v[i], cache.cvs[i],
                                          s_real)
        else:
            cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        x = x + _out_proj(_merge_heads(cross), blk["wo_c"], blk["bo_c"], tp_group,
                          cfg.d_model, tp_row_parallel)
        x = x + _block_mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk, tp_group,
                           cfg.ffn_dim, tp_row_parallel)
    return _ln(x, dec["ln_s"], dec["ln_b"]), cache


def _logits_at(params, hidden, cfg: Optional[WhisperConfig] = None, tp_group=None):
    """Project selected hidden rows (N, d) to f32 vocab logits (N, V); over
    a vocabulary-split ``embed`` (``cfg`` and the group given) each rank's
    logits, all-gathered in rank order."""
    dec = params["decoder"]
    shard = None if cfg is None else _vocab_shard(dec, cfg, tp_group)
    if shard is None:
        return _unembed(hidden, dec)
    codes, scales = _local_embed(dec["embed"], *shard)
    local = torch.matmul(hidden.float(), codes.float().t())
    if scales is not None:
        local = local * scales[:, 0]
    return _tp_gather(local, tp_group)


def _self_mask(max_len: int, slot: int, pad_len):
    """(B, 1, 1, len) bool: the step's query sees slots pad..slot."""
    k_ids = torch.arange(max_len, device=pad_len.device)[None, :]
    return ((k_ids <= slot) & (k_ids >= pad_len[:, None]))[:, None, None]


def _step_fused(params, cfg: WhisperConfig, x, slot: int, pad_len,
                cache: DecodeCache, anc, s_real: int, tp_group=None,
                tp_row_parallel: bool = False):
    """The fused int8 step over the flat cache (the reference's
    ``scan_block_fused``): per layer B1 -> B2 (``anc`` given) or B10, then

    - one card or TP v1: B3, or, where B3's condition fails (a bf16
      cross-KV, more than 8 beam rows per audio, an odd head count), B12
      and the cross-attention outside the kernel -> B4, the local-head
      attention and cross outputs all-gathered over ``tp_group`` first;
    - TP v2 (``tp_row_parallel``): B15 for wo, the sum over the ranks, then
      B16, or where B3's condition fails B1 on LNc/wq_c and the
      cross-attention outside the kernel; B15 for wo_c, the sum; B14
      partial, the sum.  Each bias is added once after its sum, in the
      reference's order ``(x + sum) + b``, in f32.

    Head counts are the shard's (from the q/k/v width).  Each layer's new
    K/V codes and scales are written at ``slot`` after the loop (the
    kernels read only positions < slot)."""
    dec = params["decoder"]
    bk, d_model = x.shape[0], x.shape[-1]
    b_audio = cache.cross_k.shape[1]
    group = bk // b_audio
    h = local_heads(dec["blocks"][0], cfg)
    d = h * DH  # the local attention width (d_model on one card)
    fused_cross = (cache.cross_quantized and cfg.d_model == cfg.decoder_heads * DH
                   and h % 2 == 0 and group <= MAX_BEAMS)
    cache_len, d_store = cache.k.shape[2:]
    hp = cache.ks.shape[2]
    pad_g = pad_len.to(torch.int32).reshape(b_audio, group)  # once per step
    anc_g = None if anc is None else anc.reshape(b_audio, group, cache_len)
    new_rows = []

    def cross_outside(i, blk, qc):
        """The cross-attention of B1's/B12's queries (R, DC) f32 outside a
        kernel, on the model-dtype queries: (R, DC) f32 merged."""
        qc = _split_heads(qc[:, None, :].to(x.dtype), h)
        if cache.cross_quantized:
            cross = _cross_attn_quantized(qc, cache.cross_k[i], cache.cks[i],
                                          cache.cross_v[i], cache.cvs[i], s_real)
        else:
            cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        return _merge_heads(cross)[:, 0].float().contiguous()

    for i, blk in enumerate(dec["blocks"]):
        x2 = x[:, 0].float()
        qkv = qkv_int8_fused(x2, blk["ln1_s"], blk["ln1_b"],
                             blk["wqkv"]["q"], blk["wqkv"]["s"], blk["bqkv"])
        caches = (qkv.reshape(b_audio, group, 3 * d),
                  cache.k[i].reshape(b_audio, group, cache_len, d_store),
                  cache.ks[i].reshape(b_audio, group, hp, cache_len),
                  cache.v[i].reshape(b_audio, group, cache_len, d_store),
                  cache.vs[i].reshape(b_audio, group, hp, cache_len))
        if anc_g is not None:
            attn, *rows = self_attn_step_indirect_int8(
                *caches, anc_g, pad_g, slot, n_heads=h, int4=cache.self_int4)
        else:
            attn, *rows = self_attn_step_int8(
                *caches, pad_g, slot, n_heads=h, int4=cache.self_int4)
        new_rows.append(rows)
        attn = attn.reshape(bk, d)
        if tp_row_parallel:
            xo = (x2 + _psum(matmul_int8_partial(attn, blk["wo"]["q"],
                                                 blk["wo"]["s"]), tp_group)
                  + blk["bo"].float())
            if fused_cross:
                cross = ln_q_cross_int8(
                    xo.reshape(b_audio, group, d_model),
                    blk["lnc_s"], blk["lnc_b"],
                    blk["wq_c"]["q"], blk["wq_c"]["s"], blk["bq_c"],
                    cache.cross_k[i], cache.cks[i], cache.cross_v[i],
                    cache.cvs[i], s_real).reshape(bk, d)
            else:
                cross = cross_outside(i, blk, qkv_int8_fused(
                    xo, blk["lnc_s"], blk["lnc_b"],
                    blk["wq_c"]["q"], blk["wq_c"]["s"], blk["bq_c"]))
            x_mid = (xo + _psum(matmul_int8_partial(cross, blk["wo_c"]["q"],
                                                    blk["wo_c"]["s"]), tp_group)
                     + blk["bo_c"].float())
            x_new = (x_mid + _psum(mlp_int8_fused(
                x_mid, blk["ln2_s"], blk["ln2_b"],
                blk["w1"]["q"], blk["w1"]["s"], blk["b1"],
                blk["w2"]["q"], blk["w2"]["s"], blk["b2"], partial=True), tp_group)
                     + blk["b2"].float())
        else:
            attn = _tp_gather(attn, tp_group)
            if fused_cross:
                xo, cross = attnout_ln_q_cross_int8(
                    x2.reshape(b_audio, group, d_model),
                    attn.reshape(b_audio, group, d_model),
                    blk["wo"]["q"], blk["wo"]["s"], blk["bo"],
                    blk["lnc_s"], blk["lnc_b"],
                    blk["wq_c"]["q"], blk["wq_c"]["s"], blk["bq_c"],
                    cache.cross_k[i], cache.cks[i], cache.cross_v[i],
                    cache.cvs[i], s_real)
                cross = _tp_gather(cross.reshape(bk, d), tp_group)
            else:
                xo, qc = attnout_ln_q_fused(
                    x2, attn,
                    blk["wo"]["q"], blk["wo"]["s"], blk["bo"],
                    blk["lnc_s"], blk["lnc_b"],
                    blk["wq_c"]["q"], blk["wq_c"]["s"], blk["bq_c"])
                cross = _tp_gather(cross_outside(i, blk, qc), tp_group)
            x_new = mlp_with_crossout_int8(
                xo.reshape(bk, d_model), cross,
                blk["wo_c"]["q"], blk["wo_c"]["s"], blk["bo_c"],
                blk["ln2_s"], blk["ln2_b"],
                blk["w1"]["q"], blk["w1"]["s"], blk["b1"],
                blk["w2"]["q"], blk["w2"]["s"], blk["b2"])
        x = x_new[:, None, :].to(x.dtype)
    k_rows, ks_rows, v_rows, vs_rows = (torch.stack(t) for t in zip(*new_rows))
    cache.k[:, :, slot] = k_rows.reshape(-1, bk, d_store)
    cache.v[:, :, slot] = v_rows.reshape(-1, bk, d_store)
    cache.ks[:, :, :h, slot] = ks_rows.reshape(-1, bk, h)
    cache.vs[:, :, :h, slot] = vs_rows.reshape(-1, bk, h)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _unembed(x[:, 0], dec), cache


def _step(params, cfg: WhisperConfig, token, slot: int, pad_len,
          cache: DecodeCache, anc=None, s_real: Optional[int] = None,
          tp_group=None, tp_row_parallel: bool = False):
    """Single-token decode at cache slot ``slot``; writes the slot in place.

    token: (B, 1) long.  pad_len: (B,) long — pad slots stay masked.
    anc: optional (rows, len) ancestry map (beam search on the flat int8
    path): the physical row, within the audio's beam group, that holds
    each row's entry at each cache position.  ``tp_group`` and
    ``tp_row_parallel``: tensor parallelism, as :func:`_prefill` (v2 runs
    only on the flat fused path, :func:`_tp_setup`; the plain layer loop
    runs TP v1 and the GSPMD layout).
    Returns (logits (B, V) f32, cache).
    """
    if s_real is None:
        s_real = cfg.max_source_positions
    dec = params["decoder"]
    pos = torch.clamp(slot - pad_len, min=0)              # (B,)
    x = (_embed_tokens(dec, cfg, token, tp_group)
         + dec["pos"][pos][:, None, :]).to(_model_dtype(dec))
    if cache.flat:
        return _step_fused(params, cfg, x, slot, pad_len, cache, anc, s_real,
                           tp_group, tp_row_parallel)
    mask = _self_mask(cache.k.shape[2], slot, pad_len)
    for i, blk in enumerate(dec["blocks"]):
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q, k_new, v_new = _qkv_proj(h, blk, cfg)
        if cache.quantized:
            _write_kv5(cache, i, k_new, v_new, slot)
            attn = _quant_self_attention(q, cache.k[i], cache.ks[i],
                                         cache.v[i], cache.vs[i], mask)
        else:
            cache.k[i, :, slot] = k_new[:, 0]
            cache.v[i, :, slot] = v_new[:, 0]
            attn = _attention(q, cache.k[i], cache.v[i], mask)
        x = x + _out_proj(_merge_heads(attn), blk["wo"], blk["bo"], tp_group,
                          cfg.d_model, tp_row_parallel)
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        qc = _proj(hc, blk["wq_c"], blk["bq_c"])
        qc = _split_heads(qc, qc.shape[-1] // q.shape[-1])
        if cache.cross_quantized:
            cross = _cross_attn_quantized(qc, cache.cross_k[i], cache.cks[i],
                                          cache.cross_v[i], cache.cvs[i],
                                          s_real)
        else:
            cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        x = x + _out_proj(_merge_heads(cross), blk["wo_c"], blk["bo_c"], tp_group,
                          cfg.d_model, tp_row_parallel)
        x = x + _block_mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk, tp_group,
                           cfg.ffn_dim, tp_row_parallel)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _logits_at(params, x[:, 0], cfg, tp_group), cache


# ---------------------------------------------------------------------------
# Logit rules
# ---------------------------------------------------------------------------

def _static_suppress_mask(ti: TokenizerInfo) -> np.ndarray:
    mask = np.zeros((ti.n_vocab,), dtype=np.float32)
    for t in ti.suppress:
        if 0 <= t < ti.n_vocab:
            mask[t] = NEG_INF
    mask[ti.no_timestamps] = NEG_INF
    if ti.pad_vocab_begin is not None:
        # vocab padding past the tokenizer's id space: undecodable, and
        # ids >= timestamp_begin would parse as absurd timestamps
        mask[ti.pad_vocab_begin:] = NEG_INF
    return mask


def _apply_rules(logits, *, ti: TokenizerInfo, opts: DecodingOptions,
                 static_mask, n_sampled, last_tok, penult_tok, max_ts_tok):
    """The logit rules as a pass of their own (the reference's two-stage
    A/B control): static suppress mask, SuppressBlank, the timestamp
    pairing, monotonicity and first-token rules, then the probability-mass
    rule by a second pass over ``log_softmax``.  Returns logits; the caller
    takes ``log_softmax``.  logits: (N, V) f32; the other state is per row
    (N,)."""
    v = ti.n_vocab
    dev = logits.device
    ids = torch.arange(v, device=dev)[None, :]
    logits = logits + static_mask[None, :]

    if opts.suppress_blank:
        blank = torch.zeros((v,), dtype=torch.bool, device=dev)
        blank[list(ti.blank) + [ti.eot]] = True
        blank_mask = torch.where(blank, NEG_INF, 0.0)[None, :]
        logits = logits + torch.where((n_sampled == 0)[:, None], blank_mask, 0.0)

    ts0 = ti.timestamp_begin
    is_ts = ids >= ts0
    if opts.without_timestamps:
        return logits + torch.where(is_ts, NEG_INF, 0.0)

    last_is_ts = last_tok >= ts0
    penult_is_ts = penult_tok >= ts0
    active = n_sampled > 0
    # last two sampled tokens both timestamps (or only one sampled): text next
    rule_a = ((active & last_is_ts
               & ((n_sampled < 2) | penult_is_ts))[:, None] & is_ts)
    # an unpaired timestamp last: a timestamp or eot next
    unpaired_last = active & last_is_ts & (n_sampled >= 2) & (~penult_is_ts)
    rule_b = unpaired_last[:, None] & ((~is_ts) & (ids != ti.eot))
    logits = torch.where(rule_a | rule_b, NEG_INF, logits)

    # monotonicity: strictly after a paired end, equal allowed when unpaired
    floor = torch.clamp(max_ts_tok + torch.where(unpaired_last, 0, 1), min=ts0)
    has_ts = max_ts_tok > 0
    mono = is_ts & (ids < floor[:, None]) & (active & has_ts)[:, None]
    logits = torch.where(mono, NEG_INF, logits)

    # the first sampled token is a timestamp up to max_initial_timestamp
    max_init = ts0 + int(round(opts.max_initial_timestamp / 0.02))
    first = (n_sampled == 0)[:, None] & ((~is_ts) | (ids > max_init))
    logits = torch.where(first, NEG_INF, logits)

    # probability mass: timestamps more likely than any text token -> force one
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts, logprobs, NEG_INF), dim=-1)
    text_max = torch.where(is_ts, NEG_INF, logprobs).amax(dim=-1)
    force = (ts_mass > text_max)[:, None]
    return torch.where(force & (~is_ts), NEG_INF, logits)


def _apply_rules_logprobs(logits, *, ti: TokenizerInfo,
                          opts: DecodingOptions, static_mask, n_sampled,
                          last_tok, penult_tok, max_ts_tok):
    """Logit rules fused with ``log_softmax``: one suppress mask for the
    logits-independent rules, one softmax, and the probability-mass rule
    by analytic renormalization (``lp - ts_mass`` over the timestamp
    block).  logits: (N, V) f32; the other state is per row (N,)."""
    v = ti.n_vocab
    dev = logits.device
    ids = torch.arange(v, device=dev)[None, :]
    masked = logits + static_mask[None, :]

    sup = torch.zeros(masked.shape, dtype=torch.bool, device=dev)
    if opts.suppress_blank:
        # compared against the ids on the device (no host copy: the rules
        # can run inside a CUDA graph capture)
        blank = ids[0] == ti.eot
        for t in ti.blank:
            blank = blank | (ids[0] == t)
        sup = sup | ((n_sampled == 0)[:, None] & blank[None, :])

    ts0 = ti.timestamp_begin
    is_ts = ids >= ts0
    if opts.without_timestamps:
        return torch.log_softmax(
            torch.where(sup | is_ts, NEG_INF, masked), dim=-1)

    last_is_ts = last_tok >= ts0
    penult_is_ts = penult_tok >= ts0
    active = n_sampled > 0
    rule_a = ((active & last_is_ts
               & ((n_sampled < 2) | penult_is_ts))[:, None] & is_ts)
    unpaired_last = active & last_is_ts & (n_sampled >= 2) & (~penult_is_ts)
    rule_b = unpaired_last[:, None] & ((~is_ts) & (ids != ti.eot))
    floor = torch.clamp(max_ts_tok + torch.where(unpaired_last, 0, 1), min=ts0)
    has_ts = max_ts_tok > 0
    mono = is_ts & (ids < floor[:, None]) & (active & has_ts)[:, None]
    max_init = ts0 + int(round(opts.max_initial_timestamp / 0.02))
    first = (n_sampled == 0)[:, None] & ((~is_ts) | (ids > max_init))
    sup = sup | rule_a | rule_b | mono | first

    lp = torch.log_softmax(torch.where(sup, NEG_INF, masked), dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts, lp, NEG_INF), dim=-1)
    text_max = torch.where(is_ts, NEG_INF, lp).amax(dim=-1)
    force = (ts_mass > text_max)[:, None]
    return torch.where(force,
                       torch.where(is_ts, lp - ts_mass[:, None], NEG_INF),
                       lp)


def _rules_logprobs(logits, *, opts: DecodingOptions, **state):
    """Log-probabilities after the logit rules: the one-pass
    :func:`_apply_rules_logprobs`, or with ``opts.unfused_rules``
    ``log_softmax`` of :func:`_apply_rules`."""
    if opts.unfused_rules:
        return torch.log_softmax(_apply_rules(logits, opts=opts, **state), dim=-1)
    return _apply_rules_logprobs(logits, opts=opts, **state)


def _env_unfused_rules() -> bool:
    """Explicit truthiness for TTASR_UNFUSED_RULES: "0"/"false"/"no"/""
    disable, "1"/"true"/"yes" enable (any other non-empty value also
    enables, with the usual flag-env convention)."""
    val = os.environ.get("TTASR_UNFUSED_RULES", "").strip().lower()
    return val not in ("", "0", "false", "no")


def _with_env_rules(opts: DecodingOptions) -> DecodingOptions:
    """``opts`` with ``unfused_rules`` set when TTASR_UNFUSED_RULES is,
    read at call time as the reference's decode wrappers do."""
    if _env_unfused_rules() and not opts.unfused_rules:
        return dataclasses.replace(opts, unfused_rules=True)
    return opts


# ---------------------------------------------------------------------------
# Cache growth and beam reorder
# ---------------------------------------------------------------------------

def _growth_buckets(max_prompt: int, sample_len: int, min_cap: int = 32):
    """Cache-length schedule: the self-attention read cost tracks the
    current cache length, so decoding in growing buckets (32/64/128/...
    new-token capacity) pays the triangular cost, not the rectangular one."""
    buckets = []
    cap = max(min_cap, 1)
    while cap < sample_len:
        buckets.append(max_prompt + cap)
        cap *= 2
    buckets.append(max_prompt + sample_len)
    return buckets


def _tile_cache_rows(cache: DecodeCache, k: int) -> DecodeCache:
    """Repeat the self caches (and their scales) K x along the row axis
    (beam expansion after a B-row prefill).  Cross K/V stay at B."""
    if k == 1:
        return cache

    def rep(x):
        return None if x is None else x.repeat_interleave(k, dim=1)

    return dataclasses.replace(cache, k=rep(cache.k), v=rep(cache.v),
                               ks=rep(cache.ks), vs=rep(cache.vs))


def _pad_cache_to(cache: DecodeCache, new_len: int) -> DecodeCache:
    """Grow the self-KV caches (len axis) to ``new_len`` slots; flat
    scales (L, rows, HP, len) grow on their last axis, 5-D ones (L, rows,
    len, H) on axis 2."""
    cur = cache.k.shape[2]
    if cur >= new_len:
        return cache

    def grow(x, axis=2):
        shape = list(x.shape)
        shape[axis] = new_len - cur
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    if cache.quantized:
        sc_axis = 3 if cache.flat else 2
        return dataclasses.replace(cache, k=grow(cache.k), v=grow(cache.v),
                                   ks=grow(cache.ks, sc_axis),
                                   vs=grow(cache.vs, sc_axis))
    return dataclasses.replace(cache, k=grow(cache.k), v=grow(cache.v))


def _gather_cache(cache: DecodeCache, idx, spare=None):
    """Reorder the self caches' row axis by ``idx``; returns (the new
    cache, the buffers it leaves free).  Cross K/V are shared by the beams
    of an audio and are not gathered.  The flat int8 caches go through B17
    (``gather_cache_rows``, all four tensors in one launch) out of place
    into ``spare``, the buffers an earlier gather left free (when their
    shapes still match), so two sets of buffers swap each step."""
    old = (cache.k, cache.v, cache.ks, cache.vs)
    if cache.quantized and cache.flat:
        if spare is not None and any(a.shape != b.shape
                                     for a, b in zip(spare, old)):
            spare = None
        k, v, ks, vs = gather_cache_rows(*old, idx, spare)
        return dataclasses.replace(cache, k=k, v=v, ks=ks, vs=vs), old
    k, v, ks, vs = (None if t is None else t.index_select(1, idx)
                    for t in old)
    return dataclasses.replace(cache, k=k, v=v, ks=ks, vs=vs), None


def _top_k(x, k: int):
    """``lax.top_k`` along the last axis: ties keep the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _prompt_tensors(prompt, pad_len, device):
    return (torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(pad_len), dtype=torch.long, device=device))


def _no_speech_prob(params, hidden, prompt, ti: TokenizerInfo,
                    cfg: Optional[WhisperConfig] = None, tp_group=None):
    """P(no_speech) at the sot position's logits (faster-whisper), the
    whole vocabulary's (gathered over a vocabulary-split ``embed``)."""
    b, width = prompt.shape
    if ti.no_speech is None:
        return torch.zeros((b,), dtype=torch.float32, device=prompt.device)
    ar = torch.arange(width, device=prompt.device)
    sot_slot = torch.argmax((prompt == ti.sot).long() * ar[None, :], dim=1)
    sot_hidden = hidden[torch.arange(b, device=prompt.device), sot_slot]
    return torch.softmax(_logits_at(params, sot_hidden, cfg, tp_group),
                         dim=-1)[:, ti.no_speech]


# ---------------------------------------------------------------------------
# Greedy / sampling decode
# ---------------------------------------------------------------------------

def _cache_flags(params, cfg: WhisperConfig, opts: DecodingOptions) -> dict:
    return dict(kv_int8=opts.kv_int8, cross_kv_int8=opts.cross_kv_int8,
                cross_kv_int4=_use_cross_int4(params, cfg, opts),
                flat_kv=_use_flat_kv(params, cfg, opts),
                kv_int4=_use_self_int4(params, cfg, opts))


def greedy_decode(params, cfg: WhisperConfig, enc_out, prompt, pad_len,
                  rng: Optional[torch.Generator] = None, temperature=None, *,
                  opts: DecodingOptions, ti: TokenizerInfo):
    """Greedy / temperature-sampled decode of one batch of windows.

    Args:
      enc_out: (B, S, d) encoder states on the device.
      prompt: (B, W) left-padded prompt; pad_len: (B,) pad slots.
      rng: generator on enc_out's device, needed when a temperature > 0
        (Gumbel-max sampling, like ``jax.random.categorical``).
      temperature: scalar or per-row (B,); defaults to opts.temperature.

    Returns dict with tokens (B, sample_len), lengths, sum_logprob,
    no_speech_prob, plus ``steps`` (decode steps run) and
    ``logits_finite`` (every step's logits were finite).
    """
    opts = _with_env_rules(opts)
    tp = _tp_setup(params, cfg, opts)
    if _use_flat_kv(params, cfg, opts):
        params = _f32_decoder_vectors(params)
    dev = enc_out.device
    b = enc_out.shape[0]
    s_real = enc_out.shape[1]
    prompt, pad_len = _prompt_tensors(prompt, pad_len, dev)
    temps = np.broadcast_to(np.asarray(
        opts.temperature if temperature is None else temperature,
        np.float32), (b,))
    sampling = bool((temps > 0).any())
    if sampling and rng is None:
        raise ValueError("temperature > 0 needs a torch.Generator")
    temp_t = torch.as_tensor(np.array(temps), device=dev)
    max_prompt = prompt.shape[1]
    buckets = _growth_buckets(max_prompt, opts.sample_len, opts.growth_min_cap)
    cache = init_cache(params, cfg, enc_out, max_len=buckets[0],
                       **_cache_flags(params, cfg, opts))
    hidden, cache = _prefill(params, cfg, prompt, pad_len, cache,
                             s_real, *tp)
    no_speech_prob = _no_speech_prob(params, hidden, prompt, ti, cfg, tp[0])

    static_mask = torch.from_numpy(_static_suppress_mask(ti)).to(dev)
    logits = _logits_at(params, hidden[:, -1], cfg, tp[0])
    finite = torch.isfinite(logits).all()
    tokens = torch.full((b, opts.sample_len), ti.eot, dtype=torch.long, device=dev)
    n = torch.zeros((b,), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    sum_logprob = torch.zeros((b,), dtype=torch.float32, device=dev)
    last = torch.full((b,), -1, dtype=torch.long, device=dev)
    penult = torch.full((b,), -1, dtype=torch.long, device=dev)
    max_ts = torch.zeros((b,), dtype=torch.long, device=dev)

    step = 0
    for bucket_len in buckets:
        cache = _pad_cache_to(cache, bucket_len)
        cap = bucket_len - max_prompt
        while step < cap and step < opts.sample_len and not bool(finished.all()):
            logprobs = _rules_logprobs(
                logits, ti=ti, opts=opts, static_mask=static_mask,
                n_sampled=n, last_tok=last, penult_tok=penult,
                max_ts_tok=max_ts)
            next_tok = torch.argmax(logprobs, dim=-1)
            if sampling:
                noise = torch.empty_like(logprobs).exponential_(generator=rng)
                scaled = logprobs / torch.clamp(temp_t, min=1e-6)[:, None]
                sampled_tok = torch.argmax(scaled - torch.log(noise), dim=-1)
                next_tok = torch.where(temp_t > 0.0, sampled_tok, next_tok)
            tok_logprob = torch.gather(logprobs, 1, next_tok[:, None])[:, 0]
            newly_finished = next_tok == ti.eot
            active = ~finished
            # faster/openai include the eot logprob in sum_logprob
            sum_logprob = sum_logprob + torch.where(active, tok_logprob, 0.0)
            write_tok = torch.where(active, next_tok, ti.eot)
            tokens[:, step] = write_tok
            sampled = active & (~newly_finished)
            penult = torch.where(sampled, last, penult)
            last = torch.where(sampled, next_tok, last)
            is_ts = sampled & (next_tok >= ti.timestamp_begin)
            max_ts = torch.where(is_ts, torch.maximum(max_ts, next_tok), max_ts)
            n = n + sampled.long()
            finished = finished | newly_finished
            logits, cache = _step(params, cfg, write_tok[:, None],
                                  max_prompt + step, pad_len, cache,
                                  None, s_real, *tp)
            finite = finite & torch.isfinite(logits).all()
            step += 1
    return {
        "tokens": tokens,
        "lengths": n,
        "sum_logprob": sum_logprob,
        "no_speech_prob": no_speech_prob,
        "steps": step,
        "logits_finite": bool(finite),
    }


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _update_finished(top_val, src_beam, is_eot, tokens, n, fin_tokens, fin_len,
                     fin_logprob, fin_count):
    """The finished set after one beam step (openai
    ``BeamSearchDecoder.update``): the best-first scan of the (B, 2K)
    candidates stops once K non-eot survivors are found, so an eot
    candidate is stored only if it ranks above the K-th survivor, into the
    audio's next free slot of K.  Returns (fin_tokens, fin_len,
    fin_logprob, fin_count)."""
    b, k, sample_len = fin_tokens.shape
    non_eot = (~is_eot).long()
    non_eot_before = torch.cumsum(non_eot, dim=1) - non_eot
    qualifies = is_eot & (non_eot_before < k)
    eot_rank = torch.cumsum(qualifies.long(), dim=1) - 1
    slot = fin_count[:, None] + eot_rank
    can_store = qualifies & (slot < k) & (eot_rank >= 0)
    ar_b = torch.arange(b, device=src_beam.device)
    src_flat = (ar_b[:, None] * k + src_beam).reshape(-1)
    cand_tokens = tokens[src_flat].reshape(b, 2 * k, sample_len)
    cand_n = n[src_flat].reshape(b, 2 * k)
    # at most one storable candidate per target slot
    ar_k = torch.arange(k, device=src_beam.device)
    sel = can_store[:, None, :] & (slot[:, None, :] == ar_k[None, :, None])
    has = sel.any(dim=2)                                # (B, K)
    idx = torch.argmax(sel.long(), dim=2)               # (B, K)
    got_tokens = torch.gather(
        cand_tokens, 1, idx[:, :, None].expand(b, k, sample_len))
    fin_tokens = torch.where(has[:, :, None], got_tokens, fin_tokens)
    fin_len = torch.where(has, torch.gather(cand_n, 1, idx), fin_len)
    fin_logprob = torch.where(has, torch.gather(top_val, 1, idx), fin_logprob)
    fin_count = torch.clamp(fin_count + can_store.long().sum(dim=1), max=k)
    return fin_tokens, fin_len, fin_logprob, fin_count


def _survivors(top_val, src_beam, tok, is_eot, k: int):
    """The K best non-eot candidates of each audio: their tokens (B, K),
    scores (B, K) and flat source rows (B * K,)."""
    surv_score = torch.where(is_eot, NEG_INF, top_val)
    surv_rank = torch.argsort(-surv_score, dim=1, stable=True)[:, :k]
    sel_src = torch.gather(src_beam, 1, surv_rank)
    ar_b = torch.arange(src_beam.shape[0], device=src_beam.device)
    return (torch.gather(tok, 1, surv_rank), torch.gather(surv_score, 1, surv_rank),
            (ar_b[:, None] * k + sel_src).reshape(-1))


def _permute_ancestry(anc, sel_flat_src, pos: int, own_row):
    """The ancestry map after a beam step: each row takes its source row's
    map, and the new entry at ``pos`` lands in the row's own physical
    row."""
    anc = anc[sel_flat_src]
    anc[:, pos] = own_row
    return anc


@dataclasses.dataclass
class _BeamLoop:
    """What a beam step reads and advances: the live beams (rows B * K),
    the finished set per audio, the next logits, the caches and the
    ancestry map (None where the cache rows are gathered instead; ``spare``
    then holds the buffers the last gather freed)."""

    tokens: torch.Tensor
    n: torch.Tensor
    cum_logprob: torch.Tensor
    last: torch.Tensor
    penult: torch.Tensor
    max_ts: torch.Tensor
    logits: torch.Tensor
    finite: torch.Tensor
    fin_tokens: torch.Tensor
    fin_len: torch.Tensor
    fin_logprob: torch.Tensor
    fin_count: torch.Tensor
    cache: DecodeCache
    anc: Optional[torch.Tensor]
    spare: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class _BeamContext:
    """What stays fixed over a beam decode's steps."""

    ti: TokenizerInfo
    opts: DecodingOptions
    static_mask: torch.Tensor
    max_prompt: int
    own_row: torch.Tensor
    pad_rep: torch.Tensor
    s_real: int
    tp: tuple


def _beam_step(params, cfg: WhisperConfig, st: _BeamLoop, step: int,
               ctx: _BeamContext) -> None:
    """One beam-search step in place on ``st``: the logit rules, the top 2K
    candidates per audio, the finished set, the K survivors (the state,
    and the ancestry map or the cache rows, permuted along them), then the
    decoder step on the new tokens at slot ``max_prompt + step``."""
    ti, opts = ctx.ti, ctx.opts
    b, k = st.fin_tokens.shape[:2]
    v = ti.n_vocab
    logprobs = _rules_logprobs(
        st.logits, ti=ti, opts=opts, static_mask=ctx.static_mask,
        n_sampled=st.n, last_tok=st.last, penult_tok=st.penult,
        max_ts_tok=st.max_ts)
    cand = (st.cum_logprob[:, None] + logprobs).reshape(b, k * v)
    # top 2K candidates so that eot-finishing beams don't starve
    top_val, top_idx = _top_k(cand, 2 * k)         # (B, 2K)
    src_beam = top_idx // v
    tok = top_idx % v
    is_eot = tok == ti.eot
    st.fin_tokens, st.fin_len, st.fin_logprob, st.fin_count = _update_finished(
        top_val, src_beam, is_eot, st.tokens, st.n, st.fin_tokens, st.fin_len,
        st.fin_logprob, st.fin_count)
    sel_tok, sel_score, sel_flat_src = _survivors(top_val, src_beam, tok, is_eot, k)
    st.tokens, st.n, st.last, st.max_ts = (
        t[sel_flat_src] for t in (st.tokens, st.n, st.last, st.max_ts))
    if st.anc is not None:
        st.anc = _permute_ancestry(st.anc, sel_flat_src, ctx.max_prompt + step,
                                   ctx.own_row)
    else:
        st.cache, st.spare = _gather_cache(st.cache, sel_flat_src, st.spare)

    new_tok = sel_tok.reshape(-1)
    st.tokens[:, step] = new_tok
    st.penult = st.last
    st.last = new_tok
    is_ts = new_tok >= ti.timestamp_begin
    st.max_ts = torch.where(is_ts, torch.maximum(st.max_ts, new_tok), st.max_ts)
    st.n = st.n + 1
    st.cum_logprob = sel_score.reshape(-1)
    st.logits, st.cache = _step(params, cfg, new_tok[:, None],
                                ctx.max_prompt + step, ctx.pad_rep, st.cache,
                                st.anc, ctx.s_real, *ctx.tp)
    st.finite = st.finite & torch.isfinite(st.logits).all()


def beam_decode(params, cfg: WhisperConfig, enc_out, prompt, pad_len,
                rng: Optional[torch.Generator] = None, *,
                opts: DecodingOptions, ti: TokenizerInfo):
    """Beam-search decode (beam_size = opts.beam_size) of B windows.

    openai-whisper BeamSearchDecoder semantics: per-audio finished set of
    size K, completion when K sequences have finished, final selection by
    length-penalized total logprob.  ``rng`` is unused (beam search is
    deterministic); it keeps the reference's signature.

    Returns dict with tokens (B, sample_len), lengths, sum_logprob,
    no_speech_prob — the best sequence per audio — plus ``steps`` and
    ``logits_finite`` as :func:`greedy_decode`.
    """
    k = opts.beam_size
    opts = _with_env_rules(opts)
    tp = _tp_setup(params, cfg, opts)
    if _use_flat_kv(params, cfg, opts):
        params = _f32_decoder_vectors(params)
    dev = enc_out.device
    b = enc_out.shape[0]
    s_real = enc_out.shape[1]
    bk = b * k
    L = opts.sample_len
    prompt, pad_len = _prompt_tensors(prompt, pad_len, dev)
    pad_rep = pad_len.repeat_interleave(k)
    max_prompt = prompt.shape[1]
    buckets = _growth_buckets(max_prompt, L, opts.growth_min_cap)
    # prefill once per audio (all K beams share the prompt), then tile
    cache = init_cache(params, cfg, enc_out, max_len=buckets[0],
                       **_cache_flags(params, cfg, opts))
    hidden_b, cache = _prefill(params, cfg, prompt, pad_len, cache,
                               s_real, *tp)
    cache = _tile_cache_rows(cache, k)
    # with beam_indirect the flat int8 caches never reorder: a (rows, len)
    # map of each row's source row within its beam group is permuted
    # instead, starting at the identity (each row holds its own prompt)
    own_row = (torch.arange(bk, device=dev) % k).to(torch.int32)
    anc = None
    if cache.quantized and cache.flat and opts.beam_indirect:
        anc = own_row[:, None].expand(bk, buckets[0]).contiguous()
    no_speech_prob = _no_speech_prob(params, hidden_b, prompt, ti, cfg, tp[0])

    static_mask = torch.from_numpy(_static_suppress_mask(ti)).to(dev)
    max_finished = k  # completion target per audio (patience=1.0)
    ar_b = torch.arange(b, device=dev)

    logits = _logits_at(params, hidden_b[:, -1], cfg, tp[0]).repeat_interleave(k, dim=0)
    st = _BeamLoop(
        tokens=torch.full((bk, L), ti.eot, dtype=torch.long, device=dev),
        n=torch.zeros((bk,), dtype=torch.long, device=dev),
        cum_logprob=torch.where(torch.arange(bk, device=dev) % k == 0,
                                0.0, NEG_INF).to(torch.float32),  # beam 0 live
        last=torch.full((bk,), -1, dtype=torch.long, device=dev),
        penult=torch.full((bk,), -1, dtype=torch.long, device=dev),
        max_ts=torch.zeros((bk,), dtype=torch.long, device=dev),
        logits=logits, finite=torch.isfinite(logits).all(),
        fin_tokens=torch.full((b, k, L), ti.eot, dtype=torch.long, device=dev),
        fin_len=torch.zeros((b, k), dtype=torch.long, device=dev),
        fin_logprob=torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
        fin_count=torch.zeros((b,), dtype=torch.long, device=dev),
        cache=cache, anc=anc)
    ctx = _BeamContext(ti=ti, opts=opts, static_mask=static_mask, max_prompt=max_prompt,
                       own_row=own_row, pad_rep=pad_rep, s_real=s_real, tp=tp)

    step = 0
    for bucket_len in buckets:
        st.cache = _pad_cache_to(st.cache, bucket_len)
        if st.anc is not None and st.anc.shape[1] < bucket_len:
            st.anc = torch.cat([st.anc, own_row[:, None].expand(
                bk, bucket_len - st.anc.shape[1])], dim=1)
        cap = bucket_len - max_prompt
        while (step < cap and step < L
               and not bool((st.fin_count >= max_finished).all())):
            _beam_step(params, cfg, st, step, ctx)
            step += 1
    tokens, n, cum_logprob = st.tokens, st.n, st.cum_logprob
    fin_tokens, fin_len, fin_logprob, fin_count = (st.fin_tokens, st.fin_len,
                                                   st.fin_logprob, st.fin_count)

    # an audio with no finished sequence falls back to its best live beam
    live_best = torch.argmax(cum_logprob.reshape(b, k), dim=1)
    live_tokens = tokens.reshape(b, k, L)[ar_b, live_best]
    live_len = n.reshape(b, k)[ar_b, live_best]
    live_logprob = cum_logprob.reshape(b, k)[ar_b, live_best]
    need_fallback = fin_count == 0
    fin_tokens = torch.where(need_fallback[:, None, None],
                             live_tokens[:, None, :], fin_tokens)
    fin_len = torch.where(need_fallback[:, None], live_len[:, None], fin_len)
    fin_logprob = torch.where(need_fallback[:, None], live_logprob[:, None],
                              fin_logprob)

    # length-penalized selection (GoogleNMT, faster-whisper length_penalty)
    lengths = torch.clamp(fin_len + 1, min=1).to(torch.float32)  # + eot
    if opts.length_penalty is None:
        penalty = lengths
    else:
        penalty = ((5.0 + lengths) / 6.0) ** opts.length_penalty
    scores = torch.where(fin_logprob <= NEG_INF / 2, NEG_INF,
                         fin_logprob / penalty)
    best = torch.argmax(scores, dim=1)
    return {
        "tokens": fin_tokens[ar_b, best],
        "lengths": fin_len[ar_b, best],
        "sum_logprob": fin_logprob[ar_b, best],
        "no_speech_prob": no_speech_prob,
        "steps": step,
        "logits_finite": bool(st.finite),
    }


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def build_prompt(tokenizer, *, language: str = "zh", task: str = "transcribe",
                 without_timestamps: bool = False,
                 prefix_tokens: Sequence[int] = (),
                 previous_tokens: Sequence[int] = (),
                 initial_prompt_tokens: Sequence[int] = ()) -> List[int]:
    """Assemble the decoder prompt (faster-whisper get_prompt semantics):
    ``[sot_prev] + (initial_prompt + previous)[-(127):] + sot_seq + prefix``.
    """
    prompt: List[int] = []
    prev = list(initial_prompt_tokens) + list(previous_tokens)
    if prev:
        prompt.append(tokenizer.sot_prev)
        prompt.extend(prev[-(MAX_PROMPT // 2 - 1):])
    prompt.extend(
        tokenizer.sot_sequence(language, task, predict_timestamps=not without_timestamps)
    )
    if prefix_tokens:
        prompt.extend(prefix_tokens)
    return prompt[-(MAX_PROMPT - 1):]


def pad_prompts(prompts: Sequence[Sequence[int]], pad_value: int,
                width: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to a fixed-width buffer, in the reference's width
    buckets (16/32/64/144/MAX_PROMPT)."""
    b = len(prompts)
    if width is None:
        longest = max((len(p) for p in prompts), default=0)
        width = (16 if longest <= 16
                 else 32 if longest <= 32
                 else 64 if longest <= 64
                 else 144 if longest <= 144 else MAX_PROMPT)
    out = np.full((b, width), pad_value, np.int32)
    pad_len = np.zeros((b,), np.int32)
    for i, p in enumerate(prompts):
        p = list(p)[-width:]
        out[i, width - len(p):] = p
        pad_len[i] = width - len(p)
    return out, pad_len
