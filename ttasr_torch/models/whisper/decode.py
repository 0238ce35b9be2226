"""Whisper decoding: greedy and beam search with CT2-parity logit rules
(port of ``ttasr/models/whisper/decode.py``: the float cache path and the
fused int8 path of one chip).

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
``self_attn_step_int8`` (greedy) -> B3 ``attnout_ln_q_cross_int8`` -> B4
``mlp_with_crossout_int8``, over an int8 or int4 lane-packed flat self-KV
cache and an int8 or int4 cross-KV cache.  Beam search permutes a
(rows, len) ancestry map instead of the caches.  Options off this path
(the unfused int8 graph, bf16 cross-KV beside int8 self-KV, more than 8
beams, ``beam_indirect=False``, tensor parallelism) raise.

The host-side pieces (``DecodingOptions``, ``TokenizerInfo``,
``build_prompt``, ``pad_prompts``, ``compression_ratio`` and the
constants) are declared again because the reference module imports jax;
``tests/test_torch_config.py`` pins them to the originals.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.model import (
    DecodeCache,
    _attention,
    _cross_attention,
    _embed_lookup,
    _ln,
    _merge_heads,
    _mlp,
    _model_dtype,
    _proj,
    _quant_self_attention,
    _split_heads,
    _unembed,
    init_cache,
    quantize_kv,
)
from ttasr_torch.ops.decoder_blocks import (
    MAX_BEAMS,
    attnout_ln_q_cross_int8,
    qkv_int8_fused,
)
from ttasr_torch.ops.decoder_mlp import mlp_with_crossout_int8
from ttasr_torch.ops.int4 import pack_int4_lanes, quantize_kv4, unpack_int4
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
    """Decode configuration.  Same fields and defaults as the reference;
    the flat fused int8 path is ported, tensor parallelism, the
    unfused-rules A/B path and the unfused int8 graph raise in the decode
    functions (:func:`_check_supported`)."""

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
    heads, where the fused decode kernels run."""
    return (opts.kv_int8 and "wqkv" in params["decoder"]["blocks"][0]
            and cfg.d_model // cfg.decoder_heads == 64)


def _use_cross_int4(params, cfg: WhisperConfig, opts: DecodingOptions) -> bool:
    """int4 cross-KV: a sub-mode of ``cross_kv_int8`` on the flat path."""
    return (opts.cross_kv_int4 and opts.cross_kv_int8
            and _use_flat_kv(params, cfg, opts) and cfg.decoder_heads % 2 == 0)


def _use_self_int4(params, cfg: WhisperConfig, opts: DecodingOptions) -> bool:
    """int4 lane-packed self-KV: a sub-mode of ``kv_int8`` on the flat
    path, with an even head count (the D/2 split lands on a head)."""
    return (opts.kv_int4 and opts.kv_int8
            and _use_flat_kv(params, cfg, opts) and cfg.decoder_heads % 2 == 0)


def _f32_decoder_vectors(params):
    """The decoder layers' LayerNorm scales and biases in f32: the fused
    kernels take them in f32 (the TPU kernels upcast them), so this runs
    once per decode instead of per kernel call.  Model-type values are
    exact in f32 and the prefill casts them back, so no result changes."""
    dec = params["decoder"]
    blocks = [{k: (v.float() if torch.is_tensor(v) and v.dim() == 1 else v)
               for k, v in blk.items()} for blk in dec["blocks"]]
    return dict(params, decoder=dict(dec, blocks=blocks))


def _check_supported(params, cfg: WhisperConfig, opts: DecodingOptions,
                     beams: int = 1) -> None:
    """Raise for every option that leaves the ported paths: the float
    cache path and the flat fused int8 path with B1-B4/B10."""
    missing = [name for name in ("unfused_rules", "tp_row_parallel")
               if getattr(opts, name)]
    if opts.tp_axis is not None:
        missing.append("tp_axis")
    if missing:
        raise NotImplementedError(
            f"DecodingOptions {missing} are not ported to ttasr_torch yet "
            f"(ROADMAP A5, A12)")
    flat = _use_flat_kv(params, cfg, opts)
    if opts.kv_int8 and not flat:
        raise NotImplementedError(
            "kv_int8 without fused int8 weights (or with heads other than "
            "64 wide) needs the 5-D int8 cache of the unfused int8 graph, "
            "not ported to ttasr_torch (ROADMAP C)")
    if opts.cross_kv_int8 and not flat:
        raise NotImplementedError(
            "cross_kv_int8 off the flat fused path needs B13 "
            "(cross_attention_int8), not ported yet (ROADMAP B)")
    if flat and (not opts.cross_kv_int8 or cfg.decoder_heads % 2
                 or beams > MAX_BEAMS):
        raise NotImplementedError(
            "the flat int8 path with a bf16 cross-KV, an odd head count or "
            f"more than {MAX_BEAMS} beams needs B12 and B13, not ported yet "
            "(ROADMAP B)")
    if flat and beams > 1 and not opts.beam_indirect:
        raise NotImplementedError(
            "beam_indirect=False on the flat int8 path needs B17 "
            "(gather_cache_rows), not ported yet (ROADMAP B)")


# ---------------------------------------------------------------------------
# Prefill with left-padded prompt
# ---------------------------------------------------------------------------

def _qkv_proj(h, blk, cfg: WhisperConfig):
    """Self-attention q/k/v, through the fused ``wqkv`` leaf when present."""
    n = cfg.decoder_heads
    if "wqkv" in blk:
        qkv = _proj(h, blk["wqkv"], blk["bqkv"])
        return tuple(_split_heads(t, n) for t in qkv.chunk(3, dim=-1))
    return (_split_heads(_proj(h, blk["wq"], blk["bq"]), n),
            _split_heads(_proj(h, blk["wk"]), n),
            _split_heads(_proj(h, blk["wv"], blk["bv"]), n))


def _cross_attn_quantized(qc, ck8, cks_t, cv8, cvs_t, s_real: int):
    """Cross-attention over one layer's quantized cross-KV outside the
    fused kernel: the prompt prefill (the reference's XLA branch), with
    the int4 cache unpacked once per window and slots >= ``s_real``
    masked.  qc: (rows, T, H, Dh); ck8/cv8: (B, S, D) int8 or (B, S/2, D)
    uint8; cks_t/cvs_t: (B, H, S)."""
    bk, t, h, dh = qc.shape
    b = ck8.shape[0]
    group = bk // b
    if t == 1 and group <= MAX_BEAMS and dh == 64 and h % 2 == 0:
        raise NotImplementedError(
            "a single-token quantized cross-attention outside the fused "
            "kernel needs B13 (cross_attention_int8), not ported yet "
            "(ROADMAP B)")
    if ck8.dtype == torch.uint8:
        ck8, cv8 = unpack_int4(ck8), unpack_int4(cv8)
    s = ck8.shape[1]
    mask = (torch.arange(s, device=qc.device) < s_real)[None, None, None, :]
    out = _quant_self_attention(
        qc.reshape(b, group * t, h, dh), ck8.reshape(b, s, h, dh),
        cks_t.transpose(1, 2), cv8.reshape(b, s, h, dh),
        cvs_t.transpose(1, 2), mask)
    return out.reshape(bk, t, h, dh)


def _write_prefill_kv(cache: DecodeCache, i: int, k_new, v_new, t: int):
    """Store the prompt's K/V (B, T, H, Dh) in slots 0..T-1 of layer i:
    as they are, or quantized into the flat int8/int4 layout with the
    scales transposed to (rows, H, T)."""
    if not cache.quantized:
        cache.k[i, :, :t] = k_new
        cache.v[i, :, :t] = v_new
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
             s_real: Optional[int] = None):
    """Teacher-forced pass over the left-padded prompt buffer.

    tokens: (B, W) long, real tokens at positions ``pad_len..W-1`` with
    positional indices ``0..real-1``; pad_len: (B,) long.  Writes slots
    ``0..W-1`` of the self cache in place (quantized on the flat int8
    path).  ``s_real``: valid cross-attention slots of a quantized
    cross-KV (the encoder length; default ``cfg.max_source_positions``).
    Returns (final-LN hidden states (B, W, d), cache).
    """
    if s_real is None:
        s_real = cfg.max_source_positions
    dec = params["decoder"]
    b, t = tokens.shape
    ar = torch.arange(t, device=tokens.device)
    pos_ids = torch.clamp(ar[None, :] - pad_len[:, None], min=0)
    x = (_embed_lookup(dec, tokens) + dec["pos"][pos_ids]).to(_model_dtype(dec))
    valid = ar[None, None, :] >= pad_len[:, None, None]   # pad slots never attend
    causal = ar[None, None, :] <= ar[None, :, None]
    mask = (causal & valid)[:, None]                       # (B, 1, T, T)
    for i, blk in enumerate(dec["blocks"]):
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q, k_new, v_new = _qkv_proj(h, blk, cfg)
        _write_prefill_kv(cache, i, k_new, v_new, t)
        attn = _attention(q, k_new, v_new, mask)  # its own exact K/V block
        x = x + _proj(_merge_heads(attn), blk["wo"], blk["bo"])
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        qc = _split_heads(_proj(hc, blk["wq_c"], blk["bq_c"]), cfg.decoder_heads)
        if cache.cross_quantized:
            cross = _cross_attn_quantized(qc, cache.cross_k[i], cache.cks[i],
                                          cache.cross_v[i], cache.cvs[i],
                                          s_real)
        else:
            cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        x = x + _proj(_merge_heads(cross), blk["wo_c"], blk["bo_c"])
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
    return _ln(x, dec["ln_s"], dec["ln_b"]), cache


def _logits_at(params, hidden):
    """Project selected hidden rows (N, d) to f32 vocab logits (N, V)."""
    return _unembed(hidden, params["decoder"])


def _step_fused(params, cfg: WhisperConfig, x, slot: int, pad_len,
                cache: DecodeCache, anc, s_real: int):
    """The flat fused int8 step (the reference's ``scan_block_fused``
    without the TP branches): per layer B1 -> B2 (``anc`` given) or B10
    -> B3 -> B4.  Each layer's new K/V codes and scales are written at
    ``slot`` after the loop (the kernels read only positions < slot)."""
    dec = params["decoder"]
    bk = x.shape[0]
    b_audio = cache.cross_k.shape[1]
    group = bk // b_audio
    h, d = cfg.decoder_heads, cfg.d_model
    cache_len, d_store = cache.k.shape[2:]
    hp = cache.ks.shape[2]
    pad_g = pad_len.to(torch.int32).reshape(b_audio, group)  # once per step
    anc_g = None if anc is None else anc.reshape(b_audio, group, cache_len)
    new_rows = []
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
        xo, cross = attnout_ln_q_cross_int8(
            x2.reshape(b_audio, group, d), attn,
            blk["wo"]["q"], blk["wo"]["s"], blk["bo"],
            blk["lnc_s"], blk["lnc_b"],
            blk["wq_c"]["q"], blk["wq_c"]["s"], blk["bq_c"],
            cache.cross_k[i], cache.cks[i], cache.cross_v[i], cache.cvs[i],
            s_real)
        x_new = mlp_with_crossout_int8(
            xo.reshape(bk, d), cross.reshape(bk, d),
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
          cache: DecodeCache, anc=None, s_real: Optional[int] = None):
    """Single-token decode at cache slot ``slot``; writes the slot in place.

    token: (B, 1) long.  pad_len: (B,) long — pad slots stay masked.
    anc: optional (rows, len) ancestry map (beam search on the flat int8
    path): the physical row, within the audio's beam group, that holds
    each row's entry at each cache position.
    Returns (logits (B, V) f32, cache).
    """
    if s_real is None:
        s_real = cfg.max_source_positions
    dec = params["decoder"]
    max_len = cache.k.shape[2]
    pos = torch.clamp(slot - pad_len, min=0)              # (B,)
    x = (_embed_lookup(dec, token)
         + dec["pos"][pos][:, None, :]).to(_model_dtype(dec))
    if cache.quantized:
        return _step_fused(params, cfg, x, slot, pad_len, cache, anc, s_real)
    k_ids = torch.arange(max_len, device=token.device)[None, :]
    mask = ((k_ids <= slot) & (k_ids >= pad_len[:, None]))[:, None, None]
    for i, blk in enumerate(dec["blocks"]):
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q, k_new, v_new = _qkv_proj(h, blk, cfg)
        cache.k[i, :, slot] = k_new[:, 0]
        cache.v[i, :, slot] = v_new[:, 0]
        attn = _attention(q, cache.k[i], cache.v[i], mask)
        x = x + _proj(_merge_heads(attn), blk["wo"], blk["bo"])
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        qc = _split_heads(_proj(hc, blk["wq_c"], blk["bq_c"]), cfg.decoder_heads)
        cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        x = x + _proj(_merge_heads(cross), blk["wo_c"], blk["bo_c"])
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _unembed(x[:, 0], dec), cache


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
        blank = torch.zeros((v,), dtype=torch.bool, device=dev)
        blank[list(ti.blank) + [ti.eot]] = True
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
    scales (L, rows, HP, len) grow on their last axis."""
    cur = cache.k.shape[2]
    if cur >= new_len:
        return cache

    def grow(x, axis=2):
        shape = list(x.shape)
        shape[axis] = new_len - cur
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    if cache.quantized:
        return dataclasses.replace(cache, k=grow(cache.k), v=grow(cache.v),
                                   ks=grow(cache.ks, 3), vs=grow(cache.vs, 3))
    return dataclasses.replace(cache, k=grow(cache.k), v=grow(cache.v))


def _gather_cache(cache: DecodeCache, idx) -> DecodeCache:
    """Reorder the float self caches' row axis by ``idx``.  Cross K/V are
    shared by the beams of an audio and are not gathered; the flat int8
    caches never reorder (the ancestry map does)."""
    return dataclasses.replace(cache, k=cache.k.index_select(1, idx),
                               v=cache.v.index_select(1, idx))


def _top_k(x, k: int):
    """``lax.top_k`` along the last axis: ties keep the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _prompt_tensors(prompt, pad_len, device):
    return (torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(pad_len), dtype=torch.long, device=device))


def _no_speech_prob(params, hidden, prompt, ti: TokenizerInfo):
    """P(no_speech) at the sot position's logits (faster-whisper)."""
    b, width = prompt.shape
    if ti.no_speech is None:
        return torch.zeros((b,), dtype=torch.float32, device=prompt.device)
    ar = torch.arange(width, device=prompt.device)
    sot_slot = torch.argmax((prompt == ti.sot).long() * ar[None, :], dim=1)
    sot_hidden = hidden[torch.arange(b, device=prompt.device), sot_slot]
    return torch.softmax(_logits_at(params, sot_hidden), dim=-1)[:, ti.no_speech]


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
    _check_supported(params, cfg, opts)
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
                             s_real=s_real)
    no_speech_prob = _no_speech_prob(params, hidden, prompt, ti)

    static_mask = torch.from_numpy(_static_suppress_mask(ti)).to(dev)
    logits = _logits_at(params, hidden[:, -1])
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
            logprobs = _apply_rules_logprobs(
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
                                  s_real=s_real)
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
    _check_supported(params, cfg, opts, beams=k)
    if _use_flat_kv(params, cfg, opts):
        params = _f32_decoder_vectors(params)
    dev = enc_out.device
    b = enc_out.shape[0]
    s_real = enc_out.shape[1]
    bk = b * k
    v = ti.n_vocab
    L = opts.sample_len
    prompt, pad_len = _prompt_tensors(prompt, pad_len, dev)
    pad_rep = pad_len.repeat_interleave(k)
    max_prompt = prompt.shape[1]
    buckets = _growth_buckets(max_prompt, L, opts.growth_min_cap)
    # prefill once per audio (all K beams share the prompt), then tile
    cache = init_cache(params, cfg, enc_out, max_len=buckets[0],
                       **_cache_flags(params, cfg, opts))
    hidden_b, cache = _prefill(params, cfg, prompt, pad_len, cache,
                               s_real=s_real)
    cache = _tile_cache_rows(cache, k)
    # the flat int8 caches never reorder: a (rows, len) map of each row's
    # source row within its beam group is permuted instead, starting at
    # the identity (each row holds its own prompt)
    own_row = (torch.arange(bk, device=dev) % k).to(torch.int32)
    anc = None
    if cache.quantized:
        anc = own_row[:, None].expand(bk, buckets[0]).contiguous()
    no_speech_prob = _no_speech_prob(params, hidden_b, prompt, ti)

    static_mask = torch.from_numpy(_static_suppress_mask(ti)).to(dev)
    max_finished = k  # completion target per audio (patience=1.0)
    ar_b = torch.arange(b, device=dev)
    ar_k = torch.arange(k, device=dev)

    tokens = torch.full((bk, L), ti.eot, dtype=torch.long, device=dev)
    n = torch.zeros((bk,), dtype=torch.long, device=dev)
    cum_logprob = torch.where(torch.arange(bk, device=dev) % k == 0,
                              0.0, NEG_INF).to(torch.float32)  # beam 0 live
    last = torch.full((bk,), -1, dtype=torch.long, device=dev)
    penult = torch.full((bk,), -1, dtype=torch.long, device=dev)
    max_ts = torch.zeros((bk,), dtype=torch.long, device=dev)
    logits = _logits_at(params, hidden_b[:, -1]).repeat_interleave(k, dim=0)
    finite = torch.isfinite(logits).all()
    fin_tokens = torch.full((b, k, L), ti.eot, dtype=torch.long, device=dev)
    fin_len = torch.zeros((b, k), dtype=torch.long, device=dev)
    fin_logprob = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    fin_count = torch.zeros((b,), dtype=torch.long, device=dev)

    step = 0
    for bucket_len in buckets:
        cache = _pad_cache_to(cache, bucket_len)
        if anc is not None and anc.shape[1] < bucket_len:
            anc = torch.cat([anc, own_row[:, None].expand(
                bk, bucket_len - anc.shape[1])], dim=1)
        cap = bucket_len - max_prompt
        while (step < cap and step < L
               and not bool((fin_count >= max_finished).all())):
            logprobs = _apply_rules_logprobs(
                logits, ti=ti, opts=opts, static_mask=static_mask,
                n_sampled=n, last_tok=last, penult_tok=penult,
                max_ts_tok=max_ts)
            cand = (cum_logprob[:, None] + logprobs).reshape(b, k * v)
            # top 2K candidates so that eot-finishing beams don't starve
            top_val, top_idx = _top_k(cand, 2 * k)         # (B, 2K)
            src_beam = top_idx // v
            tok = top_idx % v
            is_eot = tok == ti.eot

            # finished bookkeeping (openai BeamSearchDecoder.update): the
            # best-first scan stops once K non-eot survivors are found, so
            # an eot candidate is stored only if it ranks above the K-th
            # survivor
            non_eot = (~is_eot).long()
            non_eot_before = torch.cumsum(non_eot, dim=1) - non_eot
            qualifies = is_eot & (non_eot_before < k)
            eot_rank = torch.cumsum(qualifies.long(), dim=1) - 1
            slot = fin_count[:, None] + eot_rank
            can_store = qualifies & (slot < k) & (eot_rank >= 0)
            src_flat = (ar_b[:, None] * k + src_beam).reshape(-1)
            cand_tokens = tokens[src_flat].reshape(b, 2 * k, L)
            cand_n = n[src_flat].reshape(b, 2 * k)
            # at most one storable candidate per target slot
            sel = can_store[:, None, :] & (slot[:, None, :] == ar_k[None, :, None])
            has = sel.any(dim=2)                                # (B, K)
            idx = torch.argmax(sel.long(), dim=2)               # (B, K)
            got_tokens = torch.gather(
                cand_tokens, 1, idx[:, :, None].expand(b, k, L))
            fin_tokens = torch.where(has[:, :, None], got_tokens, fin_tokens)
            fin_len = torch.where(has, torch.gather(cand_n, 1, idx), fin_len)
            fin_logprob = torch.where(has, torch.gather(top_val, 1, idx),
                                      fin_logprob)
            fin_count = torch.clamp(fin_count + can_store.long().sum(dim=1),
                                    max=k)

            # K surviving (non-eot) candidates, reorder state along beams
            surv_score = torch.where(is_eot, NEG_INF, top_val)
            surv_rank = torch.argsort(-surv_score, dim=1, stable=True)[:, :k]
            sel_tok = torch.gather(tok, 1, surv_rank)
            sel_score = torch.gather(surv_score, 1, surv_rank)
            sel_src = torch.gather(src_beam, 1, surv_rank)
            sel_flat_src = (ar_b[:, None] * k + sel_src).reshape(-1)
            tokens = tokens[sel_flat_src]
            n = n[sel_flat_src]
            last = last[sel_flat_src]
            max_ts = max_ts[sel_flat_src]
            if anc is not None:
                # the new entry lands in each row's own physical row
                anc = anc[sel_flat_src]
                anc[:, max_prompt + step] = own_row
            else:
                cache = _gather_cache(cache, sel_flat_src)

            new_tok = sel_tok.reshape(-1)
            tokens[:, step] = new_tok
            penult = last
            last = new_tok
            is_ts = new_tok >= ti.timestamp_begin
            max_ts = torch.where(is_ts, torch.maximum(max_ts, new_tok), max_ts)
            n = n + 1
            cum_logprob = sel_score.reshape(-1)
            logits, cache = _step(params, cfg, new_tok[:, None],
                                  max_prompt + step, pad_rep, cache, anc,
                                  s_real=s_real)
            finite = finite & torch.isfinite(logits).all()
            step += 1

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
        "logits_finite": bool(finite),
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
