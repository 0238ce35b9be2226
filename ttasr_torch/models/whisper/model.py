"""Whisper encoder-decoder in PyTorch (port of
``ttasr/models/whisper/model.py``, float paths).

Parameters are a plain nested dict with the JAX package's leaf names and
layouts (linear weights ``(in, out)``, conv weights ``(k, in, out)``); the
per-layer blocks are a list of dicts instead of stacked arrays, since an
eager loop over layers replaces ``lax.scan``.  Matmuls accumulate in f32
as the reference's ``preferred_element_type`` does; attention scores,
softmax and logits are f32.

The encoder's self-attention goes through the Hopper kernel
(:func:`ttasr_torch.ops.encoder_attention.encoder_attention_merged`) for
64-wide heads; that wrapper runs its plain PyTorch version on CPU tensors.
The decode cache is updated in place (the JAX version returns a new one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.ops.encoder_attention import encoder_attention_merged

Params = Dict[str, Any]
NEG_MASK = torch.finfo(torch.float32).min  # as the reference: never -inf


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid table (used to init encoder positions)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _block_init(gen, n_layers, d, ffn, cross: bool, dtype, device) -> List[dict]:
    def dense(*shape):
        w = torch.randn((n_layers,) + shape, generator=gen, device=device)
        return (w * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full((n_layers,) + shape, value, dtype=dtype, device=device)

    blk = {
        "ln1_s": const(1.0, d), "ln1_b": const(0.0, d),
        "wq": dense(d, d), "bq": const(0.0, d),
        "wk": dense(d, d),
        "wv": dense(d, d), "bv": const(0.0, d),
        "wo": dense(d, d), "bo": const(0.0, d),
        "ln2_s": const(1.0, d), "ln2_b": const(0.0, d),
        "w1": dense(d, ffn), "b1": const(0.0, ffn),
        "w2": dense(ffn, d), "b2": const(0.0, d),
    }
    if cross:
        blk.update({
            "lnc_s": const(1.0, d), "lnc_b": const(0.0, d),
            "wq_c": dense(d, d), "bq_c": const(0.0, d),
            "wk_c": dense(d, d),
            "wv_c": dense(d, d), "bv_c": const(0.0, d),
            "wo_c": dense(d, d), "bo_c": const(0.0, d),
        })
    return unstack_blocks(blk)


def unstack_blocks(stacked: Dict[str, torch.Tensor]) -> List[dict]:
    """Stacked ``(L, ...)`` leaves -> one dict of views per layer."""
    n = len(next(iter(stacked.values())))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def init_params(cfg: WhisperConfig, seed: int = 0, dtype=torch.float32,
                device="cpu") -> Params:
    """Random-init parameters (the JAX package's structure and scales:
    N(0, 0.02) weights, zero biases, unit LN scales, sinusoid encoder
    positions), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, ffn = cfg.d_model, cfg.ffn_dim

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    pos = torch.from_numpy(sinusoidal_positions(cfg.max_source_positions, d))
    return {
        "encoder": {
            "conv1_w": dense(3, cfg.num_mel_bins, d), "conv1_b": const(0.0, d),
            "conv2_w": dense(3, d, d), "conv2_b": const(0.0, d),
            "pos": pos.to(device=device, dtype=dtype),
            "blocks": _block_init(gen, cfg.encoder_layers, d, ffn, False,
                                  dtype, device),
            "ln_s": const(1.0, d), "ln_b": const(0.0, d),
        },
        "decoder": {
            "embed": dense(cfg.vocab_size, d),
            "pos": dense(cfg.max_target_positions, d),
            "blocks": _block_init(gen, cfg.decoder_layers, d, ffn, True,
                                  dtype, device),
            "ln_s": const(1.0, d), "ln_b": const(0.0, d),
        },
    }


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

def _ln(x, scale, bias, eps=1e-5):
    """LayerNorm with f32 statistics, output in x's type."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)


def _proj(x, w, b=None):
    """x @ w (+ b): f32 accumulation, output in x's type."""
    w = w.to(x.dtype)
    if b is None:
        return torch.matmul(x, w)
    out = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _model_dtype(dec) -> torch.dtype:
    return dec["pos"].dtype


def _unembed(x, dec):
    """Hidden states -> f32 vocab logits via the tied embedding (bf16
    values multiply exactly in f32, as the reference's f32-accumulated
    bf16 matmul does)."""
    return torch.matmul(x.float(), dec["embed"].float().t())


def _split_heads(x, n_heads):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _merge_heads(x):
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def _attention(q, k, v, mask=None):
    """q,k,v: (B, T, H, Dh). mask: bool, broadcastable to (B, H, Tq, Tk)."""
    scale = q.shape[-1] ** -0.5
    qh = (q * scale).transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2))           # (B, H, Tq, Tk)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_MASK)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v.transpose(1, 2).to(q.dtype))  # (B, H, Tq, Dh)
    return out.transpose(1, 2)


def _enc_qkv(x, blk):
    return (_proj(x, blk["wq"], blk["bq"]), _proj(x, blk["wk"]),
            _proj(x, blk["wv"], blk["bv"]))


def _self_attn(x, blk, n_heads, mask=None, fused: bool = False,
               t_real=None):
    dh = x.shape[-1] // n_heads
    if fused and mask is None and dh == 64:
        # merged-layout kernel: scores never reach device memory and the
        # output is already in the layout the out-projection consumes
        qm, km, vm = _enc_qkv(x, blk)
        qm = qm * (dh ** -0.5)
        out_m = encoder_attention_merged(
            qm, km, vm, t_real if t_real is not None else x.shape[1])
        return _proj(out_m, blk["wo"], blk["bo"])
    q, k, v = _enc_qkv(x, blk)
    out = _attention(_split_heads(q, n_heads), _split_heads(k, n_heads),
                     _split_heads(v, n_heads), mask)
    return _proj(_merge_heads(out), blk["wo"], blk["bo"])


def _mlp(x, blk):
    h = F.gelu(_proj(x, blk["w1"], blk["b1"]))  # exact erf GELU
    return _proj(h, blk["w2"], blk["b2"])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params: Params, cfg: WhisperConfig, mel, *,
           fused_attention: Optional[bool] = None):
    """mel: (B, n_mels, frames) -> hidden states (B, frames // 2, d_model).

    ``fused_attention`` (default on) routes the self-attention of 64-wide
    heads through the encoder-attention kernel.  Unlike the TPU kernel it
    needs no padding of T to a tile multiple.
    """
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = F.gelu(F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), enc["conv1_b"],
                        padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), enc["conv2_b"],
                        stride=2, padding=1))
    x = x.transpose(1, 2)                                     # (B, T, D)
    # pos slices to the mel length (short windows encode a prefix)
    x = x.to(enc["pos"].dtype) + enc["pos"][: x.shape[1]]
    fused = True if fused_attention is None else fused_attention
    t_real = x.shape[1]
    for blk in enc["blocks"]:
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        x = x + _self_attn(h, blk, cfg.encoder_heads, fused=fused,
                           t_real=t_real)
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
    return _ln(x, enc["ln_s"], enc["ln_b"])


# ---------------------------------------------------------------------------
# Decoder — teacher-forced (training / prompt prefill)
# ---------------------------------------------------------------------------

def decode_train(params: Params, cfg: WhisperConfig, tokens, enc_out, *,
                 positions_offset: int = 0):
    """Full-sequence decoder pass. tokens: (B, T) int -> logits (B, T, V)."""
    dec = params["decoder"]
    b, t = tokens.shape
    x = dec["embed"][tokens] + dec["pos"][positions_offset: positions_offset + t]
    x = x.to(_model_dtype(dec))
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=x.device))[None, None]
    for blk in dec["blocks"]:
        x = x + _self_attn(_ln(x, blk["ln1_s"], blk["ln1_b"]), blk,
                           cfg.decoder_heads, causal)
        h = _ln(x, blk["lnc_s"], blk["lnc_b"])
        q = _split_heads(_proj(h, blk["wq_c"], blk["bq_c"]), cfg.decoder_heads)
        k = _split_heads(_proj(enc_out, blk["wk_c"]), cfg.decoder_heads)
        v = _split_heads(_proj(enc_out, blk["wv_c"], blk["bv_c"]), cfg.decoder_heads)
        x = x + _proj(_merge_heads(_attention(q, k, v)), blk["wo_c"], blk["bo_c"])
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _unembed(x, dec)


# ---------------------------------------------------------------------------
# Decoder — incremental with KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    """Self-attention K/V (L, rows, max_len, H, Dh) and cross-attention
    K/V (L, B, src_len, H, Dh), in the model type.  Beams of one audio
    share the cross K/V (rows = B * beams)."""
    k: torch.Tensor
    v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def init_cache(params: Params, cfg: WhisperConfig, enc_out, max_len: int,
               beam_expand: int = 1) -> DecodeCache:
    """Allocate the self-attn cache and compute cross-attn K/V per layer."""
    dec = params["decoder"]
    b = enc_out.shape[0]
    h = cfg.decoder_heads
    dh = cfg.d_model // h
    shape = (cfg.decoder_layers, b * beam_expand, max_len, h, dh)
    ck = torch.stack([_split_heads(_proj(enc_out, blk["wk_c"]), h)
                      for blk in dec["blocks"]])
    cv = torch.stack([_split_heads(_proj(enc_out, blk["wv_c"], blk["bv_c"]), h)
                      for blk in dec["blocks"]])
    zeros = lambda: torch.zeros(shape, dtype=enc_out.dtype,  # noqa: E731
                                device=enc_out.device)
    return DecodeCache(k=zeros(), v=zeros(), cross_k=ck, cross_v=cv)


def _cross_attention(q, ck, cv):
    """Cross-attention where q rows may be beam-grouped.

    q: (BK, T, H, Dh); ck/cv: (B, S, H, Dh) with BK = B * K.  Beams of
    the same audio attend the same K/V without a B*K copy.
    """
    bk, t, h, dh = q.shape
    b = ck.shape[0]
    if bk == b:
        return _attention(q, ck, cv)
    k_group = bk // b
    out = _attention(q.reshape(b, k_group * t, h, dh), ck, cv)
    return out.reshape(bk, t, h, dh)


def decode_step(params: Params, cfg: WhisperConfig, tokens, pos: int,
                cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
    """One incremental decode step; writes the new K/V into ``cache`` in
    place.

    tokens: (B, T_new) — usually T_new=1; T_new>1 prefills a prompt.
    pos: index of the first new token.
    Returns (logits (B, T_new, V) f32, cache).
    """
    dec = params["decoder"]
    b, t_new = tokens.shape
    max_len = cache.k.shape[2]
    x = dec["embed"][tokens] + dec["pos"][pos: pos + t_new]
    x = x.to(_model_dtype(dec))
    q_ids = pos + torch.arange(t_new, device=x.device)[:, None]
    k_ids = torch.arange(max_len, device=x.device)[None, :]
    mask = (k_ids <= q_ids)[None, None]  # (1, 1, T_new, max_len)
    h_n = cfg.decoder_heads
    for i, blk in enumerate(dec["blocks"]):
        h = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q = _split_heads(_proj(h, blk["wq"], blk["bq"]), h_n)
        cache.k[i, :, pos: pos + t_new] = _split_heads(_proj(h, blk["wk"]), h_n)
        cache.v[i, :, pos: pos + t_new] = _split_heads(
            _proj(h, blk["wv"], blk["bv"]), h_n)
        attn = _attention(q, cache.k[i], cache.v[i], mask)
        x = x + _proj(_merge_heads(attn), blk["wo"], blk["bo"])
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        qc = _split_heads(_proj(hc, blk["wq_c"], blk["bq_c"]), h_n)
        cross = _cross_attention(qc, cache.cross_k[i], cache.cross_v[i])
        x = x + _proj(_merge_heads(cross), blk["wo_c"], blk["bo_c"])
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
    x = _ln(x, dec["ln_s"], dec["ln_b"])
    return _unembed(x, dec), cache

