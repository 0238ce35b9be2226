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
from ttasr_torch.ops.int4 import pack_int4, pack_int4_lanes, quantize_kv4
from ttasr_torch.ops.quant import is_quantized, quant_matmul, quantize_kv_sym

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


def _layer(leaf, i):
    if isinstance(leaf, dict):  # a quantized {"q", "s"} leaf
        return {k: v[i] for k, v in leaf.items()}
    return leaf[i]


def unstack_blocks(stacked: Dict[str, Any]) -> List[dict]:
    """Stacked ``(L, ...)`` leaves (tensors, or quantized ``{"q", "s"}``
    dicts of stacked tensors) -> one dict of views per layer."""
    first = next(iter(stacked.values()))
    n = len(first["q"] if isinstance(first, dict) else first)
    return [{k: _layer(v, i) for k, v in stacked.items()} for i in range(n)]


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
    """x @ w (+ b): f32 accumulation, output in x's type.  A quantized
    leaf runs :func:`quant_matmul` (f32 out) and adds the bias in f32
    before the one cast, as the reference does."""
    if is_quantized(w):
        out = quant_matmul(x, w)
        if b is not None:
            out = out + b.float()
        return out.to(x.dtype)
    w = w.to(x.dtype)
    if b is None:
        return torch.matmul(x, w)
    out = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _model_dtype(dec) -> torch.dtype:
    return dec["pos"].dtype


def _embed_lookup(dec, tokens):
    """Token embedding gather, quantization-aware (codes x row scale)."""
    e = dec["embed"]
    if is_quantized(e):
        return (e["q"][tokens].float() * e["s"][tokens]).to(_model_dtype(dec))
    return e[tokens]


def _unembed(x, dec):
    """Hidden states -> f32 vocab logits via the tied embedding (bf16
    values and int8 codes multiply exactly in f32, as the reference's
    f32-accumulated matmul does); a quantized embed applies its per-row
    scale to the logits."""
    e = dec["embed"]
    if is_quantized(e):
        return torch.matmul(x.float(), e["q"].float().t()) * e["s"][:, 0]
    return torch.matmul(x.float(), e.float().t())


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
    """q/k/v projections, through the fused (D, 3D) leaf when present."""
    if "wqkv" in blk:
        qkv = _proj(x, blk["wqkv"], blk["bqkv"])
        d = x.shape[-1]
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
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
        # the fused wqkv leaf yields column slices; the kernel reads
        # contiguous (B, T, D) operands
        out_m = encoder_attention_merged(
            qm, km.contiguous(), vm.contiguous(),
            t_real if t_real is not None else x.shape[1])
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
    x = (_embed_lookup(dec, tokens)
         + dec["pos"][positions_offset: positions_offset + t])
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
    """Self- and cross-attention K/V caches.  Beams of one audio share
    the cross K/V (rows = B * beams for the self caches, B for cross).

    Float mode: k/v (L, rows, max_len, H, Dh) and cross_k/cross_v
    (L, B, S, H, Dh) in the model type; the scale fields are None.

    Flat int8 mode (the fused int8 decode kernels): k/v (L, rows, len, D)
    int8, or (L, rows, len, D/2) uint8 lane-packed int4, with f32 scales
    ks/vs (L, rows, HP, len), HP = ceil(H/8)*8 and rows >= H zero.
    Quantized cross-KV: cross_k/cross_v (L, B, S, D) int8 or (L, B, S/2, D)
    uint8 packed along S (S padded to a multiple of 16), with scales
    cks/cvs (L, B, H, S).
    """
    k: torch.Tensor
    v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    cks: Optional[torch.Tensor] = None
    cvs: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype in (torch.int8, torch.uint8)

    @property
    def flat(self) -> bool:
        """Flat (L, rows, len, D) self-KV layout (fused kernels)."""
        return self.k.dim() == 4

    @property
    def self_int4(self) -> bool:
        return self.k.dtype == torch.uint8

    @property
    def cross_quantized(self) -> bool:
        return self.cross_k.dtype in (torch.int8, torch.uint8)


def quantize_kv(x):
    """Per (row, slot, head) symmetric int8 quantization of K/V entries:
    x (B, T, H, Dh) -> (int8 codes, f32 scales (B, T, H))."""
    return quantize_kv_sym(x, levels=127)


def _quantized_cross_kv(enc_out, blk, h: int, int4: bool):
    """One layer's cross K/V, quantized in the kernels' layout: codes
    (B, S_pad, D) int8 or (B, S_pad/2, D) uint8 packed along S, scales
    (B, H, S_pad).  S pads to a multiple of 16 (int4) or 8."""
    b, s = enc_out.shape[:2]
    s_pad = (-s) % (16 if int4 else 8)
    out = []
    for w, bias in ((blk["wk_c"], None), (blk["wv_c"], blk["bv_c"])):
        kv = _split_heads(_proj(enc_out, w, bias), h)
        if s_pad:
            kv = F.pad(kv, (0, 0, 0, 0, 0, s_pad))
        codes, scales = (quantize_kv4 if int4 else quantize_kv)(kv)
        codes = codes.reshape(b, s + s_pad, -1)
        out += [pack_int4(codes) if int4 else codes,
                scales.transpose(1, 2).contiguous()]
    return out


def init_cache(params: Params, cfg: WhisperConfig, enc_out, max_len: int,
               beam_expand: int = 1, kv_int8: bool = False,
               cross_kv_int8: bool = False, cross_kv_int4: bool = False,
               flat_kv: bool = False, kv_int4: bool = False) -> DecodeCache:
    """Allocate the self-attn cache and compute the cross-attn K/V per
    layer (quantized per layer when ``cross_kv_int8``/``cross_kv_int4``,
    so only one layer's float K/V is ever live).

    ``kv_int8`` takes the flat layout of the fused kernels (``flat_kv``
    must be set: the 5-D int8 cache of the unfused int8 graph is not
    ported); ``kv_int4`` lane-packs it when the head count is even.
    """
    dec = params["decoder"]
    b = enc_out.shape[0]
    h = cfg.decoder_heads
    dh = cfg.d_model // h
    dev = enc_out.device
    if cross_kv_int8 or cross_kv_int4:
        per_layer = [_quantized_cross_kv(enc_out, blk, h, cross_kv_int4)
                     for blk in dec["blocks"]]
        ck, cks, cv, cvs = (torch.stack(t) for t in zip(*per_layer))
    else:
        ck = torch.stack([_split_heads(_proj(enc_out, blk["wk_c"]), h)
                          for blk in dec["blocks"]])
        cv = torch.stack([_split_heads(_proj(enc_out, blk["wv_c"], blk["bv_c"]), h)
                          for blk in dec["blocks"]])
        cks = cvs = None
    rows = b * beam_expand
    if kv_int8:
        if not flat_kv:
            raise NotImplementedError(
                "the 5-D int8 self-KV cache of the unfused int8 graph is not "
                "ported to ttasr_torch (ROADMAP C); the flat layout needs "
                "fused int8 weights and 64-wide heads")
        hp = ((h + 7) // 8) * 8
        d_store, kv_dtype = h * dh, torch.int8
        if kv_int4 and h % 2 == 0:
            d_store, kv_dtype = d_store // 2, torch.uint8
        kv_shape = (cfg.decoder_layers, rows, max_len, d_store)
        sc_shape = (cfg.decoder_layers, rows, hp, max_len)
        return DecodeCache(
            k=torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
            v=torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
            cross_k=ck, cross_v=cv,
            ks=torch.zeros(sc_shape, dtype=torch.float32, device=dev),
            vs=torch.zeros(sc_shape, dtype=torch.float32, device=dev),
            cks=cks, cvs=cvs)
    shape = (cfg.decoder_layers, rows, max_len, h, dh)
    zeros = lambda: torch.zeros(shape, dtype=enc_out.dtype,  # noqa: E731
                                device=dev)
    return DecodeCache(k=zeros(), v=zeros(), cross_k=ck, cross_v=cv,
                       cks=cks, cvs=cvs)


def _quant_self_attention(q, k8, ks, v8, vs, mask):
    """Attention over int8/int4 codes with per-entry scales folded into
    the scores and the probabilities (the reference's bf16 operands,
    f32 products and sums).

    q: (B, T, H, Dh); k8/v8: (B, S, H, Dh) codes; ks/vs: (B, S, H) f32.
    """
    scale = q.shape[-1] ** -0.5
    qb = (q * scale).to(torch.bfloat16).float().transpose(1, 2)  # (B,H,T,Dh)
    raw = torch.matmul(qb, k8.float().permute(0, 2, 3, 1))        # (B,H,T,S)
    scores = raw * ks.transpose(1, 2)[:, :, None, :]
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_MASK)
    probs = torch.softmax(scores, dim=-1)
    probs_scaled = (probs * vs.transpose(1, 2)[:, :, None, :]).to(
        torch.bfloat16).float()
    out = torch.matmul(probs_scaled, v8.float().transpose(1, 2))  # (B,H,T,Dh)
    return out.transpose(1, 2).to(q.dtype)


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
    x = _embed_lookup(dec, tokens) + dec["pos"][pos: pos + t_new]
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

