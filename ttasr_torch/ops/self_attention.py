"""Fused int8/int4 self-attention decode step: the Hopper kernel and its
plain versions.

Ports of ``ttasr/ops/self_attention_pallas.py``:

- B10 :func:`self_attn_step_int8` = ``self_attn_step_int8``: each beam row
  attends its own flat cache;
- B2 :func:`self_attn_step_indirect_int8` = ``self_attn_step_indirect_int8``:
  beam row j reads cache position t from physical row ``anc[b, j, t]`` of
  its audio's K rows (the ancestry map), so beams never reorder the cache.

One step, per (audio b, beam row j, head h): quantize the new K/V entry
(±127, or ±7 lane-packed for int4; the new codes and scales are returned
for the caller to write at ``slot``), score the cached positions
``pad_len[b, j] <= t < slot`` with the bf16-rounded pre-scaled query times
the codes times the per-(head, slot) scale, merge the new entry's score
(query times the new *codes*, times the new scale) and value
(code * scale, f32) inside the softmax, and sum the bf16-rounded
scale-folded probabilities times the value codes in f32.

Shapes: qkv (B, K, 3D) f32; k8/v8 (B, K, len, D) int8 or (B, K, len, D/2)
uint8 lane-packed; ks/vs (B, K, HP, len) f32 with HP = ceil(H/8)*8 (rows
>= H unused); anc (B, K, len) int; pad_len (B, K) int; slot an int.
Returns (attn (B, K, D) f32, k_new (B, K, D or D/2), ks_new (B, K, H) f32,
v_new, vs_new).

The wrappers run the plain versions for CPU tensors and launch
``ttasr_torch/csrc/self_attention.cu`` (one template with and without
``anc``) for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops.decoder_blocks import (
    DH,
    NEG_INF,
    _bf16,
    _check_cuda,
    _dispatch,
)
from ttasr_torch.ops.int4 import pack_int4_lanes, unpack_int4_lanes
from ttasr_torch.ops.quant import quantize_kv_sym

MAX_LEN = 4096  # cache slots the kernel's shared-memory score row holds


def _step_ref(qkv, k8, ks, v8, vs, anc, pad_len, slot: int, n_heads: int,
              int4: bool):
    b, k_rows, d3 = qkv.shape
    d = d3 // 3
    h = n_heads
    lv = 7 if int4 else 127
    qkv = qkv.float()
    heads = lambda t: t.reshape(b, k_rows, h, DH)  # noqa: E731
    qb = _bf16(heads(qkv[..., :d] * DH ** -0.5))
    k_code, ks_new = quantize_kv_sym(heads(qkv[..., d:2 * d]), lv)
    v_code, vs_new = quantize_kv_sym(heads(qkv[..., 2 * d:]), lv)
    s_self = (qb * k_code.float()).sum(-1) * ks_new              # (B,K,H)

    if anc is not None:  # read position t of row j from row anc[b, j, t]
        idx = anc.long()
        k8 = torch.gather(k8, 1, idx[..., None].expand(k8.shape))
        v8 = torch.gather(v8, 1, idx[..., None].expand(v8.shape))
        ks = torch.gather(ks, 1, idx[:, :, None, :].expand(ks.shape))
        vs = torch.gather(vs, 1, idx[:, :, None, :].expand(vs.shape))
    unpack = unpack_int4_lanes if int4 else (lambda t: t)
    s_len = k8.shape[2]
    kc = unpack(k8).float().reshape(b, k_rows, s_len, h, DH)
    vc = unpack(v8).float().reshape(b, k_rows, s_len, h, DH)
    scores = torch.einsum("bjhd,bjthd->bjht", qb, kc) * ks[:, :, :h].float()
    t_ids = torch.arange(s_len, device=qkv.device)
    valid = (t_ids < slot) & (t_ids >= pad_len.to(qkv.device)[..., None])
    scores = scores.masked_fill(~valid[:, :, None, :], NEG_INF)

    m = torch.maximum(scores.amax(-1), s_self)
    e = torch.exp(scores - m[..., None])
    e_self = torch.exp(s_self - m)
    denom = e.sum(-1) + e_self
    pv = _bf16(e / denom[..., None] * vs[:, :, :h].float())
    p_self = e_self / denom
    out = (torch.einsum("bjht,bjthd->bjhd", pv, vc)
           + p_self[..., None] * (v_code.float() * vs_new[..., None]))

    def store(code):
        code = code.reshape(b, k_rows, d)
        return pack_int4_lanes(code) if int4 else code

    return (out.reshape(b, k_rows, d), store(k_code), ks_new,
            store(v_code), vs_new)


def self_attn_step_int8_ref(qkv, k8, ks, v8, vs, pad_len, slot, *,
                            n_heads: int, int4: bool = False):
    """Plain version of B10 (see the module docstring)."""
    return _step_ref(qkv, k8, ks, v8, vs, None, pad_len, int(slot), n_heads,
                     int4)


def self_attn_step_indirect_int8_ref(qkv, k8, ks, v8, vs, anc, pad_len, slot,
                                     *, n_heads: int, int4: bool = False):
    """Plain version of B2 (see the module docstring)."""
    return _step_ref(qkv, k8, ks, v8, vs, anc, pad_len, int(slot), n_heads,
                     int4)


def _launch(qkv, k8, ks, v8, vs, anc, pad_len, slot, n_heads, int4):
    b, k_rows, d3 = qkv.shape
    d = d3 // 3
    h = n_heads
    if d != h * DH or (int4 and h % 2):
        raise ValueError(f"D={d} must be 64 * H={h} (H even for int4)")
    d_store = d // 2 if int4 else d
    kv_dtype = torch.uint8 if int4 else torch.int8
    s_len = k8.shape[2]
    hp = ks.shape[2]
    if qkv.dtype != torch.float32:
        raise TypeError(f"qkv must be f32, got {qkv.dtype}")
    for name, t in (("k8", k8), ("v8", v8)):
        if t.dtype != kv_dtype or t.shape != (b, k_rows, s_len, d_store):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{kv_dtype} {(b, k_rows, s_len, d_store)}")
    for name, t in (("ks", ks), ("vs", vs)):
        if t.dtype != torch.float32 or t.shape != (b, k_rows, hp, s_len) \
                or hp < h:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
    if not 0 <= slot <= s_len or s_len > MAX_LEN:
        raise ValueError(f"slot={slot} outside [0, len={s_len}] or len > "
                         f"{MAX_LEN} (the scores live in shared memory)")
    pad = pad_len.to(device=qkv.device, dtype=torch.int32).reshape(
        b, k_rows).contiguous()
    tensors = dict(qkv=qkv, k8=k8, ks=ks, v8=v8, vs=vs, pad=pad)
    if anc is not None:
        anc = anc.to(torch.int32).contiguous()
        if anc.shape != (b, k_rows, s_len):
            raise ValueError(f"anc {tuple(anc.shape)} != {(b, k_rows, s_len)}")
        tensors["anc"] = anc
    dev = _check_cuda(**tensors)
    attn = torch.empty((b, k_rows, d), dtype=torch.float32, device=dev)
    k_new = torch.empty((b, k_rows, d_store), dtype=kv_dtype, device=dev)
    v_new = torch.empty_like(k_new)
    ks_new = torch.empty((b, k_rows, h), dtype=torch.float32, device=dev)
    vs_new = torch.empty_like(ks_new)
    from ttasr_torch.ops._build import launch

    launch("ttasr_self_attn_step", dev, qkv, k8, ks, v8, vs, anc, pad,
           attn, k_new, ks_new, v_new, vs_new,
           b, k_rows, h, s_len, hp, int(slot), int(int4))
    return attn, k_new, ks_new, v_new, vs_new


def self_attn_step_int8(qkv, k8, ks, v8, vs, pad_len, slot, *,
                        n_heads: int, int4: bool = False):
    """B10: each row attends its own cache (see the module docstring)."""
    if not _dispatch(qkv):
        return self_attn_step_int8_ref(qkv, k8, ks, v8, vs, pad_len, slot,
                                       n_heads=n_heads, int4=int4)
    out = _launch(qkv, k8, ks, v8, vs, None, pad_len, int(slot), n_heads, int4)
    self_attn_step_int8.launches += 1
    return out


def self_attn_step_indirect_int8(qkv, k8, ks, v8, vs, anc, pad_len, slot, *,
                                 n_heads: int, int4: bool = False):
    """B2: beam row j reads position t from physical row ``anc[b, j, t]``
    (see the module docstring)."""
    if not _dispatch(qkv):
        return self_attn_step_indirect_int8_ref(
            qkv, k8, ks, v8, vs, anc, pad_len, slot, n_heads=n_heads,
            int4=int4)
    out = _launch(qkv, k8, ks, v8, vs, anc, pad_len, int(slot), n_heads, int4)
    self_attn_step_indirect_int8.launches += 1
    return out


self_attn_step_int8.launches = 0
self_attn_step_indirect_int8.launches = 0
