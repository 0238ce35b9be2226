"""Fused int8 decoder-block kernels around the attentions: the Hopper
kernels and their plain versions.

Ports of ``ttasr/ops/decoder_blocks_pallas.py``:

- B1 :func:`qkv_int8_fused` = ``qkv_int8_fused``: LN1(x) @ W_qkv * s + b;
- B12 :func:`attnout_ln_q_fused` = ``attnout_ln_q_fused``: the
  self-attention out-projection and residual, LNc and the cross query
  (not pre-scaled), for the decode branches B3 does not take;
- B3 :func:`attnout_ln_q_cross_int8` = ``attnout_ln_q_cross_int8``: B12
  with the pre-scaled query, then the per-head cross-attention over the
  int8 or int4 cross-KV cache (:func:`cross_attend_ref`, shared with B13
  in :mod:`ttasr_torch.ops.cross_attention`);
- B15 :func:`matmul_int8_partial` = ``matmul_int8_partial``: bf16(x) @ W *
  s with no bias, a tensor-parallel shard's partial sum of the row-split
  wo or wo_c;
- B16 :func:`ln_q_cross_int8` = ``ln_q_cross_int8``: B3 without its wo
  half, the cross query and cross-attention of a row-parallel shard.

Under tensor parallelism a shard carries its local heads' columns of the
cross query and cross-KV, so the cross width DC = 64 * local heads is
narrower than the residual width D (B3, B12 and B16 take DC from the
weight).

Each wrapper runs its plain PyTorch version (``*_ref``) for CPU tensors and
launches the CUDA kernel (``ttasr_torch/csrc/decoder_blocks.cu``) for CUDA
tensors, counting launches in ``<wrapper>.launches``; anything else raises.
On the card the LayerNorm parameters, biases and scales must already be f32
(the decode converts them once per decode, not per call).
The plain versions round to bf16 where the TPU kernels do (the LN output
before each weight product, the pre-scaled queries, the scale-folded
probabilities); int8 and int4 codes are exact in bf16 and f32, so the
products are taken in f32.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops.int4 import unpack_int4

NEG_INF = torch.finfo(torch.float32).min
DH = 64
MAX_BEAMS = 8  # beam rows per audio the fused cross kernel takes


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _ln_f32(x, scale, bias, eps=1e-5):
    """The kernels' LayerNorm: f32 mean and biased variance, rsqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _wmul(a_bf16, wq, ws):
    """(a @ W) * s: bf16 activations times int8 codes, f32 sums, column
    scales."""
    return torch.matmul(a_bf16, wq.float()) * ws.reshape(-1).float()


# ---------------------------------------------------------------------------
# B1: LN1 + fused qkv projection
# ---------------------------------------------------------------------------

def qkv_int8_fused_ref(x, ln_s, ln_b, wq, ws, b):
    """x: (R, D); wq: (D, M) int8; ws: (1, M) f32; b: (M,).
    Returns LN(x) @ W * s + b as (R, M) f32."""
    ln = _bf16(_ln_f32(x.float(), ln_s, ln_b))
    return _wmul(ln, wq, ws) + b.float()


def _check_cuda(vectors=None, **tensors):
    """Every operand lies contiguous on one card, and every entry of
    ``vectors`` (name -> (tensor, length)) is f32 of that length; returns
    the device."""
    vectors = vectors or {}
    dev = None
    items = list(tensors.items()) + [(n, t) for n, (t, _) in vectors.items()]
    for name, t in items:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not on the card")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} lies on another device than the rest")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, (t, n) in vectors.items():
        if t.dtype != torch.float32 or t.numel() != n:
            raise TypeError(f"{name} must be f32 with {n} elements, got "
                            f"{t.dtype} {tuple(t.shape)}")
    return dev


def _dispatch(x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def qkv_int8_fused(x, ln_s, ln_b, wq, ws, b):
    """B1; see :func:`qkv_int8_fused_ref` for the contract."""
    if not _dispatch(x):
        return qkv_int8_fused_ref(x, ln_s, ln_b, wq, ws, b)
    r, d = x.shape
    m = wq.shape[1]
    if x.dtype != torch.float32 or wq.dtype != torch.int8 or wq.shape[0] != d:
        raise TypeError(f"qkv_int8_fused takes f32 x (R, D) and int8 W (D, M): "
                        f"{x.dtype} {tuple(x.shape)}, {wq.dtype} {tuple(wq.shape)}")
    dev = _check_cuda(dict(ln_s=(ln_s, d), ln_b=(ln_b, d), ws=(ws, m),
                           b=(b, m)), x=x, wq=wq)
    out = torch.empty((r, m), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_qkv_int8", dev, x, ln_s, ln_b, wq, ws, b, out, r, d, m)
    qkv_int8_fused.launches += 1
    return out


qkv_int8_fused.launches = 0


# ---------------------------------------------------------------------------
# B12: attention out-projection + LNc + cross-q
# ---------------------------------------------------------------------------

def attnout_ln_q_fused_ref(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                           wqc_q, wqc_s, bqc):
    """x, attn: (R, D); wo_q (D, D) and wqc_q (D, DC) int8 with (1, N) f32
    scales.  Returns (x' = x + (attn @ Wo) * s_o + b_o  (R, D) f32,
    qc = LNc(x') @ Wq_c * s_qc + b_qc  (R, DC) f32); qc is not scaled by
    dh**-0.5 (its consumer does that)."""
    a = _bf16(attn.float())
    xo = x.float() + _wmul(a, wo_q, wo_s) + bo.float()
    ln = _bf16(_ln_f32(xo, lnc_s, lnc_b))
    return xo, _wmul(ln, wqc_q, wqc_s) + bqc.float()


def attnout_ln_q_fused(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                       wqc_q, wqc_s, bqc):
    """B12; see :func:`attnout_ln_q_fused_ref` for the contract."""
    if not _dispatch(x):
        return attnout_ln_q_fused_ref(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                                      wqc_q, wqc_s, bqc)
    r, d = x.shape
    dc = wqc_q.shape[-1]
    if (x.dtype != torch.float32 or attn.dtype != torch.float32
            or attn.shape != x.shape):
        raise TypeError("x and attn must be f32 (R, D)")
    if wo_q.shape != (d, d) or wqc_q.shape != (d, dc) \
            or {wo_q.dtype, wqc_q.dtype} != {torch.int8}:
        raise TypeError(f"wo must be int8 (D, D) and wq_c int8 (D, DC): "
                        f"{wo_q.dtype} {tuple(wo_q.shape)}, {wqc_q.dtype} "
                        f"{tuple(wqc_q.shape)}")
    if d % 32 or dc % 32:
        raise ValueError(f"D={d} and DC={dc} must be multiples of 32")
    vec = dict(wo_s=(wo_s, d), bo=(bo, d), lnc_s=(lnc_s, d), lnc_b=(lnc_b, d),
               wqc_s=(wqc_s, dc), bqc=(bqc, dc))
    dev = _check_cuda(vec, x=x, attn=attn, wo_q=wo_q, wqc_q=wqc_q)
    xo = torch.empty((r, d), dtype=torch.float32, device=dev)
    qc = torch.empty((r, dc), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_attnout_ln_q", dev, x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
           wqc_q, wqc_s, bqc, xo, qc, r, d, dc)
    attnout_ln_q_fused.launches += 1
    return xo, qc


attnout_ln_q_fused.launches = 0


# ---------------------------------------------------------------------------
# B3: B12 with the pre-scaled query + int8/int4 cross-attention
# ---------------------------------------------------------------------------

def _cross_codes(ck):
    """Stored cross-KV (B, S, D) int8 or (B, S/2, D) uint8 packed along S
    -> (B, S, D) f32 codes in slot order."""
    return (unpack_int4(ck) if ck.dtype == torch.uint8 else ck).float()


def cross_attend_ref(q, ck, cks, cv, cvs, s_real: int):
    """Per-head cross-attention of pre-scaled queries over the quantized
    cross-KV, as the TPU kernels compute it:

        softmax(bf16(q) K^T * ks, slots >= s_real masked) * vs -> bf16, @ V

    q: (B, K, H, dh) f32 (already times dh**-0.5).  ck/cv: (B, S, D) int8
    or (B, S/2, D) uint8 (int4 packed along S); cks/cvs: (B, H, S) f32.
    Returns (B, K, H, dh) f32."""
    b, k, h, dh = q.shape
    qb = _bf16(q.float()).transpose(1, 2)                       # (B,H,K,dh)
    kc = _cross_codes(ck)
    s = kc.shape[1]
    kc = kc.reshape(b, s, h, dh).permute(0, 2, 3, 1)            # (B,H,dh,S)
    vc = _cross_codes(cv).reshape(b, s, h, dh).transpose(1, 2)  # (B,H,S,dh)
    scores = torch.matmul(qb, kc) * cks.float()[:, :, None, :]  # (B,H,K,S)
    valid = torch.arange(s, device=q.device) < s_real
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = _bf16(probs * cvs.float()[:, :, None, :])
    return torch.matmul(pv, vc).transpose(1, 2)                 # (B,K,H,dh)


def attnout_ln_q_cross_int8_ref(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                                wqc_q, wqc_s, bqc, ck, cks, cv, cvs,
                                s_real: int):
    """Per audio b (beam rows grouped, K <= 8):

        x'  = x + (attn @ Wo) * s_o + b_o
        qc  = (LNc(x') @ Wq_c * s_qc + b_qc) * dh**-0.5
        out = softmax(bf16(qc) K^T * ks, slots >= s_real masked) * vs @ V

    x, attn: (B, K, D) f32.  wqc_q: (D, DC) int8, DC = 64 * H.  ck/cv:
    (B, S, DC) int8 or (B, S/2, DC) uint8 (int4 packed along S); cks/cvs:
    (B, H, S) f32.  Returns (x' (B, K, D) f32, cross (B, K, DC) f32
    merged-head).
    """
    b, k, d = x.shape
    xo, qc = attnout_ln_q_fused_ref(x.reshape(b * k, d), attn.reshape(b * k, d),
                                    wo_q, wo_s, bo, lnc_s, lnc_b, wqc_q, wqc_s,
                                    bqc)
    return xo.reshape(b, k, d), _cross_of(qc * DH ** -0.5, b, k, ck, cks, cv,
                                          cvs, s_real)


def _cross_of(qc, b, k, ck, cks, cv, cvs, s_real: int):
    """(B*K, DC) pre-scaled queries -> (B, K, DC) cross-attention output."""
    h = cks.shape[1]
    out = cross_attend_ref(qc.reshape(b, k, h, DH), ck, cks, cv, cvs, s_real)
    return out.reshape(b, k, h * DH)


def _check_cross(b, k, dc, ck, cks, cv, s_real):
    """The shapes B3 and B16 take: K <= 8 rows per audio, DC = 64 * H,
    and a cross-KV cache that matches its scales; returns (S, packed)."""
    h = cks.shape[1]
    packed = ck.dtype == torch.uint8
    s = cks.shape[2]
    if not 1 <= k <= MAX_BEAMS or dc != h * DH:
        raise ValueError(f"K={k} rows per audio (1..{MAX_BEAMS}) and DC={dc} = "
                         f"64 * H={h} expected")
    want = (torch.uint8, s // 2) if packed else (torch.int8, s)
    for name, t in (("ck", ck), ("cv", cv)):
        if (t.dtype, t.shape[1]) != want or t.shape != (b, want[1], dc):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does not "
                             f"match scales {tuple(cks.shape)}")
    if packed and s % 2:
        raise ValueError("packed cross-KV needs an even slot count")
    if not 1 <= s_real <= s:
        raise ValueError(f"s_real={s_real} outside [1, S={s}]")
    return s, packed


def attnout_ln_q_cross_int8(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                            wqc_q, wqc_s, bqc, ck, cks, cv, cvs, s_real: int):
    """B3; see :func:`attnout_ln_q_cross_int8_ref` for the contract."""
    if not _dispatch(x):
        return attnout_ln_q_cross_int8_ref(
            x, attn, wo_q, wo_s, bo, lnc_s, lnc_b, wqc_q, wqc_s, bqc,
            ck, cks, cv, cvs, s_real)
    b, k, d = x.shape
    h = cks.shape[1]
    dc = wqc_q.shape[-1]
    if (x.dtype != torch.float32 or attn.shape != x.shape
            or attn.dtype != torch.float32):
        raise TypeError("x and attn must be f32 (B, K, D)")
    s, packed = _check_cross(b, k, dc, ck, cks, cv, s_real)
    if wo_q.shape != (d, d) or wqc_q.shape != (d, dc) \
            or {wo_q.dtype, wqc_q.dtype} != {torch.int8}:
        raise TypeError("wo must be int8 (D, D) and wq_c int8 (D, DC)")
    vec = dict(wo_s=(wo_s, d), bo=(bo, d), lnc_s=(lnc_s, d), lnc_b=(lnc_b, d),
               wqc_s=(wqc_s, dc), bqc=(bqc, dc), cks=(cks, b * h * s),
               cvs=(cvs, b * h * s))
    dev = _check_cuda(vec, x=x, attn=attn, wo_q=wo_q, wqc_q=wqc_q, ck=ck, cv=cv)
    xo = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    qc = torch.empty((b, k, dc), dtype=torch.float32, device=dev)
    cross = torch.empty((b, k, dc), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_attnout_cross_int8", dev, x, attn, wo_q, wo_s, bo, lnc_s,
           lnc_b, wqc_q, wqc_s, bqc, ck, cks, cv, cvs, xo, qc, cross,
           b, k, d, dc, s, int(s_real), int(packed))
    attnout_ln_q_cross_int8.launches += 1
    return xo, cross


attnout_ln_q_cross_int8.launches = 0


# ---------------------------------------------------------------------------
# B15: the partial sum of a row-split projection (tensor parallelism)
# ---------------------------------------------------------------------------

def matmul_int8_partial_ref(x, wq, ws):
    """x: (R, DL) f32, a shard's slice of the input; wq: (DL, M) int8, the
    shard's row slice of the weight; ws: (1, M) f32, the full column scales
    (the scale is linear in the partial sum, so each shard applies it).
    Returns bf16(x) @ W * s as (R, M) f32, with no bias: the shards sum the
    results and the caller adds the bias once."""
    return _wmul(_bf16(x.float()), wq, ws)


def matmul_int8_partial(x, wq, ws):
    """B15; see :func:`matmul_int8_partial_ref` for the contract."""
    if not _dispatch(x):
        return matmul_int8_partial_ref(x, wq, ws)
    r, dl = x.shape
    m = wq.shape[1]
    if x.dtype != torch.float32 or wq.dtype != torch.int8 or wq.shape[0] != dl:
        raise TypeError(f"matmul_int8_partial takes f32 x (R, DL) and int8 W "
                        f"(DL, M): {x.dtype} {tuple(x.shape)}, {wq.dtype} "
                        f"{tuple(wq.shape)}")
    if m % 32:
        raise ValueError(f"M={m} must be a multiple of 32")
    dev = _check_cuda(dict(ws=(ws, m)), x=x, wq=wq)
    out = torch.empty((r, m), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_matmul_int8_partial", dev, x, wq, ws, out, r, dl, m)
    matmul_int8_partial.launches += 1
    return out


matmul_int8_partial.launches = 0


# ---------------------------------------------------------------------------
# B16: LNc + the shard's cross query + int8/int4 cross-attention
# ---------------------------------------------------------------------------

def ln_q_cross_int8_ref(xo, lnc_s, lnc_b, wqc_q, wqc_s, bqc, ck, cks, cv, cvs,
                        s_real: int):
    """Per audio b (beam rows grouped, K <= 8):

        qc  = (LNc(xo) @ Wq_c * s_qc + b_qc) * dh**-0.5
        out = softmax(bf16(qc) K^T * ks, slots >= s_real masked) * vs @ V

    xo: (B, K, D) f32, the residual stream after the row-parallel wo sum
    (residual and bias added).  wqc_q: (D, DC) int8 with (1, DC) f32
    scales and (DC,) bias, the shard's column slice (DC = 64 * H local
    heads); ck/cv/cks/cvs: the shard's cross-KV in B3's formats.  Returns
    cross (B, K, DC) f32 merged-head."""
    b, k, d = xo.shape
    ln = _bf16(_ln_f32(xo.reshape(b * k, d).float(), lnc_s, lnc_b))
    qc = (_wmul(ln, wqc_q, wqc_s) + bqc.float()) * DH ** -0.5
    return _cross_of(qc, b, k, ck, cks, cv, cvs, s_real)


def ln_q_cross_int8(xo, lnc_s, lnc_b, wqc_q, wqc_s, bqc, ck, cks, cv, cvs,
                    s_real: int):
    """B16; see :func:`ln_q_cross_int8_ref` for the contract."""
    if not _dispatch(xo):
        return ln_q_cross_int8_ref(xo, lnc_s, lnc_b, wqc_q, wqc_s, bqc,
                                   ck, cks, cv, cvs, s_real)
    b, k, d = xo.shape
    h = cks.shape[1]
    dc = wqc_q.shape[-1]
    if xo.dtype != torch.float32:
        raise TypeError("xo must be f32 (B, K, D)")
    s, packed = _check_cross(b, k, dc, ck, cks, cv, s_real)
    if wqc_q.shape != (d, dc) or wqc_q.dtype != torch.int8 or d % 32:
        raise TypeError(f"wq_c must be int8 (D, DC) with D a multiple of 32: "
                        f"{wqc_q.dtype} {tuple(wqc_q.shape)}, D={d}")
    vec = dict(lnc_s=(lnc_s, d), lnc_b=(lnc_b, d), wqc_s=(wqc_s, dc),
               bqc=(bqc, dc), cks=(cks, b * h * s), cvs=(cvs, b * h * s))
    dev = _check_cuda(vec, xo=xo, wqc_q=wqc_q, ck=ck, cv=cv)
    qc = torch.empty((b, k, dc), dtype=torch.float32, device=dev)
    cross = torch.empty((b, k, dc), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_ln_q_cross_int8", dev, xo, lnc_s, lnc_b, wqc_q, wqc_s, bqc,
           ck, cks, cv, cvs, qc, cross, b, k, d, dc, s, int(s_real),
           int(packed))
    ln_q_cross_int8.launches += 1
    return cross


ln_q_cross_int8.launches = 0
