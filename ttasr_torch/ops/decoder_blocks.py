"""Fused int8 decoder-block kernels around the attentions: the Hopper
kernels and their plain versions.

Ports of ``ttasr/ops/decoder_blocks_pallas.py``:

- B1 :func:`qkv_int8_fused` = ``qkv_int8_fused``: LN1(x) @ W_qkv * s + b;
- B3 :func:`attnout_ln_q_cross_int8` = ``attnout_ln_q_cross_int8``: the
  self-attention out-projection and residual, LNc, the cross query and the
  per-head cross-attention over the int8 or int4 cross-KV cache.

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
# B3: attention out-projection + LNc + cross-q + int8/int4 cross-attention
# ---------------------------------------------------------------------------

def _cross_codes(ck):
    """Stored cross-KV (B, S, D) int8 or (B, S/2, D) uint8 packed along S
    -> (B, S, D) f32 codes in slot order."""
    return (unpack_int4(ck) if ck.dtype == torch.uint8 else ck).float()


def attnout_ln_q_cross_int8_ref(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                                wqc_q, wqc_s, bqc, ck, cks, cv, cvs,
                                s_real: int):
    """Per audio b (beam rows grouped, K <= 8):

        x'  = x + (attn @ Wo) * s_o + b_o
        qc  = (LNc(x') @ Wq_c * s_qc + b_qc) * dh**-0.5
        out = softmax(bf16(qc) K^T * ks, slots >= s_real masked) * vs @ V

    x, attn: (B, K, D) f32.  ck/cv: (B, S, D) int8 or (B, S/2, D) uint8
    (int4 packed along S); cks/cvs: (B, H, S) f32.  Returns (x' (B, K, D)
    f32, cross (B, K, D) f32 merged-head).
    """
    b, k, d = x.shape
    h = cks.shape[1]
    a = _bf16(attn.float().reshape(b * k, d))
    xo = x.float().reshape(b * k, d) + _wmul(a, wo_q, wo_s) + bo.float()
    ln = _bf16(_ln_f32(xo, lnc_s, lnc_b))
    qc = (_wmul(ln, wqc_q, wqc_s) + bqc.float()) * DH ** -0.5
    q = _bf16(qc).reshape(b, k, h, DH).transpose(1, 2)          # (B,H,K,dh)
    kc = _cross_codes(ck)
    s = kc.shape[1]
    kc = kc.reshape(b, s, h, DH).permute(0, 2, 3, 1)            # (B,H,dh,S)
    vc = _cross_codes(cv).reshape(b, s, h, DH).transpose(1, 2)  # (B,H,S,dh)
    scores = torch.matmul(q, kc) * cks.float()[:, :, None, :]   # (B,H,K,S)
    valid = torch.arange(s, device=x.device) < s_real
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = _bf16(probs * cvs.float()[:, :, None, :])
    out = torch.matmul(pv, vc)                                  # (B,H,K,dh)
    return xo.reshape(b, k, d), out.transpose(1, 2).reshape(b, k, d)


def attnout_ln_q_cross_int8(x, attn, wo_q, wo_s, bo, lnc_s, lnc_b,
                            wqc_q, wqc_s, bqc, ck, cks, cv, cvs, s_real: int):
    """B3; see :func:`attnout_ln_q_cross_int8_ref` for the contract."""
    if not _dispatch(x):
        return attnout_ln_q_cross_int8_ref(
            x, attn, wo_q, wo_s, bo, lnc_s, lnc_b, wqc_q, wqc_s, bqc,
            ck, cks, cv, cvs, s_real)
    b, k, d = x.shape
    h = cks.shape[1]
    packed = ck.dtype == torch.uint8
    s = cks.shape[2]
    if (x.dtype != torch.float32 or attn.shape != x.shape
            or attn.dtype != torch.float32):
        raise TypeError("x and attn must be f32 (B, K, D)")
    if not 1 <= k <= MAX_BEAMS or d != h * DH:
        raise ValueError(f"K={k} rows per audio (1..{MAX_BEAMS}) and D={d} = "
                         f"64 * H={h} expected")
    want = (torch.uint8, s // 2) if packed else (torch.int8, s)
    for name, t in (("ck", ck), ("cv", cv)):
        if (t.dtype, t.shape[1]) != want or t.shape != (b, want[1], d):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does not "
                             f"match scales {tuple(cks.shape)}")
    if packed and s % 2:
        raise ValueError("packed cross-KV needs an even slot count")
    if not 1 <= s_real <= s:
        raise ValueError(f"s_real={s_real} outside [1, S={s}]")
    if wo_q.shape != (d, d) or wqc_q.shape != (d, d) \
            or {wo_q.dtype, wqc_q.dtype} != {torch.int8}:
        raise TypeError("wo and wq_c must be int8 (D, D)")
    vec = dict(wo_s=(wo_s, d), bo=(bo, d), lnc_s=(lnc_s, d), lnc_b=(lnc_b, d),
               wqc_s=(wqc_s, d), bqc=(bqc, d), cks=(cks, b * h * s),
               cvs=(cvs, b * h * s))
    dev = _check_cuda(vec, x=x, attn=attn, wo_q=wo_q, wqc_q=wqc_q, ck=ck, cv=cv)
    xo = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    qc = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    cross = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_attnout_cross_int8", dev, x, attn, wo_q, wo_s, bo, lnc_s,
           lnc_b, wqc_q, wqc_s, bqc, ck, cks, cv, cvs, xo, qc, cross,
           b, k, d, s, int(s_real), int(packed))
    attnout_ln_q_cross_int8.launches += 1
    return xo, cross


attnout_ln_q_cross_int8.launches = 0
