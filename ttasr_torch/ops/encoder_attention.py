"""Whisper encoder self-attention: the Hopper kernel and its plain version.

Port of ``ttasr/ops/encoder_attention_pallas.py::encoder_attention_merged``.
q/k/v are (B, T, D) in merged-head layout (head h at columns
64h..64h+63), q pre-scaled by dh**-0.5; keys at index >= ``t_real`` are
masked.  Rows >= ``t_real`` carry attention over the real keys (the TPU
kernel leaves them as junk; callers drop them either way).

:func:`encoder_attention_merged` launches the CUDA kernel
(``ttasr_torch/csrc/encoder_attention.cu``) for CUDA tensors and runs
:func:`encoder_attention_merged_ref` for CPU tensors.  It counts its
launches in ``encoder_attention_merged.launches``.
:func:`encoder_attention_merged_qkv` (B6) is the same attention read from
the s8 x s8 encoder's fused (B, T, 3D) qkv buffer.
:func:`encoder_self_attention` (B19) is the head-split kernel of
``encoder_attention_pallas.py::encoder_self_attention``, with its own
rounding: q/k/v (B, T, H, 64) in float32 or bf16, everything rounded to
bf16 on the way in and the output on the way out.  All three run one bf16
kernel on the card (``csrc/encoder_attention.cuh``: wgmma on a TMA ring);
B11's and B6's float32 inputs run the same kernel on 3xTF32 tiles,
after a pre-pass that splits q, K and V into tf32 hi and lo planes in
scratch (:func:`f32_scratch`), so the f32 path keeps ~2**-21 relative
error per product on the tensor cores.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops._build import count_launch

DH = 64
KEYS_F32 = 64  # the 3xTF32 kernel's key tile (csrc/encoder_attention.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def encoder_attention_merged_ref(q, k, v, t_real: int):
    """Plain PyTorch version, the math of JAX ``model._attention``: f32
    scores and softmax, probabilities cast to the input type, f32 sums."""
    b, t, d = q.shape
    h = d // DH

    def heads(x):
        return x.reshape(b, t, h, DH).transpose(1, 2)  # (B, H, T, dh)

    scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
    keep = torch.arange(t, device=q.device) < t_real
    scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), heads(v).float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, t, d)


def f32_scratch(b: int, t: int, d: int, device):
    """The 3xTF32 pre-pass's planes for float32 (B, T, D) q/k/v: q and K hi
    and lo as (B, T, D), V transposed hi and lo as (B, D, t_pad) with T
    rounded up to 64 keys."""
    t_pad = -(-t // KEYS_F32) * KEYS_F32
    return torch.empty(4 * b * t * d + 2 * b * d * t_pad, dtype=torch.float32, device=device)


def _check(q, k, v, t_real: int):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q/k/v must share one (B, T, D) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, t, d = q.shape
    if d % DH:
        raise ValueError(f"D={d} is not a multiple of the head width {DH}")
    if not 1 <= t_real <= t:
        raise ValueError(f"t_real={t_real} outside [1, T={t}]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")


def encoder_attention_merged(q, k, v, t_real: int):
    """(B, T, D) merged-head attention; see the module docstring."""
    t_real = int(t_real)
    _check(q, k, v, t_real)
    if q.device.type == "cpu":
        return encoder_attention_merged_ref(q, k, v, t_real)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, t, d = q.shape
    if b * t * d >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's int indexing")
    from ttasr_torch.ops._build import launch

    out = torch.empty_like(q)
    scratch = f32_scratch(b, t, d, q.device) if q.dtype == torch.float32 else None
    launch("ttasr_encoder_attention", q.device, q, k, v, scratch, out,
           b, t, d, t_real, _DTYPE_CODE[q.dtype])
    count_launch(encoder_attention_merged)
    return out


encoder_attention_merged.launches = 0


def encoder_attention_merged_qkv_ref(qkv, t_real: int):
    """Plain version of B6: slices q/K/V out of the fused buffer and runs
    :func:`encoder_attention_merged_ref`."""
    d = qkv.shape[-1] // 3
    return encoder_attention_merged_ref(qkv[..., :d], qkv[..., d:2 * d],
                                        qkv[..., 2 * d:], t_real)


def encoder_attention_merged_qkv(qkv, t_real: int):
    """B6, port of ``encoder_attention_pallas.py::encoder_attention_merged_qkv``:
    the merged attention reading q, K and V straight from the fused
    (B, T, 3D) qkv buffer (columns 0:D, D:2D, 2D:3D; q pre-scaled through
    the weight scales).  Returns (B, T, D) in the buffer's type.  The
    kernel is B11's, its q, K and V tensor maps laid over the one buffer
    with a row stride of 3D (float32: the 3xTF32 pre-pass reads the three
    blocks in place); the plain version runs for CPU tensors.  Counts its launches in
    ``encoder_attention_merged_qkv.launches``."""
    t_real = int(t_real)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * DH):
        raise ValueError(f"qkv must be (B, T, 3D) with D a multiple of {DH}: "
                         f"{tuple(qkv.shape)}")
    b, t, d3 = qkv.shape
    d = d3 // 3
    if not 1 <= t_real <= t:
        raise ValueError(f"t_real={t_real} outside [1, T={t}]")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.device.type == "cpu":
        return encoder_attention_merged_qkv_ref(qkv, t_real)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if b * t * d3 >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's int indexing")
    from ttasr_torch.ops._build import launch

    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    scratch = f32_scratch(b, t, d, qkv.device) if qkv.dtype == torch.float32 else None
    launch("ttasr_encoder_attention_qkv", qkv.device, qkv, scratch, out, b, t, d, t_real,
           _DTYPE_CODE[qkv.dtype])
    count_launch(encoder_attention_merged_qkv)
    return out


encoder_attention_merged_qkv.launches = 0


def encoder_self_attention_ref(q, k, v):
    """Plain version of B19, its roundings step by step: q scaled by
    dh**-0.5 in q's type, q/k/v rounded to bf16, f32 scores and softmax, the
    normalised probabilities rounded to bf16, f32 sums, the output rounded
    to bf16 and cast to q's type.  (B, T, H, dh) -> (B, T, H, dh)."""
    dh = q.shape[-1]

    def heads(x):
        return x.to(torch.bfloat16).transpose(1, 2).float()  # (B, H, T, dh)

    scores = torch.matmul(heads(q * dh ** -0.5), heads(k).transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.matmul(probs, heads(v)).to(torch.bfloat16)
    return out.transpose(1, 2).to(q.dtype)


def encoder_self_attention(q, k, v):
    """B19, port of ``encoder_attention_pallas.py::encoder_self_attention``:
    non-causal self-attention of q/k/v (B, T, H, 64) float32 or bf16, in
    q's type; see :func:`encoder_self_attention_ref` for the roundings.
    The kernel reads the contiguous (B, T, H, 64) tensors as the merged
    (B, T, 64 H) layout, so nothing is transposed or padded, and scales
    the scores by 64**-0.5 = 2**-3 instead of q (a power of two commutes
    with rounding to bf16 and with the f32 sums); float32 inputs are
    first rounded to bf16 into scratch.  The plain version runs for CPU
    tensors.  Counts its launches in
    ``encoder_self_attention.launches``."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q/k/v must share one (B, T, H, Dh) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, t, h, dh = q.shape
    if dh != DH:
        raise ValueError(f"Dh={dh}: the kernel takes heads {DH} wide")
    if t < 1:
        raise ValueError("T must be at least 1")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if q.device.type == "cpu":
        return encoder_self_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.numel() >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's int indexing")
    from ttasr_torch.ops._build import launch

    out = torch.empty_like(q)
    scratch = (torch.empty(3 * q.numel(), dtype=torch.bfloat16, device=q.device)
               if q.dtype == torch.float32 else None)
    launch("ttasr_encoder_self_attention", q.device, q, k, v, scratch, out, b, t,
           h * dh, _DTYPE_CODE[q.dtype])
    count_launch(encoder_self_attention)
    return out


encoder_self_attention.launches = 0
