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
"""

from __future__ import annotations

import torch

DH = 64
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
    launch("ttasr_encoder_attention", q.device, q, k, v, out,
           b, t, d, t_real, _DTYPE_CODE[q.dtype])
    encoder_attention_merged.launches += 1
    return out


encoder_attention_merged.launches = 0
