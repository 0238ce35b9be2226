"""Standalone int8/int4 cross-attention of one decode step: the Hopper
kernel and its plain version.

Port of ``ttasr/ops/cross_attention_pallas.py::cross_attention_int8``
(B13): per audio b, beam row k <= 8 and head h,

    out = softmax(bf16(q * dh**-0.5) K^T * ks, slots >= s_real masked)
          * vs -> bf16, @ V

over the int8 (B, S, D) or int4 (B, S/2, D) uint8 cross-KV cache (packed
along S) with (B, H, S) f32 scales.  The query is scaled by dh**-0.5 in
its own dtype, as the reference does, then taken to f32; the result is f32
(B, K, H, dh).  Any head count: the Pallas kernel pairs heads into
one lane-aligned query tile, a device of the TPU's layout that the Hopper
kernel (one cluster per head and audio) does not need, so a tensor-parallel
shard's odd local count (large-v3's 5 heads on a 4-way model axis) runs
it too.

:func:`cross_attention_int8` runs :func:`cross_attention_int8_ref` for CPU
tensors and launches ``ttasr_torch/csrc/cross_attention.cu`` for CUDA
tensors, counting launches in ``cross_attention_int8.launches``; anything
else raises.  The math is B3's cross half (``cross_attention.cuh`` on the
card, :func:`ttasr_torch.ops.decoder_blocks.cross_attend_ref` here).
"""

from __future__ import annotations

import torch

from ttasr_torch.ops._build import count_launch
from ttasr_torch.ops.decoder_blocks import (
    DH,
    MAX_BEAMS,
    _check_cuda,
    _dispatch,
    cross_attend_ref,
)


def _prescaled(q):
    return (q * DH ** -0.5).float()


def cross_attention_int8_ref(q, ck, cks, cv, cvs, s_real: int):
    """q: (B, K, H, 64) f32 or bf16; ck/cv: (B, S, D) int8 or (B, S/2, D)
    uint8; cks/cvs: (B, H, S) f32.  Returns (B, K, H, 64) f32."""
    return cross_attend_ref(_prescaled(q), ck, cks, cv, cvs, s_real)


def cross_attention_int8(q, ck, cks, cv, cvs, s_real: int):
    """B13; see :func:`cross_attention_int8_ref` for the contract."""
    if not _dispatch(q):
        return cross_attention_int8_ref(q, ck, cks, cv, cvs, s_real)
    b, k, h, dh = q.shape
    d = h * dh
    packed = ck.dtype == torch.uint8
    s = cks.shape[-1]
    if dh != DH or not 1 <= k <= MAX_BEAMS:
        raise ValueError(f"q {tuple(q.shape)}: 64-wide heads and "
                         f"1..{MAX_BEAMS} rows per audio expected")
    want = (torch.uint8, s // 2) if packed else (torch.int8, s)
    for name, t in (("ck", ck), ("cv", cv)):
        if t.dtype != want[0] or t.shape != (b, want[1], d):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)} and scales "
                             f"{tuple(cks.shape)}")
    if packed and s % 2:
        raise ValueError("packed cross-KV needs an even slot count")
    if not 1 <= s_real <= s:
        raise ValueError(f"s_real={s_real} outside [1, S={s}]")
    qs = _prescaled(q).contiguous()
    dev = _check_cuda(dict(cks=(cks, b * h * s), cvs=(cvs, b * h * s)),
                      q=qs, ck=ck, cv=cv)
    out = torch.empty((b, k, h, dh), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_cross_attention_int8", dev, qs, ck, cks, cv, cvs, out,
           b, k, d, s, int(s_real), int(packed))
    count_launch(cross_attention_int8)
    return out


cross_attention_int8.launches = 0
