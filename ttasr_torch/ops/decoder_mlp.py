"""Fused int8 decoder MLP with the cross-attention out-projection: the
Hopper kernel and its plain version.

Port of ``ttasr/ops/decoder_mlp_pallas.py::mlp_with_crossout_int8`` (B4):

    x' = x + (cross @ Wo_c) * s_oc + b_oc
    y  = x' + GELU(LN2(x') @ W1 * s1 + b1) @ W2 * s2 + b2

GELU uses the Abramowitz-Stegun 7.1.26 erf polynomial the TPU kernel uses
(``decoder_mlp_pallas.py:28-48``, max erf error 1.5e-7), in both the CUDA
kernel and the plain version, so the two match each other and the JAX
kernel; the JAX reference paths outside the kernel use the exact erf.
The LN2 output and the GELU output round to bf16 before their weight
products, as on the TPU.

:func:`mlp_with_crossout_int8` runs the plain version for CPU tensors and
launches ``ttasr_torch/csrc/decoder_mlp.cu`` for CUDA tensors, counting
launches in ``mlp_with_crossout_int8.launches``; on the card the vectors
must be f32, as for the kernels of :mod:`ttasr_torch.ops.decoder_blocks`.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops.decoder_blocks import (
    _bf16,
    _check_cuda,
    _dispatch,
    _ln_f32,
    _wmul,
)

_AS = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_AS_P = 0.3275911


def erf_as(z):
    """Abramowitz-Stegun 7.1.26 erf, f32."""
    a1, a2, a3, a4, a5 = _AS
    s = torch.sign(z)
    z = z.abs()
    t = 1.0 / (1.0 + _AS_P * z)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-z * z))


def gelu_as(h):
    return 0.5 * h * (1.0 + erf_as(h * 0.7071067811865476))


def mlp_with_crossout_int8_ref(x, cross, woc_q, woc_s, boc, ln_s, ln_b,
                               w1q, w1s, b1, w2q, w2s, b2):
    """x, cross: (R, D).  Weights int8 with (1, N) f32 column scales.
    Returns (R, D) f32."""
    xm = x.float() + _wmul(_bf16(cross.float()), woc_q, woc_s) + boc.float()
    ln = _bf16(_ln_f32(xm, ln_s, ln_b))
    hid = _bf16(gelu_as(_wmul(ln, w1q, w1s) + b1.float()))
    return xm + b2.float() + _wmul(hid, w2q, w2s)


def mlp_with_crossout_int8(x, cross, woc_q, woc_s, boc, ln_s, ln_b,
                           w1q, w1s, b1, w2q, w2s, b2):
    """B4; see :func:`mlp_with_crossout_int8_ref` for the contract."""
    if not _dispatch(x):
        return mlp_with_crossout_int8_ref(x, cross, woc_q, woc_s, boc, ln_s,
                                          ln_b, w1q, w1s, b1, w2q, w2s, b2)
    r, d = x.shape
    f = w1q.shape[1]
    if x.dtype != torch.float32 or cross.dtype != torch.float32 \
            or cross.shape != x.shape:
        raise TypeError("x and cross must be f32 (R, D)")
    if (woc_q.shape != (d, d) or w1q.shape != (d, f) or w2q.shape != (f, d)
            or {woc_q.dtype, w1q.dtype, w2q.dtype} != {torch.int8}):
        raise ValueError("Wo_c (D, D), W1 (D, F), W2 (F, D) must be int8")
    vec = dict(woc_s=(woc_s, d), boc=(boc, d), ln_s=(ln_s, d), ln_b=(ln_b, d),
               w1s=(w1s, f), b1=(b1, f), w2s=(w2s, d), b2=(b2, d))
    dev = _check_cuda(vec, x=x, cross=cross, woc_q=woc_q, w1q=w1q, w2q=w2q)
    x_mid = torch.empty((r, d), dtype=torch.float32, device=dev)
    hid = torch.empty((r, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((r, d), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    launch("ttasr_mlp_crossout_int8", dev, x, cross, woc_q, woc_s, boc, ln_s,
           ln_b, w1q, w1s, b1, w2q, w2s, b2, x_mid, hid, out, r, d, f)
    mlp_with_crossout_int8.launches += 1
    return out


mlp_with_crossout_int8.launches = 0
