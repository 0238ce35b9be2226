"""Row producer + dynamic int8 quantize of the s8 x s8 encoder: the Hopper
kernels and their plain versions.

Ports of ``ttasr/ops/encoder_fused_pallas.py``:

- B5 :func:`ln_quant`: LayerNorm -> int8 codes + row scales;
- B7 :func:`quant_only`: int8 codes + row scales;
- B8 :func:`add_ln_quant`: residual add -> (bf16 residual, codes and scales
  of the LayerNorm of the f32 sum);
- B9 :func:`gelu_quant`: exact GELU (A&S erf polynomial) -> codes + scales;

and four entries that read the s8 x s8 GEMM's int32 accumulators and apply
its epilogue (``ops.quant.act8_epilogue``: ``acc * xs * w_scale + b``,
rounded to bf16) first, so the encoder's qkv, wo, W1 and W2 outputs never
pass through an eager torch epilogue:

- B9 :func:`gelu_quant_acc`: :func:`gelu_quant` of W1's output;
- B5 :func:`ln_quant_acc`: the residual add of W2's output, ``x' = x + y``
  in bf16, then :func:`ln_quant` of ``x'``; returns ``x'`` too;
- B8 :func:`add_ln_quant_acc`: :func:`add_ln_quant` of x and wo's output
  (the LayerNorm of the f32 sum, not of the rounded residual);
- :func:`qkv_epilogue_acc`: the fused qkv GEMM's bf16 output, the buffer
  B6 reads, with the dh**-0.5 query scale folded into the q third of the
  weight scales and bias (the epilogue of an XLA dot in the JAX package,
  ``ttasr/ops/quant.py:156``, not a Pallas kernel).

Each producer runs in f32 and its f32 output is quantized directly (the
fused contract): ``scale = max(absmax, 1e-8) * f32(1/127)``, ``codes =
round(v / scale)`` half to even.  The multiply by the reciprocal is what the
JAX kernels compute (XLA rewrites the division by the constant inside the
kernel, interpret mode included).  Inputs are (B, T, D) bf16; scales come
back (B, T, 1) f32, codes (B, T, D) int8.

All eight run one kernel template.  Each wrapper runs its plain PyTorch
version (``*_ref``) for CPU tensors and
launches the CUDA kernel (``ttasr_torch/csrc/encoder_fused.cu``) for CUDA
tensors, counting launches in ``<wrapper>.launches``; anything else raises.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops._build import count_launch
from ttasr_torch.ops.decoder_blocks import _dispatch
from ttasr_torch.ops.decoder_mlp import gelu_as
from ttasr_torch.ops.quant import act8_epilogue, quantize_rows

LN_EPS = 1e-5


def _ln_rows(x32, scale, bias, eps=LN_EPS):
    """The kernels' LayerNorm of f32 rows: two-pass mean and biased
    variance (sums times f32(1/D)), 1/sqrt, then ``n * scale + bias``."""
    inv_d = 1.0 / x32.shape[-1]
    mean = x32.sum(dim=-1, keepdim=True) * inv_d
    dev = x32 - mean
    var = (dev * dev).sum(dim=-1, keepdim=True) * inv_d
    return dev * (1.0 / torch.sqrt(var + eps)) * scale.float() + bias.float()


def ln_quant_ref(x, scale, bias):
    return quantize_rows(_ln_rows(x.float(), scale, bias))


def add_ln_quant_ref(x, y, scale, bias):
    x2 = x.float() + y.float()
    q, s = quantize_rows(_ln_rows(x2, scale, bias))
    return x2.to(x.dtype), q, s


def gelu_quant_ref(h):
    return quantize_rows(gelu_as(h.float()))


def quant_only_ref(x):
    return quantize_rows(x.float())


def gelu_quant_acc_ref(acc, xs, w_scale, b):
    return gelu_quant_ref(act8_epilogue(acc, xs, w_scale, b, torch.bfloat16))


def ln_quant_acc_ref(x, acc, xs, w_scale, b, scale, bias):
    x2 = x + act8_epilogue(acc, xs, w_scale, b, torch.bfloat16)
    return (x2, *ln_quant_ref(x2, scale, bias))


def add_ln_quant_acc_ref(x, acc, xs, w_scale, b, scale, bias):
    return add_ln_quant_ref(x, act8_epilogue(acc, xs, w_scale, b, x.dtype), scale, bias)


def qkv_epilogue_acc_ref(acc, xs, w_scale, b, q_scale, out_dtype=torch.bfloat16):
    n = acc.shape[-1]
    colscale = torch.ones(n, dtype=torch.float32, device=acc.device)
    colscale[: n // 3] = q_scale
    return act8_epilogue(acc, xs, w_scale * colscale,
                         None if b is None else b * colscale, out_dtype)


def _rows(x, name, dtype=torch.bfloat16):
    """Checks a (..., D) operand of ``dtype`` for the kernel; returns
    (rows, D)."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on the card, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    d = x.shape[-1]
    if d % 8 or d > 8192:
        raise ValueError(f"{name}: width {d} must be a multiple of 8, at most 8192")
    return x.numel() // d, d


def _outputs(x):
    rows = x.numel() // x.shape[-1]
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(tuple(x.shape[:-1]) + (1,), dtype=torch.float32,
                         device=x.device)
    return rows, codes, scales


def _aligned(v):
    """``v`` contiguous and 16-byte aligned (the kernels read 16 bytes at
    a time)."""
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _vec(v, d, name):
    if v.numel() != d or v.device.type != "cuda":
        raise ValueError(f"{name} must hold {d} values on the card")
    return _aligned(v.float())


_VEC_BITS = {"b": 1, "scale": 2, "bias": 4}  # the kernels' vec_bf16 mask


def _vecs(d, **named):
    """Column vectors (a bias ``b``, a LayerNorm ``scale`` and ``bias``) as
    the kernel reads them: bf16 as they are, anything else as f32; returns
    them in order and the mask of those that are bf16."""
    out, mask = [], 0
    for name, v in named.items():
        if v is not None:
            if v.dtype == torch.bfloat16:
                mask |= _VEC_BITS[name]
                v = _aligned(v)
            else:
                v = _vec(v, d, name)
            if v.numel() != d or v.device.type != "cuda":
                raise ValueError(f"{name} must hold {d} values on the card")
        out.append(v)
    return (*out, mask)


def _acc_rows(acc, xs, w_scale):
    """Checks the int32 accumulators (..., W) and their epilogue's row and
    column scales for the kernel; returns (rows, W, xs, w_scale) as the
    kernel reads them."""
    rows, w = _rows(acc, "acc", torch.int32)
    if xs.numel() != rows or xs.dtype != torch.float32 or xs.device != acc.device:
        raise ValueError(f"xs must hold {rows} f32 row scales on {acc.device}")
    return rows, w, xs.contiguous(), _vec(w_scale, w, "w_scale")


def ln_quant(x, scale, bias):
    """B5: LayerNorm(x) -> (int8 codes, f32 row scales (..., 1))."""
    if not _dispatch(x):
        return ln_quant_ref(x, scale, bias)
    _, d = _rows(x, "x")
    rows, codes, scales = _outputs(x)
    from ttasr_torch.ops._build import launch

    s, b, mask = _vecs(d, scale=scale, bias=bias)
    launch("ttasr_ln_quant", x.device, x, s, b, codes, scales, rows, d, mask)
    count_launch(ln_quant)
    return codes, scales


def add_ln_quant(x, y, scale, bias):
    """B8: x + y -> (bf16 residual, codes and row scales of LN2 of the f32
    sum)."""
    if not _dispatch(x):
        return add_ln_quant_ref(x, y, scale, bias)
    _, d = _rows(x, "x")
    _rows(y, "y")
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must match")
    rows, codes, scales = _outputs(x)
    resid = torch.empty_like(x)
    from ttasr_torch.ops._build import launch

    s, b, mask = _vecs(d, scale=scale, bias=bias)
    launch("ttasr_add_ln_quant", x.device, x, y, s, b, resid, codes, scales, rows,
           d, mask)
    count_launch(add_ln_quant)
    return resid, codes, scales


def gelu_quant(h):
    """B9: exact GELU (A&S erf) of the MLP hidden -> (codes, row scales)."""
    if not _dispatch(h):
        return gelu_quant_ref(h)
    _, f = _rows(h, "h")
    rows, codes, scales = _outputs(h)
    from ttasr_torch.ops._build import launch

    launch("ttasr_gelu_quant", h.device, h, codes, scales, rows, f)
    count_launch(gelu_quant)
    return codes, scales


def quant_only(x):
    """B7: x -> (codes, row scales)."""
    if not _dispatch(x):
        return quant_only_ref(x)
    _, d = _rows(x, "x")
    rows, codes, scales = _outputs(x)
    from ttasr_torch.ops._build import launch

    launch("ttasr_quant_only", x.device, x, codes, scales, rows, d)
    count_launch(quant_only)
    return codes, scales


def gelu_quant_acc(acc, xs, w_scale, b):
    """B9 from W1's int32 accumulators acc (..., F), row scales xs (..., 1),
    column scales w_scale (1, F) and bias b (F,) or None: codes and row
    scales of GELU(bf16(acc * xs * w_scale + b))."""
    if not _dispatch(acc):
        return gelu_quant_acc_ref(acc, xs, w_scale, b)
    rows, f, xs, ws = _acc_rows(acc, xs, w_scale)
    b, mask = _vecs(f, b=b)
    _, codes, scales = _outputs(acc)
    from ttasr_torch.ops._build import launch

    launch("ttasr_gelu_quant_acc", acc.device, acc, xs, ws, b, codes, scales,
           rows, f, mask)
    count_launch(gelu_quant_acc)
    return codes, scales


def _acc_add_ln(entry, x, acc, xs, w_scale, b, scale, bias):
    """Launches ``entry`` (``ln_quant_acc``'s or ``add_ln_quant_acc``'s) on
    x (..., D) bf16 and acc (..., D) int32; returns (resid, codes,
    scales)."""
    _, d = _rows(x, "x")
    if acc.shape != x.shape or acc.device != x.device:
        raise ValueError(f"x {tuple(x.shape)} and acc {tuple(acc.shape)} must match")
    rows, _, xs, ws = _acc_rows(acc, xs, w_scale)
    b, s, lb, mask = _vecs(d, b=b, scale=scale, bias=bias)
    _, codes, scales = _outputs(x)
    resid = torch.empty_like(x)
    from ttasr_torch.ops._build import launch

    launch(entry, x.device, x, acc, xs, ws, b, s, lb, resid, codes, scales, rows, d,
           mask)
    return resid, codes, scales


def ln_quant_acc(x, acc, xs, w_scale, b, scale, bias):
    """B5 after W2: ``x' = x + bf16(acc * xs * w_scale + b)`` (the bf16
    residual add), then LN1 of ``x'`` -> (x', int8 codes, f32 row scales
    (..., 1)).  x (..., D) bf16; acc (..., D) int32 with row scales xs."""
    if not _dispatch(x):
        return ln_quant_acc_ref(x, acc, xs, w_scale, b, scale, bias)
    out = _acc_add_ln("ttasr_ln_quant_acc", x, acc, xs, w_scale, b, scale, bias)
    count_launch(ln_quant_acc)
    return out


def add_ln_quant_acc(x, acc, xs, w_scale, b, scale, bias):
    """B8 after wo: ``s = f32(x) + f32(y)``, y = ``acc * xs * w_scale + b``
    rounded to x's type -> (s in x's type, int8 codes and f32 row scales
    (..., 1) of LN2 of the f32 sum ``s``).  x (..., D) bf16 on the card;
    acc (..., D) int32 with row scales xs."""
    if not _dispatch(x):
        return add_ln_quant_acc_ref(x, acc, xs, w_scale, b, scale, bias)
    out = _acc_add_ln("ttasr_add_ln_quant_acc", x, acc, xs, w_scale, b, scale, bias)
    count_launch(add_ln_quant_acc)
    return out


def qkv_epilogue_acc(acc, xs, w_scale, b, q_scale, out_dtype=torch.bfloat16):
    """The fused qkv GEMM's epilogue from its int32 accumulators acc (...,
    3D), row scales xs (..., 1), column scales w_scale (1, 3D) and bias b
    (3D,) or None: ``acc * xs * w_scale' + b'`` in ``out_dtype``, where
    w_scale' and b' are w_scale and b with their first D columns times
    ``q_scale`` (the f32 products; exact for a power of two such as
    64**-0.5).  Returns the (..., 3D) buffer B6 reads; the kernel writes
    bf16."""
    if not _dispatch(acc):
        return qkv_epilogue_acc_ref(acc, xs, w_scale, b, q_scale, out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the qkv epilogue kernel writes bf16, not {out_dtype}")
    rows, w, xs, ws = _acc_rows(acc, xs, w_scale)
    if w % 3:
        raise ValueError(f"acc: width {w} is not 3 x D")
    b, mask = _vecs(w, b=b)
    out = torch.empty(acc.shape, dtype=torch.bfloat16, device=acc.device)
    from ttasr_torch.ops._build import launch

    launch("ttasr_qkv_epilogue_acc", acc.device, acc, xs, ws, b, out, rows, w,
           w // 3, float(q_scale), mask)
    count_launch(qkv_epilogue_acc)
    return out


for _fn in (ln_quant, add_ln_quant, gelu_quant, quant_only, gelu_quant_acc,
            ln_quant_acc, add_ln_quant_acc, qkv_epilogue_acc):
    _fn.launches = 0
