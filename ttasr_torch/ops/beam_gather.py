"""Beam-reorder gather of the flat int8/int4 self-KV cache: the Hopper
kernel and its plain version.

Port of ``ttasr/ops/beam_gather_pallas.py::gather_cache_rows`` (B17):
``out[l, i] = in[l, idx[i]]`` along the row axis of k, v (L, BK, T, D)
int8 or (L, BK, T, D/2) uint8 and ks, vs (L, BK, HP, T) f32, all four in
one launch.  Beam search without the ancestry map runs it once per step.

The copy is out of place: ``out`` is a second set of four buffers of the
same shapes (the caller swaps the two sets each step), or None to allocate
one.  :func:`gather_cache_rows` runs :func:`gather_cache_rows_ref`
(``index_select``) for CPU tensors and launches
``ttasr_torch/csrc/beam_gather.cu`` for CUDA tensors, counting launches in
``gather_cache_rows.launches``; anything else raises.  Both give the same
bytes.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops._build import count_launch
from ttasr_torch.ops.decoder_blocks import _check_cuda, _dispatch


def gather_cache_rows_ref(k, v, ks, vs, idx, out=None):
    """(k, v, ks, vs) with rows (axis 1) taken at ``idx`` (BK,)."""
    idx = idx.to(device=k.device, dtype=torch.long)
    if out is None:
        return tuple(t.index_select(1, idx) for t in (k, v, ks, vs))
    for t, o in zip((k, v, ks, vs), out):
        torch.index_select(t, 1, idx, out=o)
    return tuple(out)


def gather_cache_rows(k, v, ks, vs, idx, out=None):
    """B17; see :func:`gather_cache_rows_ref` for the contract."""
    if not _dispatch(k):
        return gather_cache_rows_ref(k, v, ks, vs, idx, out)
    n_layers, bk = k.shape[:2]
    if k.dim() != 4 or k.dtype not in (torch.int8, torch.uint8) \
            or v.shape != k.shape or v.dtype != k.dtype:
        raise TypeError(f"k and v must be int8/uint8 (L, BK, T, D): {k.dtype} "
                        f"{tuple(k.shape)}, {v.dtype} {tuple(v.shape)}")
    if ks.dim() != 4 or ks.shape[:2] != (n_layers, bk) or vs.shape != ks.shape \
            or {ks.dtype, vs.dtype} != {torch.float32}:
        raise TypeError(f"ks and vs must be f32 (L, BK, HP, T): {ks.dtype} "
                        f"{tuple(ks.shape)}, {vs.dtype} {tuple(vs.shape)}")
    idx = idx.to(device=k.device, dtype=torch.int32).contiguous()
    if idx.shape != (bk,):
        raise ValueError(f"idx {tuple(idx.shape)} != ({bk},)")
    kv_row, sc_row = k[0, 0].nbytes, ks[0, 0].nbytes
    if kv_row % 16 or sc_row % 16:
        raise ValueError(f"rows of {kv_row} and {sc_row} bytes: the kernel "
                         f"copies 16-byte words")
    if out is None:
        out = tuple(torch.empty_like(t) for t in (k, v, ks, vs))
    for t, o in zip((k, v, ks, vs), out):
        if o.shape != t.shape or o.dtype != t.dtype:
            raise ValueError(f"out {o.dtype} {tuple(o.shape)} does not match "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = _check_cuda(k=k, v=v, ks=ks, vs=vs, idx=idx, out_k=out[0],
                      out_v=out[1], out_ks=out[2], out_vs=out[3])
    from ttasr_torch.ops._build import launch

    launch("ttasr_gather_cache_rows", dev, k, v, ks, vs, idx, *out,
           n_layers, bk, kv_row, sc_row)
    count_launch(gather_cache_rows)
    return tuple(out)


gather_cache_rows.launches = 0
