"""Inference collectives over a mesh axis, without autograd.

The encoder, the language detection and the word alignment of an engine
on a mesh run on ``shard_params``' slices, and their sums and gathers over
the ``"model"`` axis need no backward: the int32 sum of the s8 x s8
encoder's row-split partial accumulators (wo's and W2's, summed before the
row kernels apply their epilogues), the f32 MAX of the row kernels' partial
absmax where the axis splits a row they quantize, and the gather of
columns in rank order.  ``ttasr_torch/parallel/tp_train.py`` holds the
training twins, autograd Functions.  Each takes the axis's process group
(``ttasr_torch.parallel.sharding.axis_group("model")``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(x, group):
    """The sum over the axis of every rank's ``x`` (a fresh tensor of the
    caller's, int32 or f32), reduced in place and returned."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x, group):
    """The elementwise max over the axis, in place (exact in any order)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_last(x, group):
    """The ranks' ``x`` concatenated along the last axis in rank order
    (rank i holds columns [i * w, (i + 1) * w))."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def own_columns(x, group, width: int):
    """This rank's ``width`` columns of whole columns ``x``, contiguous."""
    return x.narrow(-1, dist.get_rank(group) * width, width).contiguous()
