"""The collectives of tensor-parallel training, as autograd Functions.

The JAX package needs none of these: under ``jit`` XLA partitions the
forward and the backward over the mesh by the params' shardings and
inserts the collectives of both itself.  Here each rank is a process that
holds its ``shard_params`` slice, and the model code
(``ttasr_torch/models/whisper/model.py``) calls these where a sum or a
gather crosses the ``"model"`` axis, each with the backward that the
computation downstream of it calls for:

- :func:`copy_to_model`: identity forward, the gradient summed over the
  axis in backward.  Before a column-split projection: its input is whole
  on every rank, and each rank's columns give only part of its gradient.
- :func:`reduce_from_model`: the sum over the axis forward, identity
  backward.  After a row-split projection: every rank computes the same
  thing from the sum, so each already holds the sum's gradient, which is
  its partial product's.  (``torch.distributed.nn.functional.all_reduce``
  differentiates to another all-reduce, which gives n times the gradient
  here.)
- :func:`vocab_embed`: the lookup in a vocabulary-split ``embed``, each
  rank's rows with the others' ids as zeros, summed over the axis; the
  backward lands in the rank's own rows only.
- :func:`gather_vocab`: the logits' gather over the vocabulary split.  The
  backward is the rank's slice of the gradient, since every rank computes
  the same loss from the gathered logits.
- :func:`gather_cut_columns`: the attention's q/k/v columns gathered where
  the axis cuts a head (the model axis divides d_model but not the heads,
  as large-v3's 20 heads at 8).  Every rank then runs the attention on
  every head but uses only its own columns of the result, so the gradients
  differ between ranks: the backward sums them over the axis and keeps the
  rank's slice.

Each takes the axis's process group; the model code looks it up with
``ttasr_torch.parallel.sharding.axis_group("model")``, which raises
outside a binding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ttasr_torch.parallel.collectives import all_reduce_sum, gather_last, own_columns


def _all_reduce(x, group):
    return all_reduce_sum(x.contiguous().clone(), group)


def _own_columns(x, group):
    return own_columns(x, group, x.shape[-1] // dist.get_world_size(group))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_columns(grad, ctx.group), None


class _GatherCutColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_columns(_all_reduce(grad, ctx.group), ctx.group), None


def copy_to_model(x, group):
    """x, whole on every rank, into a column-split projection."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The sum over the axis of the ranks' partial products ``x``."""
    return _ReduceFromModel.apply(x, group)


def gather_vocab(x, group):
    """The ranks' vocabulary slices of the logits, concatenated in rank
    order along the last axis."""
    return _GatherVocab.apply(x, group)


def gather_cut_columns(x, group):
    """The ranks' column slices of q, k or v, concatenated in rank order
    along the last axis, where the slices end inside a head."""
    return _GatherCutColumns.apply(x, group)


def vocab_embed(rows, tokens, group):
    """The embeddings of ``tokens`` from this rank's rows ``rows`` (n, d) of
    a vocabulary-split table (rank r holds ids ``[r n, (r + 1) n)``), in
    float32: one non-zero term per token in the sum, so exact."""
    n = rows.shape[0]
    local = tokens - dist.get_rank(group) * n
    inside = (local >= 0) & (local < n)
    picked = rows[torch.where(inside, local, 0)].to(torch.promote_types(rows.dtype, torch.float32))
    return reduce_from_model(torch.where(inside[..., None], picked, 0.0), group)
