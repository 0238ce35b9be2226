"""The device mesh (port of ``ttasr/parallel/sharding.py::create_mesh``).

A mesh is the ranks of the default process group laid out as
``(data, model)``, in the JAX package's device order: rank r sits at
``(r // model, r % model)``.  Each rank keeps its coordinates and one
process group per axis: the ranks that share its data row (``"model"``)
and those that share its model column (``"data"``).

Collectives name their axis, as ``jax.lax.psum(x, "model")`` does inside
``shard_map``: :func:`bind_axes` binds axis names to process groups for a
block of code and :func:`axis_group` looks a name up, raising outside any
binding, so a decode that names an axis never runs unsharded by mistake.
The GSPMD parameter specs (``param_pspecs``, ``shard_params``) are not
ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator

import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis -> size; ``coords``: this rank's index on each axis;
    ``groups``: axis -> the process group of the ranks along it."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]


def create_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the default group
    (``ttasr_torch.parallel.distributed.initialize_distributed`` first).
    Every rank must call it, in the same order as any other group it
    makes: ``dist.new_group`` is collective."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "ttasr_torch.parallel.distributed."
                           "initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the group has {world}")
    groups = {}
    for i in range(data):
        ranks = [i * model + j for j in range(model)]
        group = dist.new_group(ranks)
        if rank in ranks:
            groups["model"] = group
    for j in range(model):
        ranks = [i * model + j for i in range(data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            groups["data"] = group
    return Mesh(shape={"data": data, "model": model},
                coords={"data": rank // model, "model": rank % model},
                groups=groups)


_BOUND: Dict[str, Any] = {}


@contextlib.contextmanager
def bind_axes(groups: Dict[str, Any]) -> Iterator[None]:
    """Bind axis names to process groups for the block (as ``shard_map``
    binds its mesh's axis names for its body)."""
    saved = dict(_BOUND)
    _BOUND.update(groups)
    try:
        yield
    finally:
        _BOUND.clear()
        _BOUND.update(saved)


def axis_group(name: str):
    """The process group bound to axis ``name``; raises outside a
    binding."""
    try:
        return _BOUND[name]
    except KeyError:
        raise RuntimeError(
            f"mesh axis {name!r} is not bound to a process group: decode "
            f"through ttasr_torch.parallel.tp.TPDecoder") from None
