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

The GSPMD parameter specs (``param_pspecs``, ``sanitize_spec``,
``shard_params``, ``data_pspec``; Megatron-style column/row splits over
the ``"model"`` axis, the JAX module's rules):

- ``wq/wk/wv``, ``wq_c/wk_c/wv_c``, ``w1`` and the fused ``wqkv`` (d, n):
  the output columns split, ``(None, "model")``;
- ``wo``, ``wo_c``, ``w2``: the input rows split, ``("model", None)``;
- the biases of the column-split projections follow their outputs,
  ``("model",)``;
- ``embed`` (V, d): the vocabulary split, ``("model", None)``;
- everything else (norms, conv stems, positions, row biases) replicated,
  ``()``; a quantized ``{q, s}`` leaf's codes take its weight's spec, its
  scales shard like the bias of a column-split weight and are replicated
  otherwise.

A spec is a plain tuple of axis names or None, one per dimension of the
leaf as the port stores it: the port keeps one dict per layer where the
JAX package stacks the layers on a leading axis, so a block leaf's spec
is the JAX spec without its leading ``None``.  Where JAX places a leaf on
the mesh's devices, :func:`shard_params` returns this rank's slice of it,
the data the device at its coordinates holds.  The ZeRO-1 helpers and the
multislice mesh belong to training and are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
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
            f"through ttasr_torch.parallel.tp.TPDecoder or "
            f"ttasr_torch.parallel.gspmd.ShardedDecoder") from None


# ---------------------------------------------------------------------------
# GSPMD parameter specs
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]

# column-split (output dim sharded) / row-split (input dim sharded) names;
# ``wqkv``/``bqkv`` are the fused decoder qkv layout, a concat of three
# column-split projections along the output dim
_COL_SPLIT = {"wq", "wk", "wv", "wq_c", "wk_c", "wv_c", "w1", "wqkv"}
_ROW_SPLIT = {"wo", "wo_c", "w2"}
_COL_BIAS = {"bq", "bv", "bq_c", "bv_c", "b1", "bqkv"}


def _leaf_spec(name: str) -> Spec:
    """The spec of a float leaf named ``name`` (its dims as the port stores
    it: a layer's (d_in, d_out) weight, (d_out,) bias, the (V, d) table)."""
    if name in _COL_SPLIT:
        return (None, "model")
    if name in _ROW_SPLIT or name == "embed":
        return ("model", None)
    if name in _COL_BIAS:
        return ("model",)
    return ()  # replicate: norms, conv stems, positions, row biases


def _quant_spec(name: str) -> Dict[str, Spec]:
    """A quantized ``{q, s}`` leaf: the codes take the weight's spec; the
    scales (1, d_out) shard like a column-split weight's bias, and are
    replicated for every other weight."""
    return {"q": _leaf_spec(name),
            "s": (None, "model") if name in _COL_SPLIT else ()}


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def param_pspecs(params):
    """The spec tree matching the parameter tree: a tuple per tensor leaf,
    ``{"q": spec, "s": spec}`` per quantized leaf."""

    def walk(tree):
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        out = {}
        for key, leaf in tree.items():
            if _is_quantized(leaf):
                out[key] = _quant_spec(key)
            elif isinstance(leaf, (dict, list)):
                out[key] = walk(leaf)
            else:
                out[key] = _leaf_spec(key)
        return out

    return walk(params)


def sanitize_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Replicate any dimension its axis does not divide (an odd vocabulary
    on a 2-way model axis, large-v3's 51866 rows on a 4-way one); the spec
    comes back with one entry per dimension."""
    cleaned = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        cleaned.append(axis if axis is not None and dim % mesh.shape[axis] == 0
                       else None)
    return tuple(cleaned)


def _slice(x, spec: Spec, mesh: Mesh):
    """This rank's block of x under ``spec`` (sanitized): each split
    dimension cut into ``mesh.shape[axis]`` equal parts, the part at the
    rank's coordinate on the axis; contiguous (the kernels read contiguous
    operands)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            width = x.shape[dim] // mesh.shape[axis]
            x = x.narrow(dim, mesh.coords[axis] * width, width)
    return x.contiguous()


def shard_params(params, mesh: Mesh):
    """This rank's slice of every leaf under :func:`param_pspecs`, each spec
    sanitized for the leaf's shape: the data the JAX package's
    ``shard_params`` places on the device at this rank's coordinates."""
    specs = param_pspecs(params)

    def walk(tree, spec):
        if isinstance(tree, list):
            return [walk(t, s) for t, s in zip(tree, spec)]
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if not torch.is_tensor(tree):
            return tree
        return _slice(tree, sanitize_spec(spec, tree.shape, mesh), mesh)

    return walk(params, specs)


def data_pspec(ndim: int = 1) -> Spec:
    """Batch-sharded spec: the first axis over "data", the rest
    replicated."""
    return ("data",) + (None,) * (ndim - 1)
