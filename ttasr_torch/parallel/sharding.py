"""The device mesh (port of ``ttasr/parallel/sharding.py::create_mesh``
and of ``ttasr/parallel/distributed.py::create_multislice_mesh``'s layout).

A mesh is the ranks of the default process group laid out as
``(data, model)``, or ``(dcn_data, data, model)`` for the multislice mesh,
in the JAX package's device order: rank r sits at the index of device r in
``np.arange(world).reshape(shape)`` (``(r // model, r % model)`` on the
two-axis mesh).  Each rank keeps its coordinates and one process group per
axis, the ranks that differ from it on that axis alone (``"model"``: its
data row; ``"data"``: its model column within its slice; ``"dcn_data"``:
the same place in the other slices), and one for the data axes together
(:data:`DATA_AXES`: every rank of its model column).

Collectives name their axis, as ``jax.lax.psum(x, "model")`` does inside
``shard_map``: :func:`bind_axes` binds axis names to process groups for a
block of code and :func:`axis_group` looks a name up, raising outside any
binding, so a decode or a training step that names an axis never runs
unsharded by mistake.

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

A spec is a plain tuple, one entry per dimension of the leaf as the port
stores it: None, an axis name, or a tuple of axis names that split the
dimension together, the first the major one (``P(("dcn_data", "data"))``
in JAX).  The port keeps one dict per layer where the JAX package stacks
the layers on a leading axis, so a block leaf's spec is the JAX spec
without its leading ``None``.  Where JAX places a leaf on the mesh's
devices, :func:`shard_params` returns this rank's slice of it, the data the
device at its coordinates holds.

ZeRO-1 (:func:`zero1_moment_spec`, :func:`shard_opt_state`) is JAX's rule
on the port's leaf shapes: AdamW's moments take the data axes on the first
dimension that their product divides and that the model axis left free.
A block leaf has no layer axis here, so a ``(1280, 1280)`` moment takes
them on dim 0 where JAX's stacked ``(32, 1280, 1280)`` takes the layer
axis (the same bytes per rank), and a column-split bias ``(1280,)``, its
one dimension the model axis's, stays replicated over data where JAX
slices its layer axis.  AdamW is elementwise, so the placement changes no
number.  :func:`gather_leaf` is the inverse: a rank's slice back to the
whole leaf, for checkpoints and evaluation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis -> size; ``coords``: this rank's index on each axis;
    ``groups``: axis -> the process group of the ranks along it."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]


DATA_AXES = ("dcn_data", "data")  # the key of the data axes' joint group


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each axis of ``shape`` (axes in order, the
    last the minor one): the place of device ``rank`` in JAX's
    ``np.asarray(devices).reshape(shape)``."""
    index = np.unravel_index(rank, tuple(shape.values()))
    return {axis: int(i) for axis, i in zip(shape, index)}


def require_group(mesh: Mesh, what: str) -> None:
    """Raise unless ``mesh`` has its process groups (a mesh built by hand,
    or in a process whose default group is down, has none)."""
    if not dist.is_initialized() or "model" not in mesh.groups:
        raise RuntimeError(
            f"{what} on a mesh needs its process groups: call ttasr_torch.parallel."
            f"distributed.initialize_distributed in every rank (one process per "
            f"rank, e.g. under torchrun), then create_mesh")


def build_mesh(shape: Dict[str, int]) -> Mesh:
    """The mesh of ``shape`` over every rank of the default group, with a
    group per axis and one for the data axes together."""
    world = int(np.prod(list(shape.values())))
    name = "x".join(str(n) for n in shape.values())
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {name} needs {world} ranks and no process group is up: call "
            f"ttasr_torch.parallel.distributed.initialize_distributed first (one "
            f"process per rank, e.g. under torchrun)")
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {name} needs {world} ranks, the group has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    place = np.arange(world).reshape(tuple(shape.values()))
    mine = mesh_coords(shape, rank)
    axes = list(shape)
    groups = {}
    # one group per line along each axis, then per model column for the
    # data axes together, every rank making every group in the same order
    data_axes = tuple(a for a in axes if a != "model")
    for key, along in [(a, (a,)) for a in data_axes] + [
            ("model", ("model",)), (DATA_AXES, data_axes)]:
        if key == DATA_AXES and len(along) == 1:
            groups[key] = groups[along[0]]
            continue
        keep = [i for i, a in enumerate(axes) if a not in along]
        lines = np.moveaxis(place, keep, list(range(len(keep)))).reshape(
            -1, int(np.prod([shape[a] for a in along])))
        for line in lines:
            group = dist.new_group(sorted(int(r) for r in line))
            if rank in line:
                groups[key] = group
    return Mesh(shape=dict(shape), coords=mine, groups=groups)


def create_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the default group
    (``ttasr_torch.parallel.distributed.initialize_distributed`` first).
    Every rank must call it, in the same order as any other group it
    makes: ``dist.new_group`` is collective."""
    return build_mesh({"data": data, "model": model})


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
            f"ttasr_torch.parallel.gspmd.ShardedDecoder, train through "
            f"ttasr_torch.train.train_step.make_train_step(mesh=...)") from None


# ---------------------------------------------------------------------------
# GSPMD parameter specs
# ---------------------------------------------------------------------------

# an entry: None, an axis name, or the axis names that split one dimension
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

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


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(mesh: Mesh, entry) -> int:
    """The number of parts a spec entry (an axis or a tuple of axes) cuts
    its dimension into."""
    return int(np.prod([mesh.shape[a] for a in _axes(entry)]))


def axis_index(mesh: Mesh, entry) -> int:
    """This rank's part under a spec entry: its coordinates on the entry's
    axes, the first the major one."""
    index = 0
    for a in _axes(entry):
        index = index * mesh.shape[a] + mesh.coords[a]
    return index


def entry_group(mesh: Mesh, entry):
    """The process group of the ranks that hold the other parts under a
    spec entry (rank i of the group holds part i): an axis's, or for a
    tuple (ZeRO-1's data axes) the data axes' joint group."""
    axes = _axes(entry)
    return mesh.groups[axes[0]] if len(axes) == 1 else mesh.groups[DATA_AXES]


def slice_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape`` under ``spec``
    (sanitized)."""
    return tuple(d if e is None else d // axis_size(mesh, e) for d, e in zip(shape, spec))


def slice_view(x, spec: Spec, mesh: Mesh):
    """This rank's block of x under ``spec`` (sanitized), as a view: each
    split dimension cut into ``axis_size`` equal parts, the part at the
    rank's :func:`axis_index`."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            width = x.shape[dim] // axis_size(mesh, entry)
            x = x.narrow(dim, axis_index(mesh, entry) * width, width)
    return x


def slice_leaf(x, spec: Spec, mesh: Mesh):
    """:func:`slice_view`, contiguous (the kernels read contiguous
    operands) and, where it is smaller than x, in storage of its own: a
    row block of a contiguous leaf is itself contiguous, and as a view it
    would keep the whole leaf's storage alive."""
    view = slice_view(x, spec, mesh)
    if view.numel() < x.numel():
        return view.clone(memory_format=torch.contiguous_format)
    return view.contiguous()


def gather_leaf(x, spec: Spec, mesh: Mesh):
    """The whole leaf from every rank's slice ``x`` under ``spec``: an
    all-gather along each split dimension over the ranks that hold its
    other parts (collective: every rank of the mesh calls it).  The
    inverse of :func:`slice_leaf`."""
    for dim, entry in enumerate(spec):
        if entry is not None and axis_size(mesh, entry) > 1:
            group = entry_group(mesh, entry)
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=dim)
    return x


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
        return slice_leaf(tree, sanitize_spec(spec, tree.shape, mesh), mesh)

    return walk(params, specs)


def data_pspec(ndim: int = 1) -> Spec:
    """Batch-sharded spec: the first axis over "data", the rest
    replicated."""
    return ("data",) + (None,) * (ndim - 1)


def _by_path(params, fn) -> Dict[str, Any]:
    """``fn(spec, shape)`` of every tensor leaf by its dotted path
    (``encoder.blocks.0.wq``, the names of
    ``ttasr_torch.core.checkpoint.named_leaves``), ``spec`` its
    :func:`param_pspecs` entry."""
    out: Dict[str, Any] = {}

    def walk(tree, spec, prefix):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, value in items:
            path = f"{prefix}.{key}" if prefix else str(key)
            if torch.is_tensor(value):
                out[path] = fn(spec[key], value.shape)
            else:
                walk(value, spec[key], path)

    walk(params, param_pspecs(params), "")
    return out


def leaf_specs(params, mesh: Mesh) -> Dict[str, Spec]:
    """Each leaf's sanitized spec by its dotted path."""
    return _by_path(params, lambda spec, shape: sanitize_spec(spec, shape, mesh))


def shard_batch(batch: dict, mesh: Mesh) -> Tuple[dict, Tuple[int, int]]:
    """This rank's rows of a global batch (dim 0 of every leaf over the
    data axes, ``("dcn_data", "data")`` on a multislice mesh, as the JAX
    train step's ``in_shardings``), and ``(first row, global rows)``.
    Raises where the data axes do not divide the batch, as
    ``jax.device_put`` does."""
    axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    parts, index = axis_size(mesh, axes), axis_index(mesh, axes)
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch leaves disagree on their rows: {sorted(rows)}")
    (total,) = rows
    if total % parts:
        raise ValueError(f"a batch of {total} rows does not split over the data "
                         f"axes' {parts} ranks")
    n = total // parts
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}, (index * n, total)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axes
# ---------------------------------------------------------------------------

def _data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.shape and mesh.shape[a] > 1)


def zero1_moment_spec(param_spec: Spec, shape, mesh: Mesh) -> Spec:
    """A param's (sanitized) spec with the data axes on the first dimension
    that the model axis left free and that their product divides: the
    slice of AdamW's moments this rank owns (JAX's rule, on the port's leaf
    shapes; see the module docstring)."""
    axes = _data_axes(mesh)
    base = list(sanitize_spec(param_spec, shape, mesh))
    if not axes:
        return tuple(base)
    dsize = axis_size(mesh, axes)
    entry = axes if len(axes) > 1 else axes[0]
    for i, (dim, ax) in enumerate(zip(shape, base)):
        if ax is None and dim % dsize == 0 and dim >= dsize:
            base[i] = entry
            break
    return tuple(base)


def moment_specs(params, mesh: Mesh) -> Dict[str, Spec]:
    """:func:`zero1_moment_spec` of every leaf by its dotted path."""
    return _by_path(params, lambda spec, shape: zero1_moment_spec(spec, shape, mesh))


def shard_opt_state(opt_state, params, mesh: Mesh):
    """This rank's ZeRO-1 slice of an optimizer state: every field that
    holds a tensor per leaf of ``params`` (AdamW's ``mu`` and ``nu``,
    ``MultiSteps``' ``acc``: JAX's ``is_moment_tree``) cut by
    :func:`zero1_moment_spec`; the counters stay whole.  ``opt_state`` and
    ``params`` are whole; a new state comes back."""
    specs = moment_specs(params, mesh)
    fields = {}
    for f in dataclasses.fields(opt_state):
        value = getattr(opt_state, f.name)
        if isinstance(value, dict) and set(value) == set(specs):
            fields[f.name] = {k: slice_leaf(v, specs[k], mesh) for k, v in value.items()}
    return dataclasses.replace(opt_state, **fields)

