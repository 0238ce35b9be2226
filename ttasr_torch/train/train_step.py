"""The training step: loss, optimizer, update (port of
``ttasr/train/train_step.py``).

Replaces Seq2SeqTrainer.train() internals (reference train_asr.py:697-716,
run.sh hyperparameters): AdamW + linear warmup, label smoothing off, -100
masking, gradient clipping, optional remat (the reference's
``gradient_checkpointing``), optional mixed precision
(``compute_dtype=torch.bfloat16`` casts the forward only; master params
and grads stay f32).

The JAX package builds its optimizer from optax; the port computes the
same transformations itself, where the stock PyTorch idiom differs:

- the learning rate of update k is ``schedule(k)``, optax's
  ``join_schedules`` of a linear warm-up from 0 and a linear decay to 0,
  in float32 (the first update uses ``schedule(0)``, 0 when
  ``warmup_steps > 0``);
- clipping is ``optax.clip_by_global_norm``'s: grads untouched when the
  global norm is below ``max_grad_norm``, else ``g / norm * max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- AdamW is ``optax.adamw``'s: eps outside the square root, weight decay
  decoupled (``lr * wd * p`` on the pre-update p) on every leaf;
- gradient accumulation is ``optax.MultiSteps``': a running mean of k
  micro-batch grads, then one clip and one AdamW update on it; the
  schedule counts those updates, ``TrainState.step`` the micro-steps;
- leaves that get no gradient (the encoder under ``freeze_encoder``) get
  zeros, as ``jax.lax.stop_gradient`` gives, so AdamW still decays them.

Params are the port's functional tree; a step updates the state in place
and returns it.

On a mesh (``make_train_step(mesh=...)``, ``init_train_state(mesh=...)``,
the JAX package's GSPMD step) each rank is a process that holds its
``shard_params`` slice of the params and steps on its rows of the global
batch (the data axes, ``("dcn_data", "data")`` on a multislice mesh); the
forward and backward run tensor-parallel over ``"model"`` through the
autograd collectives of ``ttasr_torch.parallel.tp_train``.  What XLA
derives from the shardings in the JAX package is written out here:

- the loss is the global batch's token mean: each rank divides its sum by
  the token count summed over the data axes, and the gradients are summed
  over them (a mean of the ranks' means is wrong wherever their label
  counts differ), within a slice first and then across slices;
- ZeRO-1 (the default): AdamW's moments, and ``MultiSteps``' running mean,
  are the rank's slice over the data axes (``sharding.zero1_moment_spec``);
  the rank updates its slice of the params from them, then the slices are
  all-gathered over the data axes.  The gradients are all-reduced whole (a
  reduce-scatter to the moment slice would move half the bytes);
- the clip's norm is the whole gradient's: the squares of each slice are
  counted on one rank of those that hold it and summed over the mesh;
- SpecAugment draws for the global batch from the step's generator, and a
  rank masks its rows with their draws, so a row gets the masks it gets in
  the single-process step.

The state's ``state_dict`` gathers the whole state (a collective), so a
checkpoint written from a mesh is the one-process run's, and
``load_state_dict`` takes a whole state and keeps the rank's slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ttasr_torch.core.checkpoint import copy_into, map_leaves, named_leaves
from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.model import decode_train, encode
from ttasr_torch.parallel.sharding import (
    DATA_AXES,
    Spec,
    axis_index,
    bind_axes,
    gather_leaf,
    leaf_specs,
    moment_specs,
    require_group,
    shard_batch,
    shard_params,
    slice_leaf,
    slice_shape,
    slice_view,
)
from ttasr_torch.train.spec_augment import SpecAugmentConfig, spec_augment

LABEL_PAD = -100
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's, as the JAX package sets them
BUCKET_ELEMENTS = 1 << 24  # the gradient all-reduce's flat buffers: 64 MiB of f32
CHUNK_ELEMENTS = 1 << 26  # AdamW's elementwise passes: 256 MiB of f32 a chunk


@dataclasses.dataclass
class OptState:
    """AdamW's moments and update count, and ``optax.MultiSteps``' state.

    ``count`` is the number of updates applied: adam's step count, the
    schedule's and ``MultiSteps``' gradient step in one (optax keeps three,
    always equal).  ``mini_step`` is the micro-batch within an update and
    ``acc`` the running mean of its grads (None without accumulation)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0
    acc: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Where a train state's tensors lie on ``mesh``: each leaf's spec by
    its dotted path, the params' (``shard_params``: the model axis) and the
    moments' (with ZeRO-1 the data axes too, on one more dimension)."""

    mesh: Any
    params: Dict[str, Spec]
    moments: Dict[str, Spec]

    def spec(self, key: str) -> Spec:
        """The spec of a ``state_dict`` entry (``params/...``, ``mu/...``)."""
        group, name = key.split("/", 1)
        return self.params[name] if group == "params" else self.moments[name]

    def data_spec(self, name: str) -> Spec:
        """The entries ZeRO-1 adds to a leaf's spec: where its moments cut
        the rank's param slice over the data axes (all None where they are
        whole over them)."""
        return tuple(m if m != p else None
                     for p, m in zip(self.params[name], self.moments[name]))

    def owns(self, name: str) -> bool:
        """Whether this rank counts the leaf's moment slice in a sum over
        the mesh: the first of the ranks that hold the same slice."""
        mesh = self.mesh
        if "model" not in self.params[name] and mesh.coords["model"]:
            return False
        return any(self.data_spec(name)) or not axis_index(
            mesh, tuple(a for a in DATA_AXES if a in mesh.shape))


@dataclasses.dataclass
class TrainState:
    step: int  # micro-steps taken
    params: Any
    opt_state: OptState
    layout: Optional[MeshLayout] = None  # on a mesh: the rank's slices

    _COUNTERS = ("step", "count", "mini_step")

    def _counter(self, name: str) -> int:
        return self.step if name == "step" else getattr(self.opt_state, name)

    def _flat(self) -> Dict[str, torch.Tensor]:
        out = {name: torch.tensor(self._counter(name), dtype=torch.int64)
               for name in self._COUNTERS}
        opt = self.opt_state
        for group, flat in (("params", named_leaves(self.params)), ("mu", opt.mu),
                            ("nu", opt.nu), ("acc", opt.acc or {})):
            out.update({f"{group}/{k}": v for k, v in flat.items()})
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Flat name -> tensor: ``params/``, ``mu/``, ``nu/`` (and ``acc/``)
        leaves and the counters as int64 scalars.  On a mesh the whole
        state, gathered from every rank's slices: a collective that every
        rank calls."""
        out = self._flat()
        if self.layout is None:
            return out
        return {k: v if k in self._COUNTERS else
                gather_leaf(v, self.layout.spec(k), self.layout.mesh)
                for k, v in out.items()}

    def load_state_dict(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy a :meth:`state_dict` into this state's tensors in place (on
        a mesh, a whole state: the rank keeps its slices)."""
        tensors = {k: v for k, v in self._flat().items() if k not in self._COUNTERS}
        src = {k: v for k, v in flat.items() if k not in self._COUNTERS}
        if self.layout is not None:
            src = {k: slice_leaf(v, self.layout.spec(k), self.layout.mesh)
                   if k in tensors else v for k, v in src.items()}
        copy_into(tensors, src, "train state")
        # _flat's leaves are this state's own tensors, so the copy landed
        self.step = int(flat["step"])
        for name in self._COUNTERS[1:]:
            setattr(self.opt_state, name, int(flat[name]))

    def whole_params(self):
        """The whole params: ``params`` itself, or on a mesh the slices
        gathered (collective)."""
        if self.layout is None:
            return self.params
        return map_leaves(lambda path, x: gather_leaf(x, self.layout.params[path],
                                                      self.layout.mesh), self.params)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, targets, label_pad: int = LABEL_PAD, token_count=None):
    """Masked token-mean cross entropy. logits (B,T,V), targets (B,T);
    0 on a batch that is all pad (``F.cross_entropy``'s mean gives NaN).
    ``token_count``: the count to divide by, where these rows are a rank's
    part of a global batch (its share of the global mean); default the
    rows' own."""
    mask = (targets != label_pad).to(torch.float32)
    safe_targets = torch.where(targets == label_pad, 0, targets)
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    token_ll = torch.gather(logprobs, -1, safe_targets[..., None].long())[..., 0]
    total = torch.sum(mask) if token_count is None else token_count
    return -torch.sum(token_ll * mask) / torch.clamp(total, min=1.0)


def cast_params(params, dtype):
    """A differentiable ``dtype`` copy of every floating leaf, except those
    whose path holds ``conv`` (the stem convs stay f32, as in the JAX
    package): the mixed-precision forward's weights."""
    def cast(path, x):
        if not x.is_floating_point() or "conv" in path:
            return x
        return x.to(dtype)

    return map_leaves(cast, params)


def loss_fn(params, cfg: WhisperConfig, batch, *, remat: bool = False,
            freeze_encoder: bool = False, compute_dtype=None, token_count=None):
    if compute_dtype is not None:
        params = cast_params(params, compute_dtype)
    enc_params = params
    if freeze_encoder:
        enc_params = map_leaves(lambda _, x: x.detach(), params)
    enc_out = encode(enc_params, cfg, batch["mel"], remat=remat,
                     fused_attention=False)
    if freeze_encoder:
        enc_out = enc_out.detach()
    logits = decode_train(params, cfg, batch["decoder_input_ids"], enc_out,
                          remat=remat)
    return cross_entropy_loss(logits, batch["labels"], token_count=token_count)


def value_and_grad(params, cfg: WhisperConfig, batch, **loss_kw
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads by leaf name) at ``params``; a leaf that the loss does
    not reach gets zeros, as ``jax.value_and_grad`` gives."""
    leaves = {k: v.detach().requires_grad_() for k, v in named_leaves(params).items()}
    loss = loss_fn(map_leaves(lambda path, _: leaves[path], params), cfg, batch,
                   **loss_kw)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """``optax.linear_schedule(init, end, steps)(count)`` in float32."""
    if steps <= 0:
        return np.float32(init)
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    B1, B2, EPS, weight_decay))``, inside ``optax.MultiSteps(every_k)``
    when ``every_k > 1``."""

    learning_rate: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 2000
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    every_k: int = 1

    def schedule(self, count: int) -> float:
        """Learning rate of the update after ``count`` updates: linear
        warm-up from 0, then linear decay to 0 at ``total_steps``."""
        w = self.warmup_steps
        if count < w:
            return float(_linear(0.0, self.learning_rate, w, count))
        return float(_linear(self.learning_rate, 0.0,
                             max(self.total_steps - w, 1), count - w))

    def init(self, params, shapes: Optional[Dict[str, Tuple[int, ...]]] = None
             ) -> OptState:
        """Zero moments like each leaf of ``params``, or of the shape
        ``shapes`` gives by leaf name (a ZeRO-1 slice)."""
        flat = named_leaves(params)
        shapes = shapes or {}

        def zeros():
            return {k: torch.zeros(shapes.get(k, v.shape), dtype=v.dtype, device=v.device)
                    for k, v in flat.items()}

        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc=zeros() if self.every_k > 1 else None)

    def clip(self, grads: List[torch.Tensor],
             global_sq: Optional[Callable] = None) -> None:
        """``optax.clip_by_global_norm`` in place.  The norm is optax's sum
        of each leaf's summed squares (``torch._foreach_norm`` strays by
        ~5e-6 relative on the CPU), the sums in float64: a mesh adds the same
        squares in another order (``global_sq(grads)`` gives the sum where
        ``grads`` are a rank's slices of the whole gradient), and in float64
        the order moves the norm by far less than a float32 step."""
        sq = (sum_squares(grads) if global_sq is None else global_sq(grads))
        norm = float(torch.sqrt(sq))
        if norm < self.max_grad_norm:
            return
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, self.max_grad_norm)

    def update(self, grads: Dict[str, torch.Tensor], state: OptState, params,
               global_sq: Optional[Callable] = None
               ) -> Optional[Dict[str, torch.Tensor]]:
        """The updates to add to ``params`` for these grads, and ``state``
        advanced; None while a micro-batch is accumulated.  ``grads`` may be
        overwritten.  ``params``: a tree, or a dict of tensors by leaf name
        in the moments' order; ``global_sq``: :meth:`clip`'s."""
        out: Dict[str, torch.Tensor] = {}
        if not self._step(grads, state, params, global_sq,
                          lambda names, ups, _: out.update(zip(names, ups))):
            return None
        return out

    def apply(self, grads: Dict[str, torch.Tensor], state: OptState, params,
              global_sq: Optional[Callable] = None) -> bool:
        """:meth:`update` added to ``params`` in place as each chunk of
        leaves is computed (``optax.apply_updates``), so no update outlives
        its chunk; False while a micro-batch is accumulated."""
        def add(names, ups, p):
            with torch.no_grad():
                torch._foreach_add_(p, ups)

        return self._step(grads, state, params, global_sq, add)

    def _step(self, grads, state: OptState, params, global_sq, sink) -> bool:
        """The transformation, elementwise over chunks of at most
        CHUNK_ELEMENTS (so its temporaries are a chunk's, not the params'
        size; the same bits as one pass); ``sink(names, updates, params)``
        takes each chunk's updates."""
        names = list(state.mu)
        chunks = _chunks([state.mu[k].numel() for k in names])
        if self.every_k > 1:
            n = state.mini_step
            for idx in chunks:
                g = [grads[names[i]] for i in idx]
                acc = [state.acc[names[i]] for i in idx]
                # optax's Welford mean: acc + (g - acc) / (n + 1)
                diff = torch._foreach_sub(g, acc)
                torch._foreach_div_(diff, float(n + 1))
                torch._foreach_add_(acc, diff)
            state.mini_step = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return False
            grads = state.acc  # the update reads the mean; it is zeroed once read
        self.clip([grads[k] for k in names], global_sq)
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        lr = self.schedule(state.count)
        leaves = named_leaves(params)
        for idx in chunks:
            keys = [names[i] for i in idx]
            g = [grads[k] for k in keys]
            mu = [state.mu[k] for k in keys]
            nu = [state.nu[k] for k in keys]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - B1))
            torch._foreach_mul_(nu, B2)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - B2)
            torch._foreach_add_(nu, g2)
            del g2
            if self.every_k > 1:
                torch._foreach_zero_(g)
            # mu_hat / (sqrt(nu_hat) + eps), + wd * p, times -lr
            updates = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(updates, den)
            del den
            p = [leaves[k].detach() for k in keys]
            if self.weight_decay:
                torch._foreach_add_(updates, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(updates, -lr)
            sink(keys, updates, p)
        state.count = count
        return True


def sum_squares(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every element's square, each leaf's summed in float64."""
    if not tensors:
        return torch.zeros((), dtype=torch.float64)
    return torch.stack([torch.sum(t * t, dtype=torch.float64) for t in tensors]).sum()


def _chunks(sizes: List[int]) -> List[List[int]]:
    """Consecutive index runs of at most CHUNK_ELEMENTS in all (a larger
    leaf alone)."""
    out: List[List[int]] = []
    total = 0
    for i, n in enumerate(sizes):
        if not out or total + n > CHUNK_ELEMENTS:
            out.append([])
            total = 0
        out[-1].append(i)
        total += n
    return out


def make_optimizer(learning_rate: float = 1e-5, warmup_steps: int = 500,
                   total_steps: int = 2000, weight_decay: float = 0.0,
                   max_grad_norm: float = 1.0) -> AdamW:
    """AdamW with linear warmup + linear decay (HF Trainer defaults;
    run.sh:17,24 lr 1e-5 warmup 500)."""
    return AdamW(learning_rate=learning_rate, warmup_steps=warmup_steps,
                 total_steps=total_steps, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm)


def apply_updates(params, updates: Dict[str, torch.Tensor]) -> None:
    """``optax.apply_updates`` in place: p + u."""
    flat = named_leaves(params)
    with torch.no_grad():
        torch._foreach_add_([flat[k] for k in updates], list(updates.values()))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def params_device(params) -> torch.device:
    return params["encoder"]["conv1_w"].device


def batch_to(batch: dict, device) -> dict:
    """A collated batch (numpy or tensors) as tensors on ``device``; token
    ids as int64."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        t = t.to(device)
        out[k] = t.long() if k in ("decoder_input_ids", "labels") else t
    return out


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The SpecAugment generator of one step, seeded from (seed, step): a
    resumed run draws the masks that the uninterrupted run drew (the JAX
    package folds the step into ``PRNGKey(seed)``)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    value = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=device).manual_seed(value)


def _sum_over(tensors: List[torch.Tensor], group) -> None:
    """All-reduce ``tensors`` in place over ``group``, packed into flat
    buffers of up to BUCKET_ELEMENTS (a call per leaf costs a round trip
    each)."""
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (size + t.numel() > BUCKET_ELEMENTS or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        flush()


def mesh_value_and_grad(state: TrainState, cfg: WhisperConfig, batch, **loss_kw
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The global batch's loss and the gradient of the rank's slices,
    summed over the data axes, from the rank's rows ``batch`` (tensors on
    the params' device): :func:`value_and_grad` on a mesh (collective)."""
    mesh = state.layout.mesh
    data_group = mesh.groups[DATA_AXES]
    count = (batch["labels"] != LABEL_PAD).sum().to(torch.float32)
    dist.all_reduce(count, group=data_group)
    with bind_axes(mesh.groups):
        loss, grads = value_and_grad(state.params, cfg, batch, token_count=count,
                                     **loss_kw)
    loss = loss.clone()
    dist.all_reduce(loss, group=data_group)
    for axis in ("data", "dcn_data"):  # within a slice, then across slices
        if mesh.shape.get(axis, 1) > 1:
            _sum_over(list(grads.values()), mesh.groups[axis])
    return loss, grads


def _mesh_update(state: TrainState, cfg: WhisperConfig, optimizer: AdamW, batch,
                 loss_kw) -> torch.Tensor:
    """One step on the rank's rows and slices (the module docstring's
    rules); returns the global batch's loss."""
    layout = state.layout
    mesh = layout.mesh
    loss, grads = mesh_value_and_grad(state, cfg, batch, **loss_kw)
    names = list(state.opt_state.mu)
    specs = {k: layout.data_spec(k) for k in names}
    leaves = named_leaves(state.params)
    owned = [layout.owns(k) for k in names]

    def global_sq(g: List[torch.Tensor]) -> torch.Tensor:
        sq = sum_squares([x for x, own in zip(g, owned) if own]).to(g[0].device)
        dist.all_reduce(sq)  # the mesh is the default group
        return sq

    # views: the update lands in the rank's part of each param slice
    slices = {k: slice_view(leaves[k].detach(), specs[k], mesh) for k in names}
    applied = optimizer.apply({k: slice_view(grads[k], specs[k], mesh) for k in names},
                              state.opt_state, slices, global_sq)
    del grads
    if applied:
        with torch.no_grad():
            for k in names:
                if any(specs[k]):
                    leaves[k].copy_(gather_leaf(slices[k], specs[k], mesh))
    return loss


def make_train_step(cfg: WhisperConfig, optimizer: AdamW, *, mesh=None,
                    remat: bool = False, freeze_encoder: bool = False,
                    spec_augment_cfg: Optional[SpecAugmentConfig] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    seed: int = 0) -> Callable:
    """The train step ``(state, batch) -> (state, loss)`` on the params'
    device: ``state`` is updated in place; ``loss`` is a device scalar
    (reading it waits for the step).  ``spec_augment_cfg`` enables
    input-feature masking (reference train_asr.py:139-144), keyed off the
    step counter.

    With ``mesh`` (every rank calls the step, with the same global batch
    and a state from ``init_train_state(..., mesh=mesh)``) the rank keeps
    its rows of the batch and its slices of the params; ``loss`` is the
    global batch's, on every rank."""
    if mesh is not None:
        require_group(mesh, "make_train_step")
    loss_kw = dict(remat=remat, freeze_encoder=freeze_encoder,
                   compute_dtype=compute_dtype)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        dev = params_device(state.params)
        rows = None
        if mesh is not None:
            if state.layout is None or state.layout.mesh is not mesh:
                raise ValueError("a mesh's train step needs the state of "
                                 "init_train_state(params, optimizer, mesh) on that mesh")
            batch, rows = shard_batch(batch, mesh)
        batch = batch_to(batch, dev)
        if spec_augment_cfg is not None:
            batch["mel"] = spec_augment(step_generator(seed, state.step, dev),
                                        batch["mel"], batch["num_frames"],
                                        spec_augment_cfg, rows=rows)
        if mesh is not None:
            loss = _mesh_update(state, cfg, optimizer, batch, loss_kw)
        else:
            loss, grads = value_and_grad(state.params, cfg, batch, **loss_kw)
            optimizer.apply(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss

    return train_step


def init_train_state(params, optimizer: AdamW, mesh=None, *, zero1: bool = True
                     ) -> TrainState:
    """The train state at step 0 (zero moments).  With ``mesh``, ``params``
    are the whole tree (every rank passes the same) and the state holds
    the rank's ``shard_params`` slice of it and, with ``zero1`` (JAX's
    ``init_train_state(mesh=)``), its ZeRO-1 slice of the moments; without
    it the moments are the param slices' whole (JAX's state initialised
    without the mesh)."""
    if mesh is None:
        return TrainState(step=0, params=params, opt_state=optimizer.init(params))
    require_group(mesh, "init_train_state")
    pspecs = leaf_specs(params, mesh)
    layout = MeshLayout(mesh=mesh, params=pspecs,
                        moments=moment_specs(params, mesh) if zero1 else pspecs)
    shapes = {k: slice_shape(v.shape, layout.moments[k], mesh)
              for k, v in named_leaves(params).items()}
    return TrainState(step=0, params=shard_params(params, mesh),
                      opt_state=optimizer.init(params, shapes), layout=layout)
