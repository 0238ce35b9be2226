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
and returns it.  There is no mesh: data parallelism and ZeRO-1 are
ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ttasr_torch.core.checkpoint import copy_into, map_leaves, named_leaves
from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.model import decode_train, encode
from ttasr_torch.train.spec_augment import SpecAugmentConfig, spec_augment

LABEL_PAD = -100
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's, as the JAX package sets them
NO_MESH = ("the port has no mesh for training yet: data parallelism and ZeRO-1 "
           "are ROADMAP A12")


def refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(NO_MESH)


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


@dataclasses.dataclass
class TrainState:
    step: int  # micro-steps taken
    params: Any
    opt_state: OptState

    _COUNTERS = ("step", "count", "mini_step")

    def _counter(self, name: str) -> int:
        return self.step if name == "step" else getattr(self.opt_state, name)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Flat name -> tensor: ``params/``, ``mu/``, ``nu/`` (and ``acc/``)
        leaves and the counters as int64 scalars."""
        out = {name: torch.tensor(self._counter(name), dtype=torch.int64)
               for name in self._COUNTERS}
        opt = self.opt_state
        for group, flat in (("params", named_leaves(self.params)), ("mu", opt.mu),
                            ("nu", opt.nu), ("acc", opt.acc or {})):
            out.update({f"{group}/{k}": v for k, v in flat.items()})
        return out

    def load_state_dict(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy a :meth:`state_dict` into this state's tensors in place."""
        mine = self.state_dict()
        tensors = {k: v for k, v in mine.items() if k not in self._COUNTERS}
        copy_into(tensors, {k: v for k, v in flat.items() if k not in self._COUNTERS},
                  "train state")
        # state_dict's leaves are this state's own tensors, so the copy landed
        self.step = int(flat["step"])
        for name in self._COUNTERS[1:]:
            setattr(self.opt_state, name, int(flat[name]))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, targets, label_pad: int = LABEL_PAD):
    """Masked token-mean cross entropy. logits (B,T,V), targets (B,T);
    0 on a batch that is all pad (``F.cross_entropy``'s mean gives NaN)."""
    mask = (targets != label_pad).to(torch.float32)
    safe_targets = torch.where(targets == label_pad, 0, targets)
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    token_ll = torch.gather(logprobs, -1, safe_targets[..., None].long())[..., 0]
    total = torch.sum(mask)
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
            freeze_encoder: bool = False, compute_dtype=None):
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
    return cross_entropy_loss(logits, batch["labels"])


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

    def init(self, params) -> OptState:
        flat = named_leaves(params)

        def zeros():
            return {k: torch.zeros_like(v) for k, v in flat.items()}

        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc=zeros() if self.every_k > 1 else None)

    def clip(self, grads: List[torch.Tensor]) -> None:
        """``optax.clip_by_global_norm`` in place.  The norm is optax's sum
        of each leaf's summed squares (``torch._foreach_norm`` strays by
        ~5e-6 relative on the CPU)."""
        norm = float(torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum()))
        if norm < self.max_grad_norm:
            return
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, self.max_grad_norm)

    def update(self, grads: Dict[str, torch.Tensor], state: OptState, params
               ) -> Optional[Dict[str, torch.Tensor]]:
        """The updates to add to ``params`` for these grads, and ``state``
        advanced; None while a micro-batch is accumulated.  ``grads`` may be
        overwritten."""
        names = list(state.mu)
        g = [grads[k] for k in names]
        if self.every_k > 1:
            acc = [state.acc[k] for k in names]
            n = state.mini_step
            # optax's Welford mean: acc + (g - acc) / (n + 1)
            diff = torch._foreach_sub(g, acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(acc, diff)
            del diff
            state.mini_step = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return None
            g = acc  # the update reads the mean; it is zeroed once read
        self.clip(g)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
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
        del g
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        # mu_hat / (sqrt(nu_hat) + eps), + wd * p, times -lr
        updates = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(updates, den)
        del den
        p = [t.detach() for t in named_leaves(params).values()]
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(state.count))
        state.count = count
        return dict(zip(names, updates))


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


def make_train_step(cfg: WhisperConfig, optimizer: AdamW, *, mesh=None,
                    remat: bool = False, freeze_encoder: bool = False,
                    spec_augment_cfg: Optional[SpecAugmentConfig] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    seed: int = 0) -> Callable:
    """The train step ``(state, batch) -> (state, loss)`` on the params'
    device: ``state`` is updated in place; ``loss`` is a device scalar
    (reading it waits for the step).  ``spec_augment_cfg`` enables
    input-feature masking (reference train_asr.py:139-144), keyed off the
    step counter.  ``mesh`` raises: ROADMAP A12."""
    refuse_mesh(mesh)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        dev = params_device(state.params)
        batch = batch_to(batch, dev)
        if spec_augment_cfg is not None:
            batch["mel"] = spec_augment(step_generator(seed, state.step, dev),
                                        batch["mel"], batch["num_frames"],
                                        spec_augment_cfg)
        loss, grads = value_and_grad(state.params, cfg, batch, remat=remat,
                                     freeze_encoder=freeze_encoder,
                                     compute_dtype=compute_dtype)
        updates = optimizer.update(grads, state.opt_state, state.params)
        del grads
        if updates is not None:
            apply_updates(state.params, updates)
        state.step += 1
        return state, loss

    return train_step


def init_train_state(params, optimizer: AdamW, mesh=None) -> TrainState:
    """The train state at step 0 (zero moments).  ``mesh`` raises: ZeRO-1
    is ROADMAP A12."""
    refuse_mesh(mesh)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))
