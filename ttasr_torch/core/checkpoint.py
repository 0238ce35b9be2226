"""Checkpoints with HF-Trainer-style auto-resume (port of
``ttasr/core/checkpoint.py``).

Checkpoints live at ``{output_dir}/checkpoint-{step}/`` like HF's layout;
``get_last_checkpoint`` and the ``keep``-newest cleanup are the JAX
package's.  Where the JAX package saves pytrees with orbax, the port saves
flat name -> tensor dicts with ``torch.save`` and reads them back with
``torch.load(..., weights_only=True)``: a train state's
(``TrainState.state_dict``) in ``checkpoint-N/state.pt``, bare params (the
final ``model/`` export) in ``params.pt``.  A save writes into a sibling
``.tmp`` directory and renames it, so a cut save leaves no
``checkpoint-N`` behind.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    """Latest ``checkpoint-N`` dir, or None (train_asr.py:374-392 parity)."""
    if not os.path.isdir(output_dir):
        return None
    best_step, best_path = -1, None
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            step = int(m.group(1))
            if step > best_step:
                best_step, best_path = step, os.path.join(output_dir, name)
    return best_path


def named_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of a nested dict/list tree by dotted path
    (``encoder.blocks.0.wq``), in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for key, value in items:
        out.update(named_leaves(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def map_leaves(fn, tree, prefix: str = ""):
    """A tree of the same structure with ``fn(path, leaf)`` at each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return [map_leaves(fn, v, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree)]


def copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
              what: str) -> None:
    """Copy ``src`` into the tensors of ``dst`` in place (device and dtype
    of ``dst``); the names and shapes must agree."""
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"{what}: names differ; missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, t in dst.items():
            if t.shape != src[name].shape:
                raise ValueError(f"{what}: {name} has shape {tuple(src[name].shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(src[name])


def _save(path: str, filename: str, flat: Dict[str, torch.Tensor]) -> str:
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, filename))
    shutil.rmtree(path, ignore_errors=True)  # orbax's force=True
    os.replace(tmp, path)
    return path


def _load(path: str, filename: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(os.path.abspath(path), filename),
                      map_location="cpu", weights_only=True)


def save_checkpoint(output_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Save a train state (its ``state_dict()``: params, optimizer state,
    step counters, accumulator; or such a flat dict itself) as
    ``checkpoint-{step}``."""
    flat = state if isinstance(state, dict) else state.state_dict()
    path = _save(os.path.join(output_dir, f"checkpoint-{step}"), STATE_FILE, flat)
    _cleanup_old(output_dir, keep)
    return path


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore a train state saved by :func:`save_checkpoint` into
    ``template`` (its ``load_state_dict``, in place); returns it."""
    template.load_state_dict(_load(path, STATE_FILE))
    return template


def save_params(path: str, params: Any) -> str:
    """Save bare params (final model export; HF ``save_model`` analogue)."""
    return _save(path, PARAMS_FILE, named_leaves(params))


def restore_params(path: str, template: Any = None) -> Any:
    """Params saved by :func:`save_params`: copied into ``template``'s
    tensors in place when given (and returned), else the flat name ->
    tensor dict on the CPU."""
    flat = _load(path, PARAMS_FILE)
    if template is None:
        return flat
    copy_into(named_leaves(template), flat, path)
    return template


def _cleanup_old(output_dir: str, keep: int) -> None:
    ckpts = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m:
            ckpts.append((int(m.group(1)), os.path.join(output_dir, name)))
    ckpts.sort()
    import shutil

    for _, path in ckpts[:-keep] if keep else []:
        shutil.rmtree(path, ignore_errors=True)
