"""Train the VAD conv net on the synthesized speech/noise corpus (the port of
``tools/train_vad.py``).

Usage:  python -m ttasr_torch.tools.train_vad [--steps 600] [--device cuda]
        [--out ttasr_torch/audio/data/vad_weights.npz]

Each step synthesizes ``--batch`` clips (``ttasr_torch/tools/synth.py``:
speech at a random SNR over a negative background, or a negative alone),
takes their log-mel frames on the device, and takes one Adam step
(``optax.adam``'s update, as the JAX tool runs it) on the frame-level
binary cross-entropy through autograd.  The held-out evaluation reports
the frame ROC AUC and, at threshold 0.5, the speech recall and each
negative family's false-positive rate.  ``--eval-only`` evaluates the
weights at ``--out``.  The device is ``cuda`` unless ``--device cpu``;
without a card the tool raises.  See ``ttasr_torch/audio/vad_model.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

from ttasr_torch.audio.vad_model import (
    SAMPLE_RATE,
    WINDOW,
    forward,
    init_vad_params,
    log_mel_frames,
    mel_filterbank,
)
from ttasr_torch.tools.synth import (
    _auc,
    _reverb,
    make_example,
    synth_babble,
    synth_negative,
    synth_speech,
    synth_vocal_music,
)

SR = SAMPLE_RATE
# the port's shipped weights, which vad_probabilities reads
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "audio", "data", "vad_weights.npz")
BCE_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate)``: moments ``(1 - b) g + b m``, bias
    correction by ``1 - b ** count``, then ``-lr * m / (sqrt(v) + eps)``
    (eps outside the root), in ``torch._foreach_*`` ops as
    ``ttasr_torch/train/train_step.py`` writes optax's chain."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, "torch.Tensor"]) -> dict:
        import torch

        return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: Dict[str, "torch.Tensor"], state: dict) -> Dict[str, "torch.Tensor"]:
        """The updates to add to the params; ``state`` is advanced."""
        import torch

        names = list(state["mu"])
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_add_(nu, g2)
        count = state["count"] + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        updates = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(updates, den)
        torch._foreach_mul_(updates, -self.learning_rate)
        state["count"] = count
        return dict(zip(names, updates))


def to_device(params: Dict[str, np.ndarray], device) -> Dict[str, "torch.Tensor"]:
    import torch

    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def bce_loss(params, mels, labels):
    """Mean frame binary cross-entropy of the speech probabilities of
    ``mels`` (B, T, N_MELS) against ``labels`` (B, T)."""
    import torch

    probs = forward(params, mels)
    bce = -(labels * torch.log(probs + BCE_EPS)
            + (1 - labels) * torch.log(1 - probs + BCE_EPS))
    return bce.mean()


def value_and_grad(params, mels, labels):
    """(loss, {name: grad}) of :func:`bce_loss` through autograd."""
    import torch

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = bce_loss(leaves, mels, labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params, opt: Adam, state: dict, mels, labels):
    """One Adam step in place on ``params``; returns the loss (a device
    scalar)."""
    import torch

    loss, grads = value_and_grad(params, mels, labels)
    updates = opt.update(grads, state)
    with torch.no_grad():
        torch._foreach_add_([params[k] for k in updates], list(updates.values()))
    return loss


def make_batch(rng, batch: int, seconds: float) -> Tuple[np.ndarray, np.ndarray]:
    """``batch`` examples of ``make_example``: audio (B, samples) float32
    and frame labels (B, frames)."""
    audio, labels = zip(*(make_example(rng, seconds) for _ in range(batch)))
    return np.stack(audio), np.stack(labels)


def batch_mels(audio: np.ndarray, fb, n_frames: int, device):
    """Log-mel frames (B, n_frames, N_MELS) of the batch, on ``device``."""
    import torch

    return log_mel_frames(torch.as_tensor(audio, device=device), fb)[:, :n_frames]


def train(steps: int, batch: int, seconds: float, lr: float, seed: int, device):
    """Trains from ``init_vad_params(seed)`` on batches drawn from
    ``np.random.default_rng(seed)``; returns (params on ``device``, the
    losses)."""
    import torch

    fb = mel_filterbank()
    n_frames = int(SR * seconds) // WINDOW
    rng = np.random.default_rng(seed)
    params = to_device(init_vad_params(seed), device)
    opt = Adam(lr)
    state = opt.init(params)
    losses = []
    for it in range(steps):
        audio, labels = make_batch(rng, batch, seconds)
        loss = train_step(params, opt, state, batch_mels(audio, fb, n_frames, device),
                          torch.as_tensor(labels[:, :n_frames], device=device))
        losses.append(loss)
        if (it + 1) % 50 == 0:
            print(f"step {it + 1}/{steps} loss {float(loss):.4f}", flush=True)
    return params, [float(x) for x in losses]


def evaluate(params, fb, seed, seconds=3.0, n_clips=60, device="cpu"):
    """Held-out ROC + per-category operating point at threshold 0.5.

    Categories: clean/noisy/reverberant speech (recall) and each
    negative family (false-positive rate).  ``params``: tensors on
    ``device``, where the log-mel and the forward run."""
    import torch

    n_frames = int(SR * seconds) // WINDOW

    def probs_of(audio):
        with torch.no_grad():
            mel = log_mel_frames(torch.as_tensor(audio, device=device), fb)[:n_frames]
            return forward(params, mel).cpu().numpy()

    rng = np.random.default_rng(seed + 1)
    all_labels, all_scores = [], []
    for _ in range(n_clips):
        audio, lab = make_example(rng, seconds)
        p = probs_of(audio)
        all_labels.append(lab[:n_frames])
        all_scores.append(p[: len(lab[:n_frames])])
    auc = _auc(np.concatenate(all_labels), np.concatenate(all_scores))

    cat_rng = np.random.default_rng(seed + 2)
    cats = {}
    # speech recall (active frames detected at 0.5), clean + reverberant
    for name, reverb in (("speech_clean", None), ("speech_reverb", 0.35)):
        hits = tot = 0
        for _ in range(20):
            sp, lab = synth_speech(cat_rng, seconds)
            if reverb:
                sp = _reverb(sp, cat_rng, rt60=reverb).astype(np.float32)
            p = probs_of(sp)
            lab = lab[:n_frames]
            hits += ((p[: len(lab)] > 0.5) & (lab > 0.5)).sum()
            tot += (lab > 0.5).sum()
        cats[name + "_recall"] = round(float(hits / max(tot, 1)), 3)
    # negative false-positive rate per family
    neg_fams = {
        "babble": lambda r: synth_babble(r, seconds),
        "vocal_music": lambda r: synth_vocal_music(r, seconds),
        "reverb_wash": lambda r: _reverb(
            synth_speech(r, seconds)[0], r, rt60=3.0).astype(np.float32),
        "noise_tones": lambda r: synth_negative(
            r, seconds, kind=int(r.integers(0, 6)))[0],
    }
    for name, gen in neg_fams.items():
        fp = tot = 0
        for _ in range(20):
            p = probs_of(gen(cat_rng))
            fp += (p > 0.5).sum()
            tot += len(p)
        cats[name + "_fp_rate"] = round(float(fp / max(tot, 1)), 3)
    out = {"frame_auc": round(auc, 4), **cats}
    print(json.dumps({"vad_eval": out}))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate the weights at --out, no training")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the net trains; cuda raises without a card")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ttasr_torch import resolve_device

    device = resolve_device(args.device)
    fb = mel_filterbank()
    if args.eval_only:
        with np.load(args.out) as z:
            params = to_device({k: z[k] for k in z.files}, device)
        evaluate(params, fb, args.seed, args.seconds, device=device)
        return
    params, _ = train(args.steps, args.batch, args.seconds, args.lr, args.seed, device)
    # held-out ROC + per-category operating point
    evaluate(params, fb, args.seed, args.seconds, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **{k: v.detach().cpu().numpy() for k, v in params.items()})
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
