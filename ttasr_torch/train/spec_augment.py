"""SpecAugment on log-mel input features (port of
``ttasr/train/spec_augment.py``).

Parity surface: reference train_asr.py:139-144 (``apply_spec_augment``
model arg) + :590-619 (attention-mask-guided time masking).  The
reference delegates to HF Whisper's ``_mask_input_features``:
time/feature spans are zeroed with per-row span counts drawn as
``floor(prob * valid_len / span_len + U[0,1))`` bounded below by
``min_masks`` — the SpecAugment policy of Park et al. 2019.  Defaults
match HF WhisperConfig (mask_time_prob 0.05, length 10, min 2;
mask_feature_prob 0.0, length 10, min 0).

The draws come from a ``torch.Generator`` (torch cannot reproduce
``jax.random``); the arithmetic after them is the JAX package's, split in
:func:`_spans` (counts and starts from the uniforms) and
:func:`_span_mask` (the membership test over a static bound of candidate
spans), so the same uniforms mask the same frames in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """SpecAugment policy; HF WhisperConfig defaults."""

    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0


def max_spans(axis_size: int, prob: float, span: int, min_masks: int) -> int:
    """The static bound of candidate spans per row."""
    return int(math.ceil(prob * axis_size / span)) + min_masks + 1


def _spans(u, s, valid_len, *, prob: float, span: int, min_masks: int):
    """Span counts ``n`` (B,) and starts (B, max_spans) from uniforms ``u``
    (B,) and ``s`` (B, max_spans): ``n = floor(prob * valid / span + u)``,
    at least ``min_masks``, at most what fits in the valid region; starts in
    ``[0, valid_len - span]``."""
    valid_len = valid_len.to(torch.int64)
    valid = torch.clamp(valid_len.to(torch.float32), min=1.0)
    n = torch.floor(prob * valid / span + u).to(torch.int64)
    n = torch.clamp(n, min=min_masks)
    n = torch.minimum(n, torch.clamp(valid_len // span, min=0))
    start_range = torch.clamp(valid_len - span + 1, min=1).to(torch.float32)
    starts = torch.floor(s * start_range[:, None]).to(torch.int64)
    return n, starts


def _span_mask(n, starts, axis_size: int, span: int):
    """(B, axis_size) bool: True where one of a row's first ``n`` spans
    covers."""
    active = torch.arange(starts.shape[1], device=starts.device)[None, :] < n[:, None]
    pos = torch.arange(axis_size, device=starts.device)
    within = (pos[None, None, :] >= starts[:, :, None]) & (
        pos[None, None, :] < (starts + span)[:, :, None])
    return torch.any(within & active[:, :, None], dim=1)


def _axis_masks(gen: torch.Generator, batch: int, axis_size: int, valid_len, *,
                prob: float, span: int, min_masks: int):
    """(batch, axis_size) bool — True where a masked span covers.

    ``valid_len`` (batch,) restricts spans to the real (unpadded) region,
    the role of the reference's forward_attention_mask
    (train_asr.py:590-594).
    """
    dev = valid_len.device
    u = torch.rand((batch,), generator=gen, device=dev)
    s = torch.rand((batch, max_spans(axis_size, prob, span, min_masks)),
                   generator=gen, device=dev)
    n, starts = _spans(u, s, valid_len, prob=prob, span=span, min_masks=min_masks)
    return _span_mask(n, starts, axis_size, span)


def spec_augment(gen: torch.Generator, mel, num_frames, cfg: SpecAugmentConfig):
    """Apply SpecAugment to ``mel`` (B, n_mels, T); masked spans -> 0.

    ``gen``: a generator on mel's device (the train step seeds one per step).
    ``num_frames`` (B,) int: valid mel frames per row (time masks stay
    inside real audio, matching the attention-mask-guided reference).
    Feature masks span the whole mel axis (always fully valid).
    """
    b, n_mels, t = mel.shape
    num_frames = torch.as_tensor(num_frames, device=mel.device)
    # HF gates purely on prob > 0 (_mask_input_features): prob == 0
    # disables the axis regardless of min_masks
    if cfg.mask_time_prob > 0.0:
        tmask = _axis_masks(
            gen, b, t, num_frames,
            prob=cfg.mask_time_prob, span=cfg.mask_time_length,
            min_masks=cfg.mask_time_min_masks,
        )
        mel = mel.masked_fill(tmask[:, None, :], 0.0)
    if cfg.mask_feature_prob > 0.0:
        fmask = _axis_masks(
            gen, b, n_mels, torch.full((b,), n_mels, device=mel.device),
            prob=cfg.mask_feature_prob, span=cfg.mask_feature_length,
            min_masks=cfg.mask_feature_min_masks,
        )
        mel = mel.masked_fill(fmask[:, :, None], 0.0)
    return mel
