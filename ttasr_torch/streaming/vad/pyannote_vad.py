"""Pyannote-class VAD plugin (reference vad/pyannote_vad.py:17-62).

Same constructor surface as the reference's ``PyannoteVAD`` —
``model_name``, optional ``auth_token`` (ignored: the segmentation model
here is the in-repo learned conv VAD, no Hugging Face download), and
``pyannote_args`` with pyannote.audio's Binarize knobs — and the same
``detect_activity`` payload.  The segmentation itself reproduces
pyannote's hysteresis binarization over frame scores:

- a region OPENS when the score rises above ``onset``,
- it CLOSES when the score falls below ``offset`` (onset > offset gives
  hysteresis),
- active regions shorter than ``min_duration_on`` are dropped,
- gaps shorter than ``min_duration_off`` are filled.

Unlike the reference (which writes the scratch buffer to a temp WAV and
shells it through pyannote's file pipeline per chunk), scoring runs
in-memory on the PCM buffer.
"""

from __future__ import annotations

import logging

from ttasr_torch.audio.io import pcm16_bytes_to_float32
from ttasr_torch.streaming.vad.vad_interface import VADInterface

logger = logging.getLogger("ttasr_torch.streaming.vad")


def binarize(scores, frame_s: float, *, onset: float = 0.5,
             offset: float = 0.5, min_duration_on: float = 0.3,
             min_duration_off: float = 0.3):
    """pyannote.audio ``Binarize`` semantics over per-frame scores.

    Returns a list of ``(start_s, end_s)`` active regions.
    """
    regions = []
    active = False
    start = 0.0
    for i, s in enumerate(scores):
        t = i * frame_s
        if not active and s > onset:
            active = True
            start = t
        elif active and s < offset:
            active = False
            regions.append((start, t))
    if active:
        regions.append((start, len(scores) * frame_s))
    # fill short gaps first (pyannote merges before dropping short ons)
    if min_duration_off > 0 and regions:
        merged = [list(regions[0])]
        for s, e in regions[1:]:
            if s - merged[-1][1] < min_duration_off:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        regions = [tuple(r) for r in merged]
    if min_duration_on > 0:
        regions = [(s, e) for s, e in regions if e - s >= min_duration_on]
    return regions


class PyannoteVAD(VADInterface):
    def __init__(self, **kwargs):
        # accepted for drop-in compatibility; the model is local
        kwargs.get("model_name", "learned-conv-vad")
        kwargs.pop("auth_token", None)
        args = kwargs.get("pyannote_args", {})
        self.onset = float(args.get("onset", 0.5))
        self.offset = float(args.get("offset", 0.5))
        self.min_duration_on = float(args.get("min_duration_on", 0.3))
        self.min_duration_off = float(args.get("min_duration_off", 0.3))
        logger.info("PyannoteVAD(learned segmentation): onset=%.2f "
                    "offset=%.2f on>=%.2fs off<%.2fs", self.onset,
                    self.offset, self.min_duration_on, self.min_duration_off)

    async def detect_activity(self, client):
        import numpy as np

        from ttasr_torch.audio.vad import speech_probabilities
        from ttasr_torch.audio.vad_model import WINDOW

        if len(client.scratch_buffer) == 0:
            return []
        audio = pcm16_bytes_to_float32(bytes(client.scratch_buffer))
        if len(audio) < WINDOW:
            return []
        scores = np.asarray(speech_probabilities(audio))
        frame_s = WINDOW / client.sampling_rate
        regions = binarize(
            scores, frame_s, onset=self.onset, offset=self.offset,
            min_duration_on=self.min_duration_on,
            min_duration_off=self.min_duration_off,
        )
        return [{"start": s, "end": e, "confidence": 1.0}
                for s, e in regions]
