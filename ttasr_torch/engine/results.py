"""Transcription result types (port of ``ttasr/engine/results.py``).

Declared again because ``ttasr.engine`` imports jax in its package
``__init__``; ``tests/test_torch_config.py`` pins the fields and defaults
to the originals.  The subtitle writers (``segments_to_srt``,
``segments_to_txt``) are not ported yet; the batch CLI does not use them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Word:
    start: float
    end: float
    word: str
    probability: float = 0.0


@dataclasses.dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: List[int]
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    temperature: float = 0.0
    words: Optional[List[Word]] = None


@dataclasses.dataclass
class TranscriptionInfo:
    language: str
    language_probability: float
    duration: float
    duration_after_vad: float
    all_language_probs: Optional[list] = None
