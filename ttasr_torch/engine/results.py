"""Transcription result types (port of ``ttasr/engine/results.py``).

Declared again because ``ttasr.engine`` imports jax in its package
``__init__``; ``tests/test_torch_config.py`` pins the fields and defaults
to the originals, and ``tests/test_torch_isolation.py`` the subtitle
writers (``format_srt_timestamp``, ``segments_to_srt``,
``segments_to_txt``), which the task API writes its TXT and SRT outputs
with.
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


def format_srt_timestamp(t: Optional[float]) -> str:
    """``hh:mm:ss,mmm`` with total-ms rounding."""
    if t is None or t < 0:
        t = 0.0
    total_ms = int(round(float(t) * 1000))
    hours, total_ms = divmod(total_ms, 3_600_000)
    minutes, total_ms = divmod(total_ms, 60_000)
    seconds, ms = divmod(total_ms, 1000)
    return f"{hours:02d}:{minutes:02d}:{seconds:02d},{ms:03d}"


def segments_to_srt(segments) -> str:
    """CRLF SRT text."""
    lines: List[str] = []
    for idx, seg in enumerate(segments, start=1):
        text_line = (
            (getattr(seg, "text", "") or "")
            .replace("\r", " ")
            .replace("\n", " ")
            .strip()
        )
        lines.append(f"{idx}\r\n")
        lines.append(
            f"{format_srt_timestamp(getattr(seg, 'start', 0.0))} --> "
            f"{format_srt_timestamp(getattr(seg, 'end', 0.0))}\r\n"
        )
        lines.append(f"{text_line}\r\n\r\n")
    return "".join(lines)


def segments_to_txt(segments) -> str:
    """Concatenated segment text."""
    return "".join(getattr(seg, "text", "") for seg in segments)
