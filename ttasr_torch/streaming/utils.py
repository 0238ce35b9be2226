"""Streaming utilities (reference api/stt_streaming/src/utils.py).

SRT formatting, transcript-file conversion, dated folder layout, result
format adapters.  Hallucination filtering and language codes live in
:mod:`ttasr_torch.text.filters` and are re-exported here for API parity.
"""

from __future__ import annotations

import ast
import json
import logging
import os
from datetime import datetime
from typing import List, Optional

from ttasr_torch.text.filters import IGNORE_TEXT as ignore_text  # noqa: N816
from ttasr_torch.text.filters import filter_segments, filter_text, language_codes

__all__ = [
    "srt_format_timestamp", "list_to_srt_text", "list_to_plain_text",
    "convert_transcript_to_subtitles", "create_today_folders", "create_folders",
    "transfer_streaming_format", "transfer_offline_format",
    "filter_text", "filter_offline_segments", "ignore_text", "language_codes",
]


def srt_format_timestamp(seconds: float) -> str:
    """``h:mm:ss,mmm`` (reference utils.py:8-21 — note the unpadded hour)."""
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)
    hours, milliseconds = divmod(milliseconds, 3_600_000)
    minutes, milliseconds = divmod(milliseconds, 60_000)
    secs, milliseconds = divmod(milliseconds, 1_000)
    return f"{hours}:{minutes:02d}:{secs:02d},{milliseconds:03d}"


def list_to_srt_text(subtitles: List[dict]) -> str:
    """Subtitle dicts (startTime/endTime/text) -> SRT (reference utils.py:24-41)."""
    parts = []
    for counter, subtitle in enumerate(subtitles, start=1):
        parts.append(f"{counter}\n")
        parts.append(
            f"{srt_format_timestamp(subtitle['startTime'])} --> "
            f"{srt_format_timestamp(subtitle['endTime'])}\n"
        )
        parts.append(f"{subtitle['text']}\n\n")
    return "".join(parts)


def list_to_plain_text(subtitles: List[dict]) -> str:
    return "".join(f"{s['text']}\n" for s in subtitles)


def convert_transcript_to_subtitles(input_file: str):
    """Transcript file (python/json list literal) -> .srt + .txt next to it
    (reference utils.py:54-78). Returns (duration, srt_path, txt_path)."""
    logging.info("convert_transcript_to_subtitles: %s", input_file)
    if not os.path.exists(input_file):
        raise Exception("result is empty")
    with open(input_file, encoding="utf-8") as fh:
        raw = fh.read()
    try:
        subtitles = json.loads(raw)
    except json.JSONDecodeError:
        subtitles = ast.literal_eval(raw)
    output_srt_path = os.path.splitext(input_file)[0] + ".srt"
    output_txt_path = os.path.splitext(input_file)[0] + ".txt"
    with open(output_srt_path, "w", encoding="utf-8") as fh:
        fh.write(list_to_srt_text(subtitles))
    with open(output_txt_path, "w", encoding="utf-8") as fh:
        fh.write(list_to_plain_text(subtitles))
    return subtitles[-1]["endTime"], output_srt_path, output_txt_path


def create_folders(folder_path: str) -> None:
    os.makedirs(folder_path, exist_ok=True)


def create_today_folders(directory: str, job_id: str) -> str:
    """``dir/YYYY/M/D/job_id`` layout (reference utils.py:81-95)."""
    now = datetime.now()
    folder_path = os.path.join(
        directory, str(now.year), str(now.month), str(now.day), job_id
    )
    create_folders(folder_path)
    return folder_path


def transfer_streaming_format(items: Optional[List[dict]]) -> Optional[List[dict]]:
    """Streaming result dicts -> common subtitle format (reference utils.py:98-110)."""
    if not items:
        return None
    return [
        {
            "startTime": seg["startTime"],
            "endTime": seg["endTime"],
            "text": seg["text"],
            "final": True,
        }
        for seg in items
    ]


def transfer_offline_format(data: Optional[dict]) -> Optional[List[dict]]:
    """Offline whisper-style result -> common format (reference utils.py:113-129)."""
    if not data:
        return None
    segments = filter_offline_segments(data["segments"])
    return [
        {
            "startTime": seg["start"],
            "endTime": seg["end"],
            "text": seg["text"],
            "final": True,
        }
        for seg in segments
    ]


def filter_offline_segments(segments: List[dict]) -> List[dict]:
    """Drop hallucinated segments (reference utils.py:161-171, with its
    membership-test bug fixed — delegated to text.filters)."""
    return filter_segments(segments)
