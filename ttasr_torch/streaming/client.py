"""Per-connection session state.

Attribute-compatible with the reference's Client
(api/stt_streaming/src/client.py): three audio buffers (incoming /
scratch-under-transcription / whole-session), per-client config with the
1.5 s chunk + 0.1 s offset defaults, sample bookkeeping, and transcript
accumulation. The buffering strategy is rebuilt whenever the config
changes.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional

from ttasr_torch.streaming.buffering_strategy.buffering_strategy_factory import (
    BufferingStrategyFactory,
)

_DEFAULT_CONFIG = {
    "language": None,
    "processing_strategy": "silence_at_end_of_chunk",
    "processing_args": {
        "chunk_length_seconds": 1.5,
        "chunk_offset_seconds": 0.1,
    },
}


class Client:
    """State for one streaming connection."""

    def __init__(self, client_id, sampling_rate: int, samples_width: int,
                 job_id: str, last_start_time: float,
                 transcript: Optional[List] = None):
        self.client_id = client_id
        self.sampling_rate = sampling_rate
        self.samples_width = samples_width
        self.job_id = job_id
        self.last_start_time = last_start_time
        self.transcript = [] if transcript is None else transcript

        self.buffer = bytearray()
        self.scratch_buffer = bytearray()
        self.session_audio_buffer = bytearray()

        self.total_samples = 0
        self.file_counter = 0
        self.chunk_save_counter = 0
        self.connect_time = None
        self.start_time = time.time()

        self.config = copy.deepcopy(_DEFAULT_CONFIG)
        self._rebuild_strategy()

    def _rebuild_strategy(self) -> None:
        self.buffering_strategy = BufferingStrategyFactory.create_buffering_strategy(
            self.config["processing_strategy"],
            self,
            **self.config["processing_args"],
        )

    def update_config(self, config_data: dict) -> None:
        """Merge config (e.g. from a WS ``{"type":"config"}`` message) and
        rebuild the buffering strategy."""
        self.config.update(config_data)
        self._rebuild_strategy()

    # -- audio ingestion -------------------------------------------------

    def append_audio_data(self, audio_data: bytes) -> None:
        self.buffer.extend(audio_data)
        self.session_audio_buffer.extend(audio_data)
        self.total_samples += len(audio_data) / self.samples_width

    def clear_buffer(self) -> None:
        self.buffer.clear()

    def process_audio(self, websocket, vad_pipeline, asr_pipeline) -> None:
        self.buffering_strategy.process_audio(websocket, vad_pipeline, asr_pipeline)

    # -- bookkeeping / file naming ----------------------------------------

    def increment_file_counter(self) -> None:
        self.file_counter += 1

    def increment_chunk_save_counter(self) -> None:
        self.chunk_save_counter += 1

    def get_file_name(self) -> str:
        return f"{self.client_id}_{self.file_counter}.wav"

    def get_chunk_file_name(self) -> str:
        return f"{self.client_id}_chunk_{self.chunk_save_counter:06d}.wav"

    def get_session_file_name(self) -> str:
        return f"{self.client_id}_{self.job_id}.wav"
