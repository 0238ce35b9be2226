"""Realtime streaming ASR engine (port of ``ttasr/streaming/``).

Parity surface: reference api/stt_streaming/src/ — same factory pattern
and strategy/VAD/ASR type names, same Client session state, same WS
payload shapes.  The ASR plugin (``torch_whisper``) feeds in-memory PCM
into the port's engine on the card (no per-chunk WAV round-trip like the
reference's faster_whisper_asr.py:155-157).
"""

from ttasr_torch.streaming.client import Client
from ttasr_torch.streaming.vad.vad_factory import VADFactory
from ttasr_torch.streaming.asr.asr_factory import ASRFactory
from ttasr_torch.streaming.buffering_strategy.buffering_strategy_factory import (
    BufferingStrategyFactory,
)

__all__ = ["Client", "VADFactory", "ASRFactory", "BufferingStrategyFactory"]
