"""ASR factory (reference asr/asr_factory.py:9-30; port of
``ttasr/streaming/asr/asr_factory.py``).

Keeps the reference's "faster_whisper" and "whisper" type names as
aliases for the port's engine, so existing launch configs keep working.
"""

import logging

from ttasr_torch.streaming.asr.torch_whisper_asr import TorchWhisperASR

logger = logging.getLogger("ttasr_torch.streaming.asr")


class ASRFactory:
    @staticmethod
    def create_asr_pipeline(type, **kwargs):
        logger.info("creating ASR pipeline: %s %s", type, kwargs)
        if type in ("torch_whisper", "faster_whisper", "whisper"):
            return TorchWhisperASR(**kwargs)
        raise ValueError(
            f"不支援的 ASR 管道類型: {type}。支援 'torch_whisper'（別名 'faster_whisper'）"
        )
