"""SimpleVAD: treat all audio as speech (reference vad/simple_vad.py:22-45).

Returns one full-duration segment when the scratch buffer is at least
``min_duration`` seconds (default 0.1 s), else nothing.
"""

from __future__ import annotations

import logging

from ttasr_torch.streaming.vad.vad_interface import VADInterface

logger = logging.getLogger("ttasr_torch.streaming.vad")


class SimpleVAD(VADInterface):
    def __init__(self, **kwargs):
        self.min_duration = kwargs.get("min_duration", 0.1)
        logger.info("SimpleVAD initialized - assuming all audio is speech")

    async def detect_activity(self, client):
        if len(client.scratch_buffer) == 0:
            return []
        duration = len(client.scratch_buffer) / (
            client.sampling_rate * client.samples_width
        )
        if duration < self.min_duration:
            return []
        return [{"start": 0.0, "end": duration, "confidence": 1.0}]
