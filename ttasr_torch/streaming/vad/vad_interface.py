"""VAD plugin interface (reference vad/vad_interface.py)."""


class VADInterface:
    async def detect_activity(self, client):
        """Return a list of ``{"start": s, "end": s, "confidence": p}``
        segments (seconds) for the client's scratch buffer."""
        raise NotImplementedError
