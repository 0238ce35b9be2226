"""ASR plugin interface (reference asr/asr_interface.py)."""


class ASRInterface:
    async def transcribe(self, client):
        """Transcribe the client's scratch buffer.

        Returns ``{"language", "language_probability", "final", "text",
        "duration", "words": [...]}`` or None when nothing was recognized.
        """
        raise NotImplementedError

    def warm_up(self):
        """Optional: run a dummy transcription to trigger compilation."""
