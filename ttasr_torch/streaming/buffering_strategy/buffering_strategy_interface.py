"""Strategy interface (reference buffering_strategy_interface.py)."""


class BufferingStrategyInterface:
    """Processes incoming audio buffers and schedules transcription."""

    def process_audio(self, websocket, vad_pipeline, asr_pipeline):
        raise NotImplementedError
