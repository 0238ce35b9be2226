"""Factory (reference buffering_strategy_factory.py:17-42)."""

from ttasr_torch.streaming.buffering_strategy.buffering_strategies import SilenceAtEndOfChunk


class BufferingStrategyFactory:
    @staticmethod
    def create_buffering_strategy(type, client, **kwargs):
        if type == "silence_at_end_of_chunk":
            return SilenceAtEndOfChunk(client, **kwargs)
        raise ValueError(f"Unknown buffering strategy type: {type}")
