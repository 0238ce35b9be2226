from ttasr_torch.streaming.buffering_strategy.buffering_strategy_factory import (
    BufferingStrategyFactory,
)
from ttasr_torch.streaming.buffering_strategy.buffering_strategies import SilenceAtEndOfChunk

__all__ = ["BufferingStrategyFactory", "SilenceAtEndOfChunk"]
