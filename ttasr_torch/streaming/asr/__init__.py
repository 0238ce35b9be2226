from ttasr_torch.streaming.asr.asr_factory import ASRFactory
from ttasr_torch.streaming.asr.torch_whisper_asr import TorchWhisperASR

__all__ = ["ASRFactory", "TorchWhisperASR"]
