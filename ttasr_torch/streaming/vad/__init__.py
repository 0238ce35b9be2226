from ttasr_torch.streaming.vad.vad_factory import VADFactory
from ttasr_torch.streaming.vad.simple_vad import SimpleVAD
from ttasr_torch.streaming.vad.energy_vad import EnergyVAD

__all__ = ["VADFactory", "SimpleVAD", "EnergyVAD"]
