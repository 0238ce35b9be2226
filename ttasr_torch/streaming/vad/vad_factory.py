"""VAD factory (reference vad/vad_factory.py:13-44).

Extends the reference's factory (which only knew "simple"; its
PyannoteVAD plugin existed but was unreachable): "energy"/"learned"
resolve to :class:`EnergyVAD` (faster-whisper segment machinery over the
learned conv VAD), and "pyannote" to :class:`PyannoteVAD` — the
reference plugin's constructor surface and pyannote's hysteresis
binarization, with the local learned model as the segmentation net.
"""

import logging

from ttasr_torch.streaming.vad.energy_vad import EnergyVAD
from ttasr_torch.streaming.vad.pyannote_vad import PyannoteVAD
from ttasr_torch.streaming.vad.simple_vad import SimpleVAD

logger = logging.getLogger("ttasr_torch.streaming.vad")


class VADFactory:
    @staticmethod
    def create_vad_pipeline(type, **kwargs):
        logger.info("creating VAD pipeline: %s %s", type, kwargs)
        if type == "simple":
            return SimpleVAD(**kwargs)
        if type in ("energy", "learned"):
            return EnergyVAD(**kwargs)
        if type == "pyannote":
            return PyannoteVAD(**kwargs)
        raise ValueError(
            f"不支援的 VAD 管道類型: {type}。支援 'simple'、'energy'、"
            "'learned'、'pyannote'"
        )
