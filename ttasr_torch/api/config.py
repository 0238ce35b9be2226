"""ASR system configuration (port of ``ttasr/api/config.py``).

Two knobs, read as module attributes at call time by the task API's
``load_model`` and the streaming ASR plugin:
- ``MODEL_DEVICE``: "cuda" (the card; raises when absent) or "cpu"
- ``MODEL_COMPUTE_TYPE``: "bfloat16" / "float32" / "int8"
"""

import os

MODEL_DEVICE = os.getenv("TTASR_MODEL_DEVICE", "cuda")
# int8 = the fused-kernel fast path AND the task API's default, so both
# servers resolve to ONE shared engine (ttasr_torch.engine.registry)
MODEL_COMPUTE_TYPE = os.getenv("TTASR_MODEL_COMPUTE_TYPE", "int8")
