"""Process-wide engine sharing (port of ``ttasr/engine/registry.py``).

Every caller with the same (model path, compute type, mesh, device) gets
the same ``WhisperEngine``: one weight set on the card, and (through
:func:`ttasr_torch.engine.serving.shared_server`) one continuous-batching
queue shared by the task API's uploads and the streaming chunks.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Tuple

from ttasr_torch import resolve_device

_ENGINES: Dict[Tuple, object] = {}
_LOCK = threading.Lock()


def get_engine(model_path_or_name: str, *, compute_type: str = "int8",
               mesh=None, device="cuda"):
    """Shared WhisperEngine per (resolved path, compute type, mesh, device).

    Runs on the card unless ``device="cpu"`` is asked for, and raises when
    CUDA is absent, as ``WhisperEngine`` does.  A meshed engine is never
    shared with an unmeshed one."""
    from ttasr_torch.engine.transcriber import WhisperEngine

    dev = resolve_device(device)
    resolved = (os.path.abspath(model_path_or_name)
                if os.path.isdir(model_path_or_name) else model_path_or_name)
    key = (resolved, compute_type, id(mesh) if mesh is not None else None,
           str(dev))
    with _LOCK:
        engine = _ENGINES.get(key)
        if engine is None:
            engine = WhisperEngine(model_path_or_name,
                                   compute_type=compute_type, mesh=mesh,
                                   device=dev)
            _ENGINES[key] = engine
        return engine


def reset_engines() -> None:
    """Drop cached engines (tests)."""
    with _LOCK:
        _ENGINES.clear()
