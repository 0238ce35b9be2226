"""ttasr_torch: the PyTorch + CUDA port of ttasr for NVIDIA Hopper.

Mirrors ``ttasr/``'s layout and names (``models/whisper``, ``ops``,
``engine``, ``cli``) so each module's counterpart is easy to find.  The
JAX package stays the reference; this package never imports jax.

The device is explicit everywhere: ``resolve_device("cuda")`` raises when
no card is present instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent.  On CUDA it also turns TF32 off for float32 matmuls and convs
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` = False), so float32 means float32
    as in the JAX reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               f"available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
