"""Process-group initialisation (port of ``ttasr/parallel/distributed.py::
initialize_distributed``).

One process per rank.  The group comes from torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``LOCAL_RANK`` for the card) or from explicit arguments; a single process
with neither is left alone.  The backend is NCCL, for ranks on distinct
cards, unless the caller asks for ``gloo``: the CPU tests, and two ranks
sharing one card (NCCL refuses two ranks on one device; ``gloo`` takes CUDA
tensors and stages them through the host).  The multislice mesh of the
JAX package is training's and is not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("ttasr_torch.parallel")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: str = "nccl") -> None:
    """Initialise the default process group.

    ``init_method`` (``tcp://host:port`` or ``file:///path``), ``world_size``
    and ``rank`` default to torchrun's variables (``env://`` when
    ``MASTER_ADDR`` is set).  No-op when a group is already up, and for a
    single process with no address given.  With NCCL each rank first takes
    its card: ``LOCAL_RANK``, else its rank modulo the visible cards.
    """
    if dist.is_initialized():
        return
    if world_size is None and os.getenv("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.getenv("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and os.getenv("MASTER_ADDR"):
        init_method = "env://"
    if init_method is None:
        if world_size not in (None, 1):
            raise ValueError(f"world_size={world_size} needs an init_method "
                             f"or MASTER_ADDR/MASTER_PORT")
        logger.info("single-process run; no process group")
        return
    if backend == "nccl":
        local = int(os.getenv("LOCAL_RANK", (rank or 0) % max(
            torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size if world_size is not None else 1,
                            rank=rank if rank is not None else 0)
    logger.info("torch.distributed up: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)
