"""Process-group initialisation and the multislice mesh (port of
``ttasr/parallel/distributed.py``).

One process per rank.  The group comes from torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``LOCAL_RANK`` for the card) or from explicit arguments; a single process
with neither is left alone.  The backend is NCCL, for ranks on distinct
cards, unless the caller asks for ``gloo``: the CPU tests, and two ranks
sharing one card (NCCL refuses two ranks on one device; ``gloo`` takes CUDA
tensors and stages them through the host).

:func:`create_multislice_mesh` lays the ranks out as ``(dcn_data, data,
model)``: on a TPU pod a slice is a set of chips joined by ICI, with DCN
between slices; on GPUs a slice is a host, its cards joined by NVLink, with
the network between hosts.  Only the outer ``dcn_data`` axis crosses
hosts, so the data-parallel gradient sum is the only traffic there.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ttasr_torch.parallel.sharding import Mesh, build_mesh

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


def create_multislice_mesh(model: int = 1, force_slices: Optional[int] = None) -> Mesh:
    """The ``(dcn_data, data, model)`` mesh over every rank of the default
    group, in JAX's device order (``np.asarray(devices).reshape(n_slices,
    per_slice // model, model)``).

    A slice is a host: its ranks are torchrun's ``LOCAL_WORLD_SIZE`` (the
    whole group when that is unset), so ``n_slices = WORLD_SIZE //
    LOCAL_WORLD_SIZE``.  ``force_slices`` overrides the count, as the JAX
    package's does for virtual devices, so a many-slice layout can be
    exercised on one host.  Raises where the JAX package raises: slices
    that do not divide the ranks, a model axis that does not divide a
    slice.  Collective, as :func:`~ttasr_torch.parallel.sharding.
    create_mesh`."""
    if not dist.is_initialized():
        raise RuntimeError("create_multislice_mesh needs a process group: call "
                           "initialize_distributed first (one process per rank, "
                           "e.g. under torchrun)")
    world = dist.get_world_size()
    if force_slices is not None:
        n_slices = int(force_slices)
        if world % n_slices != 0:
            raise ValueError(f"force_slices={n_slices} does not divide {world} devices")
    else:
        local = int(os.getenv("LOCAL_WORLD_SIZE", world))
        if world % local != 0:
            raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide {world} ranks")
        n_slices = world // local
    per_slice = world // n_slices
    if per_slice % model != 0:
        raise ValueError(f"model={model} does not divide {per_slice} devices/slice")
    return build_mesh({"dcn_data": n_slices, "data": per_slice // model, "model": model})

