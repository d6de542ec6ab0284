"""Multi-process initialization on torch.distributed (port of
grackle_tpu/parallel/distributed.py).

The reference's multi-node story is "each MPI rank links the library and
calls it on its own subgrid" (grackle: src/clib/grackle.h:56-60).  Here
each process is one rank of a ``torch.distributed`` group and solves its
own cells on its own devices (``global_cell_mesh``); the solve has no
collective, so the group carries only what the caller reduces or gathers
around it.  Nothing in a machine announces a cluster: the caller gives the
group's address, size and this process's rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..api import resolve_device
from .sharding import make_cell_mesh


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           backend=None, device="cuda"):
    """Join a ``torch.distributed`` group; returns (world_size, rank).

    A no-op returning (1, 0) for a single process (no ``init_method`` and
    a world of one), and the group's size and rank when one is already
    initialized.  Otherwise ``init_method`` (e.g. ``tcp://host:port``),
    ``world_size`` and ``rank`` are required.  The backend is ``nccl``
    on a CUDA ``device`` (which is made this process's current card,
    ``rank`` modulo the visible cards) and ``gloo`` for ``device="cpu"``,
    unless ``backend`` names another.  Asking for CUDA on a machine
    without a card raises, as every entry point does.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if init_method is None and world_size in (None, 1):
        return 1, 0
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a multi-process group needs init_method, "
                         "world_size and rank")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_world_size(), dist.get_rank()


def global_cell_mesh():
    """The devices this process solves on: its own card in an NCCL group,
    the CPU in a gloo group, every visible card without a group (as
    ``sharding.make_cell_mesh``)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cpu")]
    return make_cell_mesh()
