"""Several processes, one rank each: the counterpart of
``kpop_tpu/parallel/distributed.py``.

The JAX package runs one SPMD job over ``jax.distributed``; the port runs
one process per rank over ``torch.distributed``.  :func:`initialize` joins
the process group from explicit coordinates or from the ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` that ``torchrun`` sets,
and does nothing in a single process given neither, as the JAX function
does.

The caller names the backend: ``nccl`` where each rank has a card of its
own, ``gloo`` on the CPU or where ranks share one card (NCCL refuses two
ranks on one card); without one, :func:`default_backend` tells these
cases apart.  Nothing switches backend when one fails: a failure to join
raises.  Under gloo only ``broadcast`` and ``all_reduce`` take CUDA
tensors, so the port gathers through host tensors
(:class:`~.mesh.Layout`'s ``*_host`` groups).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: the environment ``torchrun`` sets for each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend() -> str:
    """``gloo`` on the CPU (``KPOP_PLATFORM=cpu``) or where this machine's
    ranks (``torchrun``'s ``LOCAL_WORLD_SIZE``, 1 without it) outnumber the
    cards it sees, so that ranks share a card; else ``nccl``."""
    if os.environ.get("KPOP_PLATFORM") == "cpu":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def initialize(
    address: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group if running multi-process; returns whether
    this call joined it.

    ``address`` is a ``tcp://host:port`` of rank 0 with ``world_size`` and
    ``rank``; without them, the ``torchrun`` environment
    (:data:`TORCHRUN_ENV`).  No-op in a single process with neither, and
    when the group is already joined.  ``backend`` defaults to
    :func:`default_backend`."""
    if dist.is_initialized():
        return False
    from_env = all(os.environ.get(v) for v in TORCHRUN_ENV)
    if address is None and world_size is None and not from_env:
        return False
    if address is None and not from_env:
        raise ValueError("initialize: world_size without an address (or the torchrun environment)")
    kwargs = dict(backend=backend or default_backend())
    if address is not None:
        if world_size is None or rank is None:
            raise ValueError("initialize: an address needs world_size and rank")
        kwargs.update(init_method=address, world_size=int(world_size), rank=int(rank))
    dist.init_process_group(**kwargs)
    return True


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def shutdown() -> None:
    """Leave the process group, if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
