"""The ``(data, kmer)`` rank layout: the counterpart of
``kpop_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with two
axes, ``"data"`` (query batches) and ``"kmer"`` (the vocabulary's rows),
and lets XLA insert the collectives.  The port runs one process per rank,
so :func:`make_mesh` returns a :class:`Layout`: the same two axes over the
ranks of the process group, with the process groups for the
collectives that the port writes out (``all_reduce`` of a ``[B, d]``
projection over ``"kmer"``, gathers of a batch's rows over ``"data"``).

Rank ``r`` sits at ``(r // kp, r % kp)``, where the JAX ``reshape(dp, n //
dp)`` places device ``r``.  Under gloo only ``broadcast`` and
``all_reduce`` take CUDA tensors, so every gather goes through host
tensors, over the ``*_host`` groups: gloo groups under either backend.

The JAX module's ``device_canonical`` is not ported: it works around the
JAX x64 round trip (a float64 host array truncated to float32 on its way
through a cross-process ``device_put``), which has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
KMER_AXIS = "kmer"


def split_rows(n: int, parts: int, i: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of part ``i`` of ``n`` rows in ``parts`` parts of
    ``ceil(n / parts)`` (the last ones short or empty): the shards of
    ``pad_to_multiple`` and a sharded axis in the JAX package."""
    per = -(-n // parts)
    lo = min(n, i * per)
    return lo, min(n, lo + per)


@dataclasses.dataclass
class Layout:
    """``dp x kp`` ranks; this one at (``data_index``, ``kmer_index``).

    ``kmer_group`` holds the ``kp`` ranks of this rank's data index (the
    twister's shards; the all-reduce of their products), for device
    tensors.  ``data_host`` holds the ``dp`` ranks of its kmer index and
    ``world_host`` all of them, for host tensors (gloo): the gathers of a
    batch's rows, of the Grams, of phi.  Every group is None without a
    process group."""

    dp: int
    kp: int
    rank: int = 0
    kmer_group: object = None
    data_host: object = None
    world_host: object = None

    @property
    def world(self) -> int:
        return self.dp * self.kp

    @property
    def data_index(self) -> int:
        return self.rank // self.kp

    @property
    def kmer_index(self) -> int:
        return self.rank % self.kp

    @property
    def world_group(self):
        """All the ranks, for device tensors (the default group); None
        without a process group."""
        return dist.group.WORLD if self.world > 1 and dist.is_initialized() else None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, KMER_AXIS: self.kp}

    def rows(self, n: int, over: str = "all") -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of ``n`` split over all ranks (the
        JAX ``P((DATA_AXIS, KMER_AXIS))``), over ``"kmer"`` or over
        ``"data"``."""
        if over == "all":
            return split_rows(n, self.world, self.rank)
        if over == KMER_AXIS:
            return split_rows(n, self.kp, self.kmer_index)
        if over == DATA_AXIS:
            return split_rows(n, self.dp, self.data_index)
        raise ValueError(f"unknown axis {over!r}")


def make_mesh(n_devices: int | None = None, data_parallel: int | None = None) -> Layout:
    """The ``(data, kmer)`` layout of the process group's ranks (one rank
    without a group).

    ``data_parallel`` fixes the size of the data axis; by default the ranks
    are split as the JAX ``make_mesh`` splits devices, the kmer axis at
    least as large.  ``n_devices``, when given, must be the world size: a
    rank cannot leave the group's collectives."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: {n_devices} ranks asked, the process group has {n}")
    if data_parallel is None:
        dp = 1
        while dp * dp * 2 <= n and n % (dp * 2) == 0:
            dp *= 2
    else:
        dp = data_parallel
    if dp < 1 or n % dp != 0:
        raise ValueError(f"{n} ranks not divisible by data_parallel={dp}")
    kp = n // dp
    if not dist.is_initialized():
        return Layout(dp=1, kp=1)
    # groups even of one rank: a process group of one still runs its
    # collectives (NCCL's all-reduce at world size 1)
    host = None if dist.get_backend() == "gloo" else "gloo"

    def mine(rank_lists, backend=None):
        """Every rank creates every group, in the same order; returns this
        rank's."""
        out = None
        for ranks in rank_lists:
            g = dist.new_group(ranks, backend=backend)
            if dist.get_rank() in ranks:
                out = g
        return out

    return Layout(
        dp=dp, kp=kp, rank=dist.get_rank(),
        kmer_group=mine([list(range(g * kp, (g + 1) * kp)) for g in range(dp)]),
        data_host=mine([list(range(j, n, kp)) for j in range(kp)], host),
        world_host=dist.group.WORLD if host is None else mine([list(range(n))], host),
    )


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing without one); returns
    ``t``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's tensor, in the group's rank order, on every rank of the
    host ``group``: tensors of the same trailing shape whose first dims may
    differ.  Goes through host tensors (gloo gathers no CUDA tensor);
    returns host tensors.  ``[t]`` without a group."""
    t = t.detach().cpu().contiguous()
    if group is None or dist.get_world_size(group) == 1:
        return [t]
    n = dist.get_world_size(group)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([t.shape[0]], dtype=torch.int64), group=group)
    sizes = [int(s) for s in sizes]
    most = max(sizes)
    padded = torch.zeros((most,) + tuple(t.shape[1:]), dtype=t.dtype)
    padded[: t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    return [p[:s] for p, s in zip(parts, sizes)]


def broadcast_host(t: torch.Tensor | None, src: int, group, shape, dtype) -> torch.Tensor:
    """Global rank ``src``'s host tensor ``t`` (of ``shape`` and ``dtype``)
    on every rank of the host ``group``; ``t`` is only read on ``src``."""
    buf = t.detach().cpu().contiguous() if dist.get_rank() == src else torch.empty(shape, dtype=dtype)
    dist.broadcast(buf, src=src, group=group)
    return buf


@dataclasses.dataclass
class ShardedRows:
    """The rows ``[row0, row0 + local.shape[0])`` of a ``[total, ...]``
    array, held by one rank: what a ``jax.Array`` sharded over its first
    axis is to one process."""

    local: torch.Tensor
    row0: int
    total: int

    @property
    def rows(self) -> tuple[int, int]:
        return self.row0, self.row0 + self.local.shape[0]

    def gather(self, group) -> torch.Tensor:
        """The whole ``[total, ...]`` array on every rank of the host
        ``group``, whose ranks' rows, in rank order, must tile it (a host
        tensor)."""
        parts = all_gather_rows(self.local, group)
        out = torch.cat(parts) if len(parts) > 1 else parts[0]
        if out.shape[0] != self.total:
            raise ValueError(f"the ranks' rows make {out.shape[0]} of {self.total}")
        return out


def pad_to_multiple(x, axis: int, multiple: int, fill=0):
    """Pad an array so dim ``axis`` is divisible by ``multiple`` (the
    shards of an axis are of equal size); returns the array and the size
    before padding."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return np.pad(x, pads, constant_values=fill), size
