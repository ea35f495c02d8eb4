"""Sharded checkpoints: the counterpart of ``kpop_tpu/parallel/checkpoint.py``.

The reference's binary register dumps are its checkpoints (SURVEY.md §5;
lib/KMerDB.ml:389-430).  A sharded array is written as one file a rank,
``<prefix>.shard<rank>.kpopckpt``, whose frames are its shards, each named
``shard:<start coordinates>``, and a metadata file ``<prefix>.kpopckpt``
that rank 0 writes (shape, dtype, number of shard files), over the port's
own :mod:`..io.framed`.  The file format is the JAX package's own: a
checkpoint written by either package loads in the other.  A load onto
another rank layout reassembles the rows it needs from the frames that
hold them, reading only those bytes (``np.memmap``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..io import framed
from . import distributed
from .mesh import Layout, ShardedRows

TAG = "KPopShardedArray"


def save_sharded(path_prefix: str, arr) -> None:
    """Write this rank's part of ``arr``: the rows of a
    :class:`~.mesh.ShardedRows` as one frame at their first row, or a whole
    array (a tensor or numpy array the same on every rank) as one frame
    that rank 0 writes.  Rank 0 also writes the metadata and removes the
    shard files of an earlier save of the prefix from more ranks; every
    rank waits for the others before it returns."""
    rank, world = distributed.rank(), distributed.world_size()
    if isinstance(arr, ShardedRows):
        local = _numpy(arr.local)
        shape = (arr.total,) + local.shape[1:]
        frames = [((arr.row0,) + (0,) * (local.ndim - 1), local)]
    else:
        local = _numpy(arr)
        shape = local.shape
        frames = [((0,) * local.ndim, local)] if rank == 0 else []
    with open(path_prefix + f".shard{rank}.kpopckpt", "wb") as f:
        framed.write_header(f, TAG, {"process": rank})
        for start, data in frames:
            framed.write_array(f, "shard:" + ",".join(map(str, start)), data)
        framed.write_terminator(f)
    if rank == 0:
        with open(path_prefix + ".kpopckpt", "wb") as f:
            framed.write_header(f, TAG + "Meta", {
                "shape": list(shape), "dtype": local.dtype.str, "processes": world,
            })
            framed.write_terminator(f)
        # a re-save from fewer ranks must not leave higher shard files: the
        # loader reads only the metadata's count, but they would mislead
        stale = world
        while os.path.exists(path_prefix + f".shard{stale}.kpopckpt"):
            os.remove(path_prefix + f".shard{stale}.kpopckpt")
            stale += 1
    if world > 1:
        dist.barrier()


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_sharded(path_prefix: str, mesh: Layout | None = None, over: str | None = "all",
                 device=None):
    """This rank's rows of a checkpoint, written from any number of ranks
    or JAX processes: the rows of ``mesh.rows(shape[0], over)`` as a
    :class:`~.mesh.ShardedRows` of a tensor on ``device`` (the host by
    default), or with ``over=None`` (or no mesh) the whole array.  Only the
    frames that intersect the rows are read; a row not covered raises."""
    with open(path_prefix + ".kpopckpt", "rb") as f:
        meta = framed.read_header(f, expect_tag=TAG + "Meta")
    shape = tuple(meta["shape"])
    dtype = np.dtype(meta["dtype"])
    # exactly the shard files the metadata names; replicated shards may
    # repeat within or across files
    index, seen = [], set()
    for p in range(int(meta.get("processes", 1))):
        shard_path = path_prefix + f".shard{p}.kpopckpt"
        if not os.path.exists(shard_path):
            raise FileNotFoundError(
                f"checkpoint {path_prefix!r}: metadata says {meta.get('processes')} shard "
                f"files but {shard_path!r} is missing")
        with open(shard_path, "rb") as f:
            framed.read_header(f, expect_tag=TAG)
            for name, fdt, fshape, off in framed.iter_frames_meta(f):
                if name.startswith("shard:") and (name, fshape) not in seen:
                    seen.add((name, fshape))
                    start = tuple(int(x) for x in name[len("shard:"):].split(","))
                    index.append((shard_path, off, fdt, start, fshape))
    if not index:
        raise FileNotFoundError(f"no shard files found for checkpoint {path_prefix!r}")
    lo, hi = (0, shape[0]) if mesh is None or over is None else mesh.rows(shape[0], over)
    bounds = [(lo, hi)] + [(0, n) for n in shape[1:]]
    buf = np.empty(tuple(b - a for a, b in bounds), dtype=dtype)
    covered = np.zeros(buf.shape[:1], dtype=np.int64)  # elements a row received
    for path, off, fdt, start, fshape in index:
        inter = []
        for (a0, b0), st, sz in zip(bounds, start, fshape):
            a, b = max(a0, st), min(b0, st + sz)
            if a >= b:
                break
            inter.append((a, b, st, a0))
        if len(inter) < len(bounds):
            continue
        frame = np.memmap(path, dtype=fdt, mode="r", offset=off, shape=fshape)
        src = tuple(slice(a - st, b - st) for a, b, st, _ in inter)
        dst = tuple(slice(a - a0, b - a0) for a, b, _, a0 in inter)
        buf[dst] = frame[src]
        del frame
        covered[dst[0]] += int(np.prod([b - a for a, b, _, _ in inter[1:]], dtype=np.int64))
    row_size = int(np.prod(shape[1:], dtype=np.int64))
    if (covered != row_size).any():
        raise framed.IncompatibleArchive(
            f"checkpoint {path_prefix!r} covers {int(covered.sum())} of {buf.size} elements "
            f"of rows [{lo}, {hi}) (missing shard files?)")
    t = torch.from_numpy(buf)
    if device is not None:
        t = t.to(device)
    if mesh is None or over is None:
        return t
    return ShardedRows(t, lo, shape[0])
