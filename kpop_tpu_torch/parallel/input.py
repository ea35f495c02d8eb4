"""Sharded input: the counterpart of ``kpop_tpu/parallel/input.py``.

The reference scales ingest by a shell-level scatter (one ``KPopCount`` a
sample, README.md:571-597) and across nodes by manual file sharding merged
later with ``-a`` (README.md:1049-1067).  Here every rank reads its own
files (round-robin), encodes its batches locally (the native parser when
it is built), and :func:`global_batch` places its rows in the batch of all
ranks by their global offset, without moving the sequences; a caller that
needs the whole batch gathers it (``ShardedRows.gather``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from . import distributed
from .mesh import Layout, ShardedRows, all_gather_rows


def shard_files_for_process(
    files: Sequence[str],
    process_index: int | None = None,
    process_count: int | None = None,
) -> List[str]:
    """Round-robin assignment of input files to this rank (P2 scatter)."""
    pi = distributed.rank() if process_index is None else process_index
    pc = distributed.world_size() if process_count is None else process_count
    return [f for i, f in enumerate(files) if i % pc == pi]


def encode_fasta_batches(
    files: Sequence[str],
    batch: int,
    max_len: int,
    fastq: bool = False,
) -> Iterator[Tuple[np.ndarray, List[str]]]:
    """Stream ``(codes [b, max_len] int8, names)`` batches from files,
    using the native C++ parser when available; the last batch is padded
    with all ``-1`` rows to ``batch``."""
    from .. import native

    use_native = native.available()
    pending_codes: List[np.ndarray] = []
    pending_names: List[str] = []
    for path in files:
        if use_native:
            from ..utils.naming import open_in_bin

            f = open_in_bin(path)  # transparent .gz
            try:
                buf = f.read()
            finally:
                f.close()
            pos = 0
            while pos < len(buf):
                codes, names, _lens, consumed = native.fasta_encode_batch(
                    buf[pos:], batch, max_len, fastq=fastq
                )
                if len(names) == 0:
                    break
                pos += consumed
                pending_codes.append(codes)
                pending_names.extend(names)
                while len(pending_names) >= batch:
                    allc = np.concatenate(pending_codes, axis=0)
                    yield allc[:batch], pending_names[:batch]
                    pending_codes = [allc[batch:]]
                    pending_names = pending_names[batch:]
        else:
            from ..core.kmers import encode_dna
            from ..io.reads import FastaInput, SingleEndFastqInput, iter_reads

            inp = SingleEndFastqInput(path) if fastq else FastaInput(path)
            for tag, segments in iter_reads([inp]):
                row = np.full(max_len, -1, dtype=np.int8)
                e = encode_dna(segments[0])[:max_len]
                row[: len(e)] = e
                pending_codes.append(row[None, :])
                pending_names.append(tag)
                if len(pending_names) >= batch:
                    yield np.concatenate(pending_codes, axis=0), pending_names
                    pending_codes, pending_names = [], []
    if pending_names:
        allc = np.concatenate(pending_codes, axis=0)
        pad = batch - len(pending_names)
        if pad > 0:
            allc = np.concatenate([allc, np.full((pad, max_len), -1, dtype=np.int8)], axis=0)
        yield allc[:batch], pending_names


def global_batch(mesh: Layout, local_codes: np.ndarray, device=None) -> ShardedRows:
    """This rank's rows of the batch that stacks every rank's local batch
    in rank order: the rows as a tensor on ``device`` (the host by
    default), their global offset and the global row count (one exchange
    of the ranks' row counts; the codes stay where they are)."""
    counts = all_gather_rows(torch.tensor([[local_codes.shape[0]]]), mesh.world_host)
    counts = [int(c) for c in torch.cat(counts).ravel()]
    local = torch.as_tensor(np.ascontiguousarray(local_codes))
    if device is not None:
        local = local.to(device)
    return ShardedRows(local, sum(counts[: mesh.rank]), sum(counts))
