#!/usr/bin/env python3
"""The host's copy of a batch's strings into the pinned ring, alone: the
one-thread fill against the split fill, in one process.

``ByteRing.fill`` copies a batch of one piece of ``FILL_PIECE`` bytes on
the calling thread, one ``memmove`` a row, and a larger batch in pieces on
up to ``fill_cores()`` threads.  The probe takes two batches:

- mtb-reads': 16 of a pool of 24 read sets of 88,818,803 bases, cycled as
  the traffic cycles them (1.42 GB);
- sars2-reads': 64 read sets of 601,885 bases (38.5 MB).

For each, in rounds whose order turns, it fills a slot on one thread (the
piece set past the batch's size) and split at each piece size of
``--pieces`` (MB), the slot's row bytes set to a sentinel before each fill,
and asserts that every fill of a round leaves the same bytes in its slot.
Then a pass with the other slot's upload to the card in flight, as in
serving, on one thread and split at the module's ``FILL_PIECE``.  Prints
one JSON line a batch (each fill's ms, the median GB/s, the threads) and
one with the card's name and power limit.  Run it from the root of the
repository on a machine with a card (the slots are pinned)::

    python3 tools/probe_ring_fill.py 1 --pieces 1,2,4,8,16
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from kpop_tpu_torch.ops import encode  # noqa: E402

#: (name, bases a read set, read sets in the pool, a batch's read sets)
SHAPES = (("mtb-reads", 88_818_803, 24, 16), ("sars2-reads", 601_885, 64, 64))
ROUNDS, UPLOADS, SENTINEL = 7, 4, 0xA5
#: a piece no batch fills: the one-thread fill
ONE = 1 << 62
#: the module's piece size, which serving takes
SERVED = encode.FILL_PIECE


def fill(ring, batch, piece):
    """A timed fill of ``batch`` at ``piece`` bytes a piece, into the
    ring's next slot, its rows set to the sentinel first."""
    encode.FILL_PIECE = piece
    staged = ring.reserve(batch)
    staged.split()[0].fill_(SENTINEL)
    t = time.perf_counter()
    _, threads = ring.fill(staged)
    return staged, (time.perf_counter() - t) * 1e3, threads


def probe(name, bases, pool_n, batch_n, sizes, rng, dev):
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = [letters[rng.integers(0, 4, size=bases, dtype=np.uint8)].tobytes().decode()
            for _ in range(pool_n)]
    nbytes = batch_n * bases
    ring = encode.ByteRing(pinned=True)
    modes = {"one": ONE, **{f"split_{mb}MB": mb << 20 for mb in sizes}}
    ms = {m: [] for m in modes}
    threads = {}
    batches = [[pool[(batch_n * i + j) % pool_n] for j in range(batch_n)] for i in range(3)]
    for m, piece in modes.items():  # warm up: the pool's threads, the slots' pages
        fill(ring, batches[0], piece)
    names, refs = list(modes), {}
    for r in range(ROUNDS):
        b = r % 3
        for m in names[r % len(names):] + names[: r % len(names)]:
            staged, t, threads[m] = fill(ring, batches[b], modes[m])
            ms[m].append(round(t, 2))
            if b not in refs:
                refs[b] = staged.buffer.clone()
            assert torch.equal(staged.buffer, refs[b]), f"{name}: {m} left other bytes"
    # the other slot's upload in flight, as the serving step leaves it
    flight = {"one": ONE, "split": SERVED}
    flight_ms = {m: [] for m in flight}
    busy = {m: 0 for m in flight}
    for r in range(UPLOADS):
        for m in (list(flight) if r % 2 == 0 else list(flight)[::-1]):
            encode.FILL_PIECE = flight[m]
            staged = ring.reserve(batches[r % 3])
            ring.fill(staged)
            staged.buffer.to(dev, non_blocking=True)
            ring.uploaded()
            sent = torch.cuda.Event()
            sent.record()
            other, t, _ = fill(ring, batches[(r + 1) % 3], flight[m])
            busy[m] += int(not sent.query())
            flight_ms[m].append(round(t, 2))
            torch.cuda.synchronize()
            assert torch.equal(other.buffer, refs[(r + 1) % 3]), f"{name}: {m} in flight"
    encode.FILL_PIECE = SERVED
    return {"batch": name, "bytes": nbytes, "cores": encode.fill_cores(),
            "fill_ms": ms, "threads": threads,
            "GB_per_s": {m: round(nbytes / statistics.median(v) / 1e6, 2) for m, v in ms.items()},
            "with_upload_ms": flight_ms, "upload_still_running_at_fill_end": busy}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("seed", type=int)
    p.add_argument("--pieces", default="1,2,4,8,16", help="split piece sizes, MB")
    a = p.parse_args()
    sizes = [int(x) for x in a.pieces.split(",")]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "affinity": len(os.sched_getaffinity(0)), "seed": a.seed,
                      "fill_piece": encode.FILL_PIECE}), flush=True)
    rng = np.random.default_rng(a.seed)
    for shape in SHAPES:
        print(json.dumps(probe(*shape, sizes, rng, dev)), flush=True)


if __name__ == "__main__":
    main()
