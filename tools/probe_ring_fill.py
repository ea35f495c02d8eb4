#!/usr/bin/env python3
"""The host's copy of mtb-reads' batches into the pinned ring, alone.

``ByteRing.fill`` copies each read set's bytes into a reused pinned slot
with one ``memmove`` a row on one thread.  At mtb-reads' batch (16 of a
pool of 24 read sets of 88,818,803 bases, cycled as the traffic cycles
them) that is 1.42 GB a batch, the host's largest stage once the count no
longer hides it.  Prints one JSON line: the pool's build time, each of 9
fills in ms and its rate in GB/s.  Run it once a process, from the root of
the repository, on a machine with a card (the slot is pinned)::

    for s in 1 2 3; do python3 tools/probe_ring_fill.py $s; done
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from kpop_tpu_torch.ops.encode import ByteRing  # noqa: E402

BASES, POOL, BATCH, FILLS = 88_818_803, 24, 16, 9


def main(seed: int) -> None:
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = time.perf_counter()
    pool = [letters[rng.integers(0, 4, size=BASES, dtype=np.uint8)].tobytes().decode()
            for _ in range(POOL)]
    made = time.perf_counter() - t
    ring = ByteRing(pinned=True)
    ms = []
    for i in range(FILLS):
        staged = ring.reserve([pool[(BATCH * i + j) % POOL] for j in range(BATCH)])
        t = time.perf_counter()
        ring.fill(staged)
        ms.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"seed": seed, "pool_s": round(made, 2),
                      "fill_ms": [round(x, 2) for x in ms],
                      "GB_per_s": [round(BATCH * BASES / x / 1e6, 2) for x in ms]}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
