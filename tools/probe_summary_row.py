#!/usr/bin/env python3
"""The host's summary lines alone: ``core/space.py::summarize_distance_row``
by its sorts (the native library switched off, the function before the row
digest) against the same function with the native row digest
(``native/summary_row.cpp``), in one process.

Run from the root of a checkout::

    python3 tools/probe_summary_row.py [--seed 1] [--rounds 41]

For each batch shape, sars2's 64 rows over 1,636 classes and mtb-reads' 16
rows over 1,000 targets, it draws float32 distances around 1 (cast to
float64, as ``DeviceStep.materialize`` returns them) with a tie at the
nearest two, then formats the batch's lines by the sorts and by the digest
in turns for ``--rounds`` rounds, the order turning each round, and asserts
that both give the same lines.  It also times the digest's call alone.
Prints one JSON line a shape (the medians of ms a batch and µs a row, and
their ratio) and one with the host's cores and the card's name and power
limit where ``nvidia-smi`` answers.  Nothing runs on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kpop_tpu_torch import native  # noqa: E402
from kpop_tpu_torch.core.space import summarize_distance_row  # noqa: E402

#: (name, rows a batch, classes, keep_at_most) of the cells' batches
SHAPES = (("sars2", 64, 1636, 2), ("mtb-reads", 16, 1000, 2))


@contextlib.contextmanager
def sorts_only():
    """The native library switched off: every row takes the sorts."""
    lib, get = native._lib, native.get_lib
    native._lib, native.get_lib = None, lambda: None
    try:
        yield
    finally:
        native._lib, native.get_lib = lib, get


def batch(rows, names, keep):
    return [summarize_distance_row(keep, "q%d" % i, r, names) for i, r in enumerate(rows)]


def timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def probe(name, n_rows, n_cls, keep, rounds, rng) -> dict:
    rows = rng.normal(1.0, 0.05, (n_rows, n_cls)).astype(np.float32).astype(np.float64)
    rows[:, 1] = rows[:, 0] = rows.min(axis=1)  # a tie at the nearest two
    names = ["C%d" % (c + 1) for c in range(n_cls)]
    with sorts_only():
        want = batch(rows, names, keep)
    assert batch(rows, names, keep) == want
    sorts, digest, call = [], [], []
    for r in range(rounds):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            if which == 0:
                with sorts_only():
                    sorts.append(timed_ms(lambda: batch(rows, names, keep)))
            else:
                digest.append(timed_ms(lambda: batch(rows, names, keep)))
        call.append(timed_ms(lambda: [native.summary_row(row, keep) for row in rows]))
    s, d, c = (statistics.median(x) for x in (sorts, digest, call))
    return {"shape": name, "rows": n_rows, "classes": n_cls, "rounds": rounds,
            "sorts_ms_batch": s, "digest_ms_batch": d, "call_ms_batch": c,
            "sorts_us_row": s / n_rows * 1e3, "digest_us_row": d / n_rows * 1e3,
            "call_us_row": c / n_rows * 1e3, "speedup": s / d}


def host() -> dict:
    out = {"cores": os.cpu_count(), "numpy": np.__version__}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        out["card"] = q.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        out["card"] = None
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rounds", type=int, default=41)
    a = p.parse_args()
    if not native.available():
        sys.exit("probe_summary_row: the native library did not build")
    rng = np.random.default_rng(a.seed)
    for shape in SHAPES:
        print(json.dumps(probe(*shape, a.rounds, rng)), flush=True)
    print(json.dumps(host()), flush=True)


if __name__ == "__main__":
    main()
