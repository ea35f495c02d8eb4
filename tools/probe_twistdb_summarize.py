#!/usr/bin/env python3
"""``kpop-twistdb-torch -s`` of this checkout beside that of another, on the
benchmark cell ``sars2-summarize``'s data: the summary files' bytes.

Run from the root of a checkout:
``python3 tools/probe_twistdb_summarize.py --seed 7 --rows 65536 --parent DIR``.
Makes the cell's 1,636 lineage coordinates and ``--rows`` of its twisted
query rows from the seed (``portbench/drivers/summarize_loop.py``), writes
them as ``Classes.KPopTwisted`` and ``Test.KPopTwisted``, with a
``Classes.KPopTwister`` that holds the configuration's inertia (``-s``
reads only the inertia of the twister, so its k-mer axis is one column),
then runs ``bin/kpop-twistdb-torch -i T Classes -i t Classes -s Test Out``
of this checkout and of ``DIR`` in turns (``--turns``), each in a process
of its own on the tool's default backend.  Prints one JSON line a run (the
checkout, its seconds, the summary's lines, bytes and sha256) and a last
line with ``identical``: every summary file byte for byte the same.  With
``--small`` (for a CPU) the configuration's sizes are the CPU tests'.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix  # noqa: E402
from kpop_tpu_torch.core.twister import Twister  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.drivers import classify_loop, summarize_loop  # noqa: E402


def write_inputs(at: Path, seed: int, rows: int, small: bool) -> int:
    """The cell's targets, twister inertia and ``rows`` query rows under
    ``at``; returns d."""
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cfg = harness.load_json("configs", "sars2-lineages-k10-summarize")
    if small:
        from portbench.tests import small as sm

        cfg = sm.config("sars2-lineages-k10-summarize")
    run = harness.load_run("sars2-summarize", seed, dev, False, config=dict(cfg, queries=rows))
    corpus = classify_loop.corpus(run)
    coords, inertia = corpus["coords"], np.asarray(corpus["inertia"], dtype=np.float64)
    del corpus
    queries, lineage = summarize_loop.twisted_rows(coords, rows, cfg["query_noise"], run.seeds)
    d = coords.shape[1]
    dims = ["D%d" % (j + 1) for j in range(d)]
    classes = ["C%d" % (c + 1) for c in range(coords.shape[0])]
    names = ["q%d-C%d" % (i + 1, c + 1) for i, c in enumerate(lineage.tolist())]
    Twister(KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, ["k0"], np.zeros((d, 1)))),
            KPopMatrix(MatrixType.INERTIA, NamedMatrix(["inertia"], dims, inertia[None, :]))
            ).to_binary(str(at / "Classes"))
    KPopMatrix(MatrixType.TWISTED, NamedMatrix(classes, dims, coords)).to_binary(
        str(at / "Classes"))
    KPopMatrix(MatrixType.TWISTED, NamedMatrix(names, dims, queries)).to_binary(str(at / "Test"))
    return d


def summarize(checkout: Path, at: Path, out: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(checkout / "bin" / "kpop-twistdb-torch"),
                    "-i", "T", "Classes", "-i", "t", "Classes", "-s", "Test", out],
                   cwd=at, env=env, check=True)
    seconds = time.perf_counter() - t0
    data = (at / (out + ".KPopSummary.txt")).read_bytes()
    return dict(checkout=str(checkout), seconds=seconds, lines=data.count(b"\n"),
                bytes=len(data), sha256=hashlib.sha256(data).hexdigest())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rows", type=int, default=65536)
    p.add_argument("--parent", required=True, help="the other checkout's root")
    p.add_argument("--turns", type=int, default=1)
    p.add_argument("--small", action="store_true")
    a = p.parse_args(argv)
    results = []
    with tempfile.TemporaryDirectory() as td:
        at = Path(td)
        t0 = time.perf_counter()
        d = write_inputs(at, a.seed, a.rows, a.small)
        print(json.dumps(dict(rows=a.rows, d=d, inputs_s=time.perf_counter() - t0)), flush=True)
        for turn in range(a.turns):
            for side, checkout in (("change", ROOT), ("parent", Path(a.parent).resolve())):
                res = dict(side=side, **summarize(checkout, at, "Out_%s_%d" % (side, turn)))
                print(json.dumps(res), flush=True)
                results.append(res)
    print(json.dumps(dict(identical=len({r["sha256"] for r in results}) == 1,
                          lines=sorted({r["lines"] for r in results}))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
