#!/usr/bin/env python3
"""Probe of the embedding-bag kernel's design choices, on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_bag.py``.  It needs
the CUDA toolkit (``nvcc``); the package's kernels build into
``kpop_tpu_torch/_build`` as on first use, and the probe builds patched
copies of ``csrc/embedding_bag.cu`` in a temporary directory.  It takes two inputs:
chip_smoke.py's phase 3 batch (128 random read sets of 30,208 bases, k =
10, a random vocabulary of 367,987 rows, d = 511, seed 1), and the first
batch of phase 4's real held-out reads (128 read sets of 150 bp pairs at
1x coverage of bench.py's headline corpus, seed 0, with a random twister),
whose read sets share most of their k-mers.  It prints one JSON object:

- ``ptxas``: nvcc's register, shared-memory and spill report for the
  package's build;
- ``inputs``: for each input, its known windows, its entries (distinct
  (row, read set) pairs), its distinct hit rows, the most entries of a
  tile, the bytes a gather of one row per known window moves and the
  bytes of the hit rows read once;
- ``plan``: the tile rows ``BAG_TILE_ROWS`` and the slices that
  ``bag_plan`` picks, and for each input the kernel's max abs error to the
  plain version and its median time;
- ``grid``: on each input, the median and least time of 9 calls, with the
  max abs error to the plain version, for each copy of the kernel built
  with other constants (``SUB`` buckets a tile, ``COPIES`` counters a
  bucket and ``SLOTS`` tiles in flight), at tiles of ``R`` = 64 and 128
  rows;
- ``split``: on each input, the median time and the accumulate's device
  time of a copy whose accumulate skips the row copies (the sums alone)
  and of one that skips the sums (the copies alone), beside the
  package's;
- ``stages``: on each input, the device time of each of the kernel's
  launches at the plan, from ``torch.profiler`` (or null where it records
  none);
- ``card``: the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from kpop_tpu_torch import _build  # noqa: E402
from kpop_tpu_torch.ops import pipeline as pl  # noqa: E402
from kpop_tpu_torch.ops.encode import encode_reads_host  # noqa: E402

B, L, V, D, C = 128, 30_208, 367_987, 511, 512

# buckets a tile, counters a bucket, tiles in flight; the package's first
SHAPES = ((8, 4, 2), (4, 1, 2), (8, 1, 2), (8, 4, 4))
ROWS = (64, 128)
SOURCE = ROOT / "kpop_tpu_torch" / "csrc" / "embedding_bag.cu"
# the lines of the source that the copies change
CONSTANTS = ("constexpr int R = 128;", "constexpr int SUB = 8;",
             "constexpr int COPIES = 4;", "constexpr int SLOTS = 2;",
             "constexpr int WORDS = R / 32;")
ROW_COPY = "cp_async16(rows + slot * ROW_STRIDE + 4 * q, twister + (bytes ? src : 0), bytes);"
SUMS = "add_read_set(acc[bi], se, rows, h[4 + b], h[5 + b], lane);"
SPLIT = {"NO_ROWS": (ROW_COPY, "if (r < 0) " + ROW_COPY),  # never true: the sums alone
         "NO_SUMS": (SUMS, "(void)b;")}                   # the copies alone


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"probe_bag: {old!r} is not one line of {SOURCE.name}")
        src = src.replace(old, new)
    return src


def variant(src: str, R: int, sub: int, copies: int, slots: int) -> str:
    """The source with other constants; the hit mask keeps its 4 words, so
    that a 64-row tile runs the package's code."""
    values = (f"R = {R};", f"SUB = {sub};", f"COPIES = {copies};", f"SLOTS = {slots};",
              "WORDS = 4;")
    return patched(src, [(line, "constexpr int " + v) for line, v in zip(CONSTANTS, values)])


def build_shapes(out_dir: str) -> tuple[dict, str]:
    """One library per copy of the source, built side by side; the register
    report of the package's."""
    src = SOURCE.read_text()
    sources = {(R, *shape): variant(src, R, *shape) for shape in SHAPES for R in ROWS}
    sources.update({part: patched(src, [edit]) for part, edit in SPLIT.items()})
    cmds = {}
    for i, (key, text) in enumerate(sources.items()):
        path = Path(out_dir) / f"bag_{i}.cu"
        path.write_text(text)
        cmds[key] = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                     str(path), "-o", f"{out_dir}/bag_{i}.so"]
    procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for key, cmd in cmds.items()}
    libs, report = {}, ""
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        fn = ctypes.CDLL(cmds[key][-1]).kpop_embedding_bag
        fn.argtypes = _build._SIGNATURES["kpop_embedding_bag"]
        fn.restype = ctypes.c_int
        libs[key] = fn
        if key == (128, *SHAPES[0]):
            report = out.strip()
    return libs, report


def bag(fn, params, codes, S: int, R: int = pl.BAG_TILE_ROWS,
        counters: int = pl.BAG_COUNTERS) -> torch.Tensor:
    """project_reads's launch through a given library, with S slices and
    room for tiles of R rows and ``counters`` counters a tile."""
    V_, d = params.twister.shape
    Bn, Ln = codes.shape
    Bg = min(Bn, pl.BAG_GROUP)
    T = -(-V_ // R)
    ints = (pl.BAG_GROUP + 19 + counters) * T + 3 * Bg * (Ln - params.k + 1) + pl.BAG_GROUP + 4
    iwork = torch.empty(ints, dtype=torch.int32, device=codes.device)
    fwork = torch.empty(S * Bg * d, dtype=torch.float32, device=codes.device)
    out = torch.empty((Bn, d), dtype=torch.float32, device=codes.device)
    err = fn(codes.data_ptr(), Bn, Ln, params.k, int(params.canonical), params.base,
             params.vocab_lut.data_ptr(), V_, params.twister.data_ptr(), d, 1, S,
             iwork.data_ptr(), fwork.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kpop_embedding_bag: CUDA error {err}")
    return out


def median_and_least(fn, reps: int = 9) -> tuple[float, float]:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(min(times))


def stage_times(fn) -> dict | None:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"bag_\w+", ev.key)
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if m and dev_us:
            out[m.group(0)] = out.get(m.group(0), 0.0) + dev_us / 5 / 1e3
    return out or None


def input_stats(params, codes) -> dict:
    """What the batch asks of the bag: its known windows, entries and hit
    rows, and the most entries a tile of R rows holds."""
    Vn, d = params.twister.shape
    idx = pl.vocab_lookup(params, codes)
    known = idx < Vn
    rows = idx[known].long()
    sets = torch.arange(codes.shape[0], device=codes.device)[:, None].expand_as(idx)[known]
    pairs = torch.unique(rows * pl.BAG_GROUP + sets % pl.BAG_GROUP)
    _, per_tile = torch.unique(pairs // pl.BAG_GROUP // pl.BAG_TILE_ROWS, return_counts=True)
    hit = int(torch.unique(rows).numel())
    return dict(known_windows=int(known.sum()), entries=int(pairs.numel()), hit_rows=hit,
                most_entries_a_tile=int(per_tile.max()), gather_bytes=int(known.sum()) * 4 * d,
                hit_row_bytes=hit * 4 * d)


def real_batch(dev):
    """Phase 4's first batch of held-out reads, with parameters around a
    random twister of its vocabulary."""
    rng = np.random.default_rng(0)
    space, vocab_hex, _table, held_out = chip_smoke.build_corpus(rng, C, 30_000)
    batches = chip_smoke.read_set_batches(rng, held_out, B)
    g = np.random.default_rng(5)
    tw = torch.as_tensor(g.standard_normal((len(vocab_hex), D)).astype(np.float32), device=dev)
    params = pl.params_around_twister(space, vocab_hex, tw, g.random(D) + 0.1,
                                      g.standard_normal((C, D)))
    return params, torch.as_tensor(encode_reads_host(batches[0][1]), device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bag: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"inputs": {}, "plan": {}, "grid": {}, "split": {}, "stages": {}}
    with tempfile.TemporaryDirectory() as td:
        libs, report["ptxas"] = build_shapes(td)
        rng = np.random.default_rng(1)
        synthetic = (chip_smoke.random_params(rng, dev, V, D, C),
                     torch.as_tensor(chip_smoke.read_like_codes(rng, B, L), device=dev))
        for name, (params, codes) in (("phase3", synthetic), ("phase4", real_batch(dev))):
            Vn, d = params.twister.shape
            want = pl.project_reads_ref(params, codes)
            report["inputs"][name] = input_stats(params, codes)
            R, S = pl.BAG_TILE_ROWS, pl.bag_plan(Vn, d, n_sm)
            got = pl.project_reads(params, codes)
            torch.cuda.synchronize()
            report["plan"][name] = dict(
                R=R, S=S, err=float((got - want).abs().max()),
                ms=median_and_least(lambda: pl.project_reads(params, codes))[0])
            print(json.dumps({name: [report["inputs"][name], report["plan"][name]]}), flush=True)
            grid = []
            for shape in SHAPES:
                counters = shape[0] * shape[1]
                for r in ROWS:
                    fn = libs[(r, *shape)]
                    out = bag(fn, params, codes, S, r, counters)
                    torch.cuda.synchronize()
                    med, least = median_and_least(lambda: bag(fn, params, codes, S, r, counters))
                    grid.append(dict(sub=shape[0], copies=shape[1], slots=shape[2], R=r, S=S,
                                     ms=med, least_ms=least, err=float((out - want).abs().max())))
                    print(json.dumps({name: grid[-1]}), flush=True)
            report["grid"][name] = grid
            split = {}
            for part, fn in [("package", libs[(R, *SHAPES[0])])] + [(p, libs[p]) for p in SPLIT]:
                run = lambda: bag(fn, params, codes, S)  # noqa: E731
                split[part] = dict(ms=median_and_least(run)[0],
                                   accumulate_ms=(stage_times(run) or {}).get("bag_accumulate"))
            report["split"][name] = split
            report["stages"][name] = stage_times(lambda: pl.project_reads(params, codes))
            print(json.dumps({name: [split, report["stages"][name]]}), flush=True)
            del params, codes, want, got
    report["card"] = chip_smoke.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
