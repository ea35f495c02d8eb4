#!/usr/bin/env python3
"""Probe of the embedding-bag kernel (``csrc/embedding_bag.cu`` with
``csrc/wide_lookup.cuh``), on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_bag.py [--parent
DIR] [--dtype bf16]``.  It needs the CUDA toolkit (``nvcc``); the package's
kernels build into ``kpop_tpu_torch/_build`` as on first use, and the probe
builds patched copies of the bag source in a temporary directory.
``--parent DIR`` names a directory that holds an earlier
``embedding_bag.cu`` with its ``wide_lookup.cuh`` (``git show
<commit>:kpop_tpu_torch/csrc/<file>``), timed beside the package's; its
entry points may predate the row stride, the row type or the cuckoo
table's probe layout.  ``--dtype bf16`` casts every input's twister to bf16 (the
kernel's row type 1) in the port's layout (``pipeline.bf16_rows``: rows of
512 elements at d = 511, each on 16 bytes; a parent without a row stride
reads a contiguous copy), so that each regime and variant below runs on
bf16 rows.

Inputs (``chip_smoke.py``'s, seed 1 and 7): phase 3's batch (128 read-like
sets of 30,208 bases) at k = 16 with a vocabulary of 1,011,930 on the
cuckoo hash and on the sorted-limb fallback, and at k = 10 with a random
vocabulary of 367,987 (the LUT); the first batch of phase 4's real held-out
reads (128 read sets of 150 bp pairs at 1x coverage of the headline corpus,
seed 0) at k = 10 and, as phase 7 counts it, at k = 16, each with a random
twister of d = 511 around its corpus vocabulary.  It prints one JSON
object:

- ``inputs``: each input's known windows, entries (distinct (row, read
  set) pairs), distinct hit rows, tiles that hold keys and the regime the
  kernel takes;
- ``times``: on each input, the median of 9 single calls between CUDA
  events, in the order parent, package, package, parent: each kernel on
  preallocated buffers (alone) and with its workspace and output
  allocated first (as called), the package's ``project_reads``, and
  whether each is within the bag's tolerance of the plain version; and
  the host microseconds each package call takes to enqueue its work;
- ``stages``: on each input, the device time of each launch of the
  package's kernel and of the parent's, from ``torch.profiler``;
- ``variants``: on each input, the median time and the accumulate's device
  time of copies of the package's source: each regime forced
  (``GATHER_TILE_ENTRIES``), the gather with 1 or 4 entries' rows in flight a
  warp (``GATHER_AHEAD``), the staged ring with 4 tiles in flight
  (``SLOTS``), and each accumulate with its sums alone (every row
  read from one row, which stays in L1) or its row reads alone (the staged
  ring's copies without the sums; the gather's loads added into one sum,
  without the counts and the owner's select);
- ``ptxas``: nvcc's register and spill report for the package's source;
- ``card``: the card's name and power limit; ``dtype``: the twister's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
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
from kpop_tpu_torch.ops.encode import encode_reads_host, split_k  # noqa: E402

B, L, D = chip_smoke.BATCH, 30_208, 511
CSRC = ROOT / "kpop_tpu_torch" / "csrc"
# copies of the source: name -> edits (each old text must be one place)
GATHER_SUMS = ("acc[bi][k] = __fadd_rn(acc[bi][k], __fmul_rn(cf, x[u][k]));")
VARIANTS = {
    "staged": [("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 0;")],
    "gather": [("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 1 << 20;")],
    "gather_ahead_1": [("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 1 << 20;"),
                       ("constexpr int GATHER_AHEAD = 2;", "constexpr int GATHER_AHEAD = 1;")],
    "gather_ahead_4": [("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 1 << 20;"),
                       ("constexpr int GATHER_AHEAD = 2;", "constexpr int GATHER_AHEAD = 4;")],
    "staged_slots_4": [("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 0;"),
                       ("constexpr int SLOTS = 2;", "constexpr int SLOTS = 4;")],
    # the staged ring: the sums alone (no row copies), the copies alone
    "staged_sums_alone": [
        ("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 0;"),
        ("cp_async16(rows + slot * Row<Tw>::STRIDE + PER * q, twister + (bytes ? src : 0), bytes);",
         "if (r < 0) cp_async16(rows + slot * Row<Tw>::STRIDE + PER * q, twister + (bytes ? src : 0), bytes);")],
    "staged_copies_alone": [
        ("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 0;"),
        ("add_read_set(acc[bi], se, rows, h[4 + b], h[5 + b], lane);", "(void)b;")],
    # the gather: every entry's row read from row 0 (the sums and the walk
    # alone), and the row reads alone
    "gather_sums_alone": [
        ("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 1 << 20;"),
        ("const int v = tile_row0 + (a.x >> 16);", "const int v = 0 * (tile_row0 + a.x);")],
    "gather_reads_alone": [
        ("constexpr int GATHER_TILE_ENTRIES = 300;", "constexpr int GATHER_TILE_ENTRIES = 1 << 20;"),
        (GATHER_SUMS, "acc[0][k] += x[u][k];")],
}
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# an earlier wide entry point's vocabulary: k_lo, the [6, S] cuckoo table,
# S, the seeds, the sorted vocab_hi and vocab_lo
PARENT_WIDE = (_I, _P, _I, _U, _U, _U, _U, _P, _P)


#: what the --parent source's entry points take: a row stride after d, a
#: row type after the twister, and the cuckoo table's probe layout (each
#: read from the source: earlier sources lack the later ones)
PARENT_API = {"ld": True, "row_type": True, "probe": True}


def signature(name: str, parent: bool) -> tuple:
    """The entry point's argument types; a parent's lacks the row stride
    (seventh from the end) or the row type (after the twister) where its
    source has none, and its wide entry point takes PARENT_WIDE in place of
    the package's vocabulary arguments where it has no probe layout."""
    sig = list(_build._SIGNATURES[name])
    if parent:
        if not PARENT_API["ld"]:
            del sig[-7]
        if not PARENT_API["row_type"]:
            del sig[-8]
        if name.endswith("_wide") and not PARENT_API["probe"]:
            sig = sig[:6] + list(PARENT_WIDE) + sig[6 + len(_build._WIDE):]
    return tuple(sig)


def patched(src: str, edits, what: str) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: {old!r} is not one place of the source")
        src = src.replace(old, new)
    return src


def build(sources: dict, out_dir: str, entry: str, header_of: dict) -> tuple[dict, str]:
    """One library per source, built side by side, each in its own
    directory beside the header it includes; the ptxas report of
    ``package``.  Returns the named C entry points (``entry`` and
    ``entry + "_wide"``)."""
    procs, paths = {}, {}
    for i, (key, text) in enumerate(sources.items()):
        d = Path(out_dir) / f"v{i}"
        d.mkdir()
        (d / "wide_lookup.cuh").write_text(header_of.get(key, header_of["package"]))
        (d / "src.cu").write_text(text)
        paths[key] = str(d / "lib.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               str(d / "src.cu"), "-o", paths[key]]
        procs[key] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs, report = {}, ""
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lib = ctypes.CDLL(paths[key])
        fns = {}
        for name in (entry, entry + "_wide"):
            fn = getattr(lib, name)
            fn.argtypes = signature(name, key == "parent")
            fn.restype = ctypes.c_int
            fns[name] = fn
        libs[key] = fns
        if key == "package":
            report = "\n".join(line for line in out.splitlines()
                               if "registers" in line or "spill" in line or "Compiling" in line)
    return libs, report


def vocab_of(params, codes, parent: bool):
    """The entry point's suffix and vocabulary arguments, as
    pipeline.vocab_args gives them; a parent takes the cuckoo table as
    build_cuckoo returns it, or the sorted limbs as two arrays."""
    if not parent or params.vocab_lut is not None or PARENT_API["probe"]:
        return pl.vocab_args("probe", params, codes)
    k_lo = split_k(params.k, params.base)[1]
    if params.cuckoo is not None:
        return "_wide", (k_lo, params.cuckoo.data_ptr(), params.cuckoo.shape[1],
                         *params.cuckoo_seeds, None, None)
    return "_wide", (k_lo, None, 0, 0, 0, 0, 0, params.vocab_hi.data_ptr(),
                     params.vocab_lo.data_ptr())


def bag_launcher(fns, params, codes, parent: bool = False, twister=None):
    """project_reads's launch through a given library, on ``twister``
    (``params.twister`` by default): on preallocated buffers (the kernel
    alone), and with its workspace and output allocated first, as
    project_reads calls it."""
    twister = params.twister if twister is None else twister
    V, d = twister.shape
    Bn, Ln = codes.shape
    S = pl.bag_plan(V, d, torch.cuda.get_device_properties(codes.device).multi_processor_count)
    iwork = torch.empty(pl.bag_workspace_ints(Bn, Ln, params.k, V), dtype=torch.int32,
                        device=codes.device)
    fwork = torch.empty(S * min(Bn, pl.BAG_GROUP) * d, dtype=torch.float32, device=codes.device)
    out = torch.empty((Bn, d), dtype=torch.float32, device=codes.device)
    suffix, vocab = vocab_of(params, codes, parent)
    fn = fns["kpop_embedding_bag" + suffix]
    row_type = (() if parent and not PARENT_API["row_type"]
                else (pl.BAG_ROW_TYPES[twister.dtype],))
    ld = () if parent and not PARENT_API["ld"] else (twister.stride(0),)
    head = (codes.data_ptr(), Bn, Ln, params.k, int(params.canonical), params.base, *vocab, V,
            twister.data_ptr(), *row_type, d, *ld, 1, S)

    def launch(i, f, o):
        err = fn(*head, i.data_ptr(), f.data_ptr(), o.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kpop_embedding_bag{suffix}: CUDA error {err}")
        return o

    return ((lambda: launch(iwork, fwork, out)),
            (lambda: launch(torch.empty_like(iwork), torch.empty_like(fwork), torch.empty_like(out))))


def median_ms(fn, reps: int = 9) -> float:
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
    return float(np.median(times))


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call takes to enqueue its work (no synchronize
    inside the loop; the queue is drained first)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def stage_times(fn, pattern: str) -> dict:
    """Device ms of each launch of one call (the mean of 5), by kernel
    name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(pattern, ev.key)
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if m and dev_us:
            out[m.group(0)] = round(out.get(m.group(0), 0.0) + dev_us / 5 / 1e3, 4)
    return out


def synthetic_inputs(dev) -> dict:
    """Phase 3's batch at k = 16 on the cuckoo hash and the sorted limbs
    (chip_smoke.wide_blocks' first two inputs) and at k = 10 on the LUT."""
    rng = np.random.default_rng(1)
    params = chip_smoke.random_params(rng, dev, 367_987, D, chip_smoke.N_CLASSES)
    codes = torch.as_tensor(chip_smoke.read_like_codes(rng, B, L), device=dev)
    twister = torch.randn((chip_smoke.LARGE_K_VOCAB, D),
                          generator=torch.Generator(dev).manual_seed(6), device=dev)
    wide = chip_smoke.wide_blocks(dev, np.random.default_rng(7), codes, twister, first=2)
    return {**{"phase3 " + k.split(", ", 2)[-1]: v for k, v in wide.items()},
            "phase3 k=10 LUT": (params, codes)}


def real_inputs(dev) -> dict:
    """Phase 4's first batch of held-out reads with parameters around a
    random twister of its corpus vocabulary, at k = 10 (LUT) and k = 16
    (cuckoo), as phases 4 and 7 count the corpus."""
    rng = np.random.default_rng(0)
    genomes = chip_smoke.simulate_corpus(rng, chip_smoke.N_CLASSES, chip_smoke.GENOME_LEN)
    out = {}
    for k in (chip_smoke.K, chip_smoke.LARGE_K):
        space, vocab_hex, _table, held_out = chip_smoke.count_corpus(genomes, k)
        batches = chip_smoke.read_set_batches(np.random.default_rng(0), held_out, B)
        g = np.random.default_rng(5)
        tw = torch.as_tensor(g.standard_normal((len(vocab_hex), D)).astype(np.float32), device=dev)
        params = pl.params_around_twister(space, vocab_hex, tw, g.random(D) + 0.1,
                                          g.standard_normal((chip_smoke.N_CLASSES, D)))
        codes = torch.as_tensor(encode_reads_host(batches[0][1]), device=dev)
        out[f"real k={k} V={len(vocab_hex)}"] = (params, codes)
    return out


def input_stats(params, codes) -> dict:
    Vn = params.n_vocab
    idx = pl.vocab_lookup(params, codes)
    known = idx < Vn
    rows = idx[known].long()
    sets = torch.arange(codes.shape[0], device=codes.device)[:, None].expand_as(idx)[known]
    entries = int(torch.unique(rows * pl.BAG_GROUP + sets % pl.BAG_GROUP).numel())
    tiles = int(torch.unique(rows // pl.BAG_TILE_ROWS).numel())
    return dict(known_windows=int(known.sum()), entries=entries,
                hit_rows=int(torch.unique(rows).numel()), tiles=tiles,
                regime=pl.bag_regime(entries, tiles))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier embedding_bag.cu and its "
                    "wide_lookup.cuh")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the twister's dtype on every input (bf16: each cast from the f32 one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_bag: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = (CSRC / "embedding_bag.cu").read_text()
    header = {"package": (CSRC / "wide_lookup.cuh").read_text()}
    sources = {"package": src}
    sources.update({name: patched(src, edits, name) for name, edits in VARIANTS.items()})
    if args.parent:
        sources["parent"] = (Path(args.parent) / "embedding_bag.cu").read_text()
        header["parent"] = (Path(args.parent) / "wide_lookup.cuh").read_text()
        PARENT_API.update(ld="int ld" in sources["parent"],
                          row_type="int row_type" in sources["parent"],
                          probe="const int32_t* probe" in sources["parent"])
        if args.dtype == "bf16" and not PARENT_API["row_type"]:
            raise SystemExit("probe_bag: the parent's source takes no bf16 rows")
    report = {"inputs": {}, "times": {}, "stages": {}, "variants": {}}
    td = tempfile.mkdtemp()
    try:
        libs, report["ptxas"] = build(sources, td, "kpop_embedding_bag", header)
        inputs = {**synthetic_inputs(dev), **real_inputs(dev)}
        for name, (params, codes) in inputs.items():
            if args.dtype == "bf16":
                params = chip_smoke.bf16_of(params)
            report["inputs"][name] = input_stats(params, codes)
            want = pl.project_reads_ref(params, codes)

            def close(out):
                return bool(torch.allclose(out, want, rtol=chip_smoke.BAG_RTOL,
                                           atol=chip_smoke.BAG_ATOL))

            runs = {"package": bag_launcher(libs["package"], params, codes)}
            times = {"package within tolerance": close(runs["package"][0]())}
            order = ["package", "package"]
            if args.parent:  # a parent without a row stride reads contiguous rows
                flat = None if PARENT_API["ld"] else params.twister.contiguous()
                runs["parent"] = bag_launcher(libs["parent"], params, codes, parent=True,
                                              twister=flat)
                times["parent within tolerance"] = close(runs["parent"][0]())
                order = ["parent"] + order + ["parent"]
            for who in order:
                times.setdefault(who + " alone ms", []).append(median_ms(runs[who][0]))
                times.setdefault(who + " as called ms", []).append(median_ms(runs[who][1]))
                if who == "package":
                    times.setdefault("project_reads ms", []).append(
                        median_ms(lambda: pl.project_reads(params, codes)))
            times["host us: project_reads, package as called, alone"] = [
                host_us(lambda: pl.project_reads(params, codes)), host_us(runs["package"][1]),
                host_us(runs["package"][0])]
            report["times"][name] = times
            report["stages"][name] = {who: stage_times(r[0], r"bag_\w+") for who, r in runs.items()}
            variants = {}
            for vname in VARIANTS:
                v = bag_launcher(libs[vname], params, codes)[0]
                out = v()
                stages = stage_times(v, r"bag_(accumulate|gather)")
                variants[vname] = dict(ms=median_ms(v), accumulate_ms=stages,
                                       within_tolerance=close(out))
            report["variants"][name] = variants
            print(json.dumps({name: [report["inputs"][name], times, report["stages"][name],
                                     variants]}), flush=True)
            del params, codes, want, runs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(td, ignore_errors=True)
    report["card"] = chip_smoke.card_line()
    report["dtype"] = args.dtype
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
