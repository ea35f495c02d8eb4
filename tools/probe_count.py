#!/usr/bin/env python3
"""Probe of the k-mer count kernel (``csrc/count_spectra.cu``), on one CUDA
card.

Run from the root of a checkout: ``python3 tools/probe_count.py [--parent
DIR]``.  It needs the CUDA toolkit (``nvcc``); the package's kernels build
into ``kpop_tpu_torch/_build`` as on first use, and the probe builds patched
copies of the count source in a temporary directory.  ``--parent DIR``
names a directory that holds an earlier ``count_spectra.cu`` with the
earlier entry point (no index scratch; the caller zeroes the spectrum),
timed beside the package's.

Inputs: ``chip_smoke.py`` phase 3's batch (128 read-like sets of 30,208
bases, k = 10, a random vocabulary of 367,987 k-mers, seed 1), and a hot
batch of the same shape whose every read set is one k-mer repeated.  It
prints one JSON object:

- ``ptxas``: nvcc's register, shared-memory and spill report for the
  package's source;
- ``stages``: on each input, the device time of the lookup and of the
  slice counts, from ``torch.profiler``;
- ``times``: on each input, the median of 9 single calls between CUDA
  events, in the order parent, package, package, parent, plain: the
  package's kernels alone and its wrapper (``count_spectra``), the
  parent's kernel alone on a zeroed spectrum and with its wrapper's
  ``torch.zeros``, and the plain version;
- ``grid``: each copy of the package's source built with other constants
  (``SLICE_BYTES`` of counters a block, ``UNROLL`` chunks of indices a
  thread loads at once) or with plain stores of the spectrum in place of
  streaming ones, its median time alone and whether it equals the plain
  version;
- ``card``: the card's name and power limit.
"""

from __future__ import annotations

import argparse
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

B, L, V, D, C = chip_smoke.BATCH, 30_208, 367_987, 511, chip_smoke.N_CLASSES
SOURCE = ROOT / "kpop_tpu_torch" / "csrc" / "count_spectra.cu"
# (SLICE_BYTES, UNROLL, streaming stores); the package's is (96 KB, 4, True)
GRID = ((96 * 1024, 4, True), (96 * 1024, 4, False), (96 * 1024, 1, True),
        (64 * 1024, 4, True), (112 * 1024, 4, True), (200 * 1024, 4, True))
CONSTANTS = ("constexpr int SLICE_BYTES = 96 * 1024;", "constexpr int UNROLL = 4;")
# plain stores in place of the streaming ones
PLAIN_STORES = (
    ("__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }",
     "__device__ __forceinline__ void put(float* p, float v) { *p = v; }"),
    ("__device__ __forceinline__ void put4(float* p, float4 v) { __stcs(reinterpret_cast<float4*>(p), v); }",
     "__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }"),
)
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGS = (_P, _I, _I, _I, _I, _I, _P, _I, _P, _P)


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"probe_count: {old!r} is not one line of the source")
    return src.replace(old, new)


def build(sources: dict, out_dir: str) -> tuple[dict, str]:
    procs, paths = {}, {}
    for i, (key, text) in enumerate(sources.items()):
        src = Path(out_dir) / f"count_{i}.cu"
        src.write_text(text)
        paths[key] = f"{out_dir}/count_{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(src),
               "-o", paths[key]]
        procs[key] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs, report = {}, ""
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        fn = ctypes.CDLL(paths[key]).kpop_count_spectra
        fn.argtypes = PARENT_ARGS if key == "parent" else _build._SIGNATURES["kpop_count_spectra"]
        fn.restype = ctypes.c_int
        libs[key] = fn
        if key == "package":
            report = out.strip()
    return libs, report


def launcher(fn, params, codes, parent: bool = False):
    """A call of the library's kernels alone on preallocated buffers (the
    parent's spectrum is zeroed outside the call)."""
    Bn, Ln = codes.shape
    W = Ln - params.k + 1
    Wp = -(-W // pl.COUNT_RUN) * pl.COUNT_RUN
    scratch = torch.empty(Bn * Wp, dtype=torch.int32, device=codes.device)
    out = torch.zeros((Bn, params.n_vocab), dtype=torch.float32, device=codes.device)
    head = (codes.data_ptr(), Bn, Ln, params.k, int(params.canonical), params.base,
            params.vocab_lut.data_ptr(), params.n_vocab)
    tail = (out.data_ptr(),) if parent else (scratch.data_ptr(), out.data_ptr())

    def run():
        err = fn(*head, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kpop_count_spectra: CUDA error {err}")
        return out

    return run, out


def median_ms(fn, reps: int = 9, before=None) -> float:
    if before:
        before()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before:
            before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
        m = re.search(r"count_\w+", ev.key)
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if m and dev_us:
            out[m.group(0)] = out.get(m.group(0), 0.0) + dev_us / 5 / 1e3
    return out or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier count_spectra.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_count: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = SOURCE.read_text()
    sources = {"package": src}
    for slice_bytes, unroll, streaming in GRID:
        text = replace_once(src, CONSTANTS[0], f"constexpr int SLICE_BYTES = {slice_bytes};")
        text = replace_once(text, CONSTANTS[1], f"constexpr int UNROLL = {unroll};")
        for old, new in () if streaming else PLAIN_STORES:
            text = replace_once(text, old, new)
        sources[(slice_bytes, unroll, streaming)] = text
    if args.parent:
        sources["parent"] = (Path(args.parent) / "count_spectra.cu").read_text()
    report = {"stages": {}, "times": {}, "grid": {}}
    with tempfile.TemporaryDirectory() as td:
        libs, report["ptxas"] = build(sources, td)
        rng = np.random.default_rng(1)
        params = chip_smoke.random_params(rng, dev, V, D, C)
        codes = torch.as_tensor(chip_smoke.read_like_codes(rng, B, L), device=dev)
        hot = torch.zeros_like(codes)
        for name, batch in (("phase3", codes), ("hot", hot)):
            want = pl.count_spectra_ref(params, batch)
            run, out = launcher(libs["package"], params, batch)
            run()
            torch.cuda.synchronize()
            times = {"package equals plain": bool(torch.equal(out, want))}
            if args.parent:
                old, old_out = launcher(libs["parent"], params, batch, parent=True)

                def old_wrapper():
                    old_out.zero_()
                    old()

                old_wrapper()
                torch.cuda.synchronize()
                times["parent equals plain"] = bool(torch.equal(old_out, want))
            order = (["parent", "package", "package", "parent"] if args.parent
                     else ["package", "package"]) + ["plain"]
            for who in order:
                if who == "package":
                    times.setdefault("package kernels alone", []).append(median_ms(run))
                    times.setdefault("package wrapper", []).append(
                        median_ms(lambda: pl.count_spectra(params, batch)))
                elif who == "parent":
                    times.setdefault("parent kernel alone", []).append(
                        median_ms(old, before=old_out.zero_))
                    times.setdefault("parent kernel + torch.zeros", []).append(
                        median_ms(lambda: (torch.zeros_like(old_out), old())))
                else:
                    times["plain"] = [median_ms(lambda: pl.count_spectra_ref(params, batch),
                                                reps=3)]
            report["times"][name] = times
            report["stages"][name] = stage_times(run)
            grid = []
            for slice_bytes, unroll, streaming in GRID:
                g, g_out = launcher(libs[(slice_bytes, unroll, streaming)], params, batch)
                g()
                torch.cuda.synchronize()
                grid.append(dict(slice_bytes=slice_bytes, unroll=unroll,
                                 streaming_stores=streaming, ms=median_ms(g),
                                 equal=bool(torch.equal(g_out, want))))
                print(json.dumps({name: grid[-1]}), flush=True)
            report["grid"][name] = grid
            print(json.dumps({name: [times, report["stages"][name]]}), flush=True)
            del want
    report["card"] = chip_smoke.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
