#!/usr/bin/env python3
"""Probe of the row-digest kernel (``csrc/digest.cu``), on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_digest.py [--parent
DIR]``.  It needs the CUDA toolkit (``nvcc``); the package's kernels build
into ``kpop_tpu_torch/_build`` as on first use, and the probe builds patched
copies of the digest source in a temporary directory.  ``--parent DIR``
names a directory that holds an earlier ``digest.cu`` (for example one
written by ``git show <commit>:kpop_tpu_torch/csrc/digest.cu``), which is
timed and broken down beside the package's.

The input is the relatedness flagship's block, as ``chip_smoke.py`` phase 3
feeds the digest: the distance tile of 2048 normalized standard-normal
queries against 10,000 targets of 512 dimensions (metric 1/512, seed 1),
k = 16.  It prints one JSON object:

- ``ptxas``: nvcc's register, shared-memory and spill report for the
  package's source;
- ``stages``: for the package's kernel (and the parent's), the median over
  blocks of the ``clock64`` cycles each stage of a row takes, read by a copy
  of the source with a stamp after each stage: the row's copy into shared
  memory (the package's only), the moment passes (in the package's, the
  second one also counts the first value digit), the median and k-th
  value selection, the compaction (in the package's, it also counts the
  first MAD digit), the MAD selection and the package's ordering of the k
  smallest, with the digit passes each selection made after its first
  digit and the cycles of one such pass;
- ``times``: the median of 9 single calls between CUDA events, in the order
  parent, package, package, parent, plain: each kernel alone, the
  package's wrapper (``digest_batch``), the parent's kernel with its
  wrapper's ``torch.sort``, ``gather`` and ``.long()``, those three alone,
  and the plain version;
- ``grid``: each copy of the package's source built with other constants
  (``THREADS`` threads a staged block, ``COPIES`` histogram copies), its
  median time alone and whether it equals the package's output;
- ``card``: the card's name and power limit and the SM clock during the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from kpop_tpu_torch.ops import pairwise as pw  # noqa: E402
from kpop_tpu_torch.ops import summaries as sm  # noqa: E402

B, N, D, K = chip_smoke.DIGEST_B, chip_smoke.DIGEST_N, chip_smoke.REL_D, chip_smoke.DIGEST_K
SOURCE = ROOT / "kpop_tpu_torch" / "csrc" / "digest.cu"
GRID = ((256, 1), (256, 2), (256, 4), (128, 1), (512, 1))  # (THREADS, COPIES)
CONSTANTS = ("constexpr int THREADS = 256;", "constexpr int COPIES = 1;")
STAGES = ("start", "copy", "moments", "digit", "value selection", "MAD selection", "compaction",
          "order")
# (line of the source, stage stamped, stamp after the line (else before))
ANCHORS = {
    "package": (
        ("    extern __shared__ __align__(16) uint32_t staged[];", 0, True),
        ("    if (body > 0) mbar_wait(&sh.landed, 0);", 1, True),
        ("    for (int w = 0; w < WARPS; ++w) m2 += sh.red[1][w];", 2, True),
        ("        mask |= digit << low;", 3, True),
        ("    const float median = key_value(found[0]);", 4, True),
        ("    const int mad_rank[1] = {N / 2};", 6, False),
        ("    if (k <= K_MAX && warp == 0) {  // rank of each entry in (key, column) order", 5, False),
        ("        float* st = stats + (size_t)blockIdx.x * 4;", 7, False),
    ),
    "parent": (
        ("    const float* row = dmat + (size_t)blockIdx.x * N;", 0, True),
        ("    const double m2 = block_sum(q, sh);", 2, True),
        ("        mask |= digit << low;", 3, True),
        ("    const float median = key_value(found[0]);", 4, True),
        ("    const float mad = key_value(mad_key[0]);", 5, True),
        ("        float* st = stats + (size_t)blockIdx.x * 4;", 6, False),
    ),
}
MAX_STAMPS = 32
PROBE = """
__device__ long long kpop_probe_clock[%(B)d][%(S)d];
__device__ int kpop_probe_stage[%(B)d][%(S)d];
__device__ int kpop_probe_n[%(B)d];
__device__ __forceinline__ void kpop_probe_stamp(int stage) {
    if (threadIdx.x == 0 && blockIdx.x < %(B)d) {
        const int n = kpop_probe_n[blockIdx.x]++;
        if (n < %(S)d) {
            kpop_probe_clock[blockIdx.x][n] = clock64();
            kpop_probe_stage[blockIdx.x][n] = stage;
        }
    }
}
extern "C" int kpop_probe_read(long long* clocks, int* stages, int* counts) {
    cudaMemcpyFromSymbol(clocks, kpop_probe_clock, sizeof(kpop_probe_clock));
    cudaMemcpyFromSymbol(stages, kpop_probe_stage, sizeof(kpop_probe_stage));
    cudaMemcpyFromSymbol(counts, kpop_probe_n, sizeof(kpop_probe_n));
    static int zeros[%(B)d];
    return (int)cudaMemcpyToSymbol(kpop_probe_n, zeros, sizeof(zeros));
}
""" % dict(B=B, S=MAX_STAMPS)


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"probe_digest: {old!r} is not one line of the source")
    return src.replace(old, new)


def stamped(src: str) -> str:
    """The source with a clock stamp after (or before) each stage's line."""
    table = next((t for t in ANCHORS.values() if all(src.count(a) == 1 for a, _, _ in t)), None)
    if table is None:
        raise RuntimeError("probe_digest: the source matches no anchor table")
    for line, stage, after in table:
        stamp = f"kpop_probe_stamp({stage});"
        src = replace_once(src, line, f"{line} {stamp}" if after else f"{stamp} {line}")
    return replace_once(src, "#include <stdint.h>\n", "#include <stdint.h>\n" + PROBE)


def build(sources: dict, out_dir: str) -> tuple[dict, str]:
    """One library per source, built side by side; the ptxas report of the
    package's."""
    procs, paths = {}, {}
    for i, (key, text) in enumerate(sources.items()):
        src = Path(out_dir) / f"digest_{i}.cu"
        src.write_text(text)
        paths[key] = f"{out_dir}/digest_{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(src),
               "-o", paths[key]]
        procs[key] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs, report = {}, ""
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lib = ctypes.CDLL(paths[key])
        lib.kpop_row_digest.argtypes = _build._SIGNATURES["kpop_row_digest"]
        lib.kpop_row_digest.restype = ctypes.c_int
        libs[key] = lib
        if key == "package":
            report = out.strip()
    return libs, report


def launcher(lib, dmat, k: int, idx_dtype):
    """A call of the library's kernel alone on preallocated outputs."""
    Bn, Nn = dmat.shape
    outs = (torch.empty((Bn, 4), dtype=torch.float32, device=dmat.device),
            torch.empty((Bn, k), dtype=torch.float32, device=dmat.device),
            torch.empty((Bn, k), dtype=idx_dtype, device=dmat.device))

    def run():
        err = lib.kpop_row_digest(dmat.data_ptr(), Bn, Nn, k, *(t.data_ptr() for t in outs),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kpop_row_digest: CUDA error {err}")
        return outs

    return run


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


def stage_cycles(lib, run) -> dict:
    """Median over blocks of each stage's cycles, from one stamped run."""
    clocks = np.zeros((B, MAX_STAMPS), dtype=np.int64)
    stages = np.zeros((B, MAX_STAMPS), dtype=np.int32)
    counts = np.zeros(B, dtype=np.int32)
    lib.kpop_probe_read.argtypes = (ctypes.c_void_p,) * 3
    lib.kpop_probe_read(clocks.ctypes.data, stages.ctypes.data, counts.ctypes.data)  # reset
    run()
    torch.cuda.synchronize()
    lib.kpop_probe_read(clocks.ctypes.data, stages.ctypes.data, counts.ctypes.data)
    per_block = []
    for b in range(B):
        n = min(int(counts[b]), MAX_STAMPS)
        st, ck = stages[b, :n], clocks[b, :n]
        out = dict.fromkeys(("copy", "moments", "value selection", "MAD selection",
                             "compaction", "order", "whole row"), 0)
        digits = {"value selection": 0, "MAD selection": 0}
        phase = "value selection"
        each = {"value selection": [], "MAD selection": []}
        for j in range(1, n):
            dt = int(ck[j] - ck[j - 1])
            name = STAGES[st[j]]
            if name == "digit":
                digits[phase] += 1
                out[phase] += dt
                each[phase].append(dt)
            else:
                out[name] += dt
                if name == "value selection":
                    phase = "MAD selection"
        out["whole row"] = int(ck[n - 1] - ck[0])
        out["value digit passes"] = digits["value selection"]
        out["MAD digit passes"] = digits["MAD selection"]
        per_block.append((out, each))
    med = {key: float(np.median([p[key] for p, _ in per_block])) for key in per_block[0][0]}
    for sel in ("value selection", "MAD selection"):  # each digit, where all blocks made it
        n_d = min(len(e[sel]) for _, e in per_block)
        med[f"{sel}: cycles of each digit"] = [
            float(np.median([e[sel][d] for _, e in per_block])) for d in range(n_d)]
    for sel in ("value", "MAD"):
        passes = med[f"{sel} digit passes"]
        med[f"cycles a {sel} digit pass"] = med[f"{sel} selection"] / passes if passes else None
    return med


def flagship_block(dev) -> torch.Tensor:
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((B, D), dtype=np.float32), device=dev)
    t = torch.as_tensor(rng.standard_normal((chip_smoke.REL_T, D), dtype=np.float32), device=dev)
    m = torch.full((D,), 1.0 / D, dtype=torch.float32, device=dev)
    return pw.distance_tile(q, t, m, pw.row_norms(q, m), pw.row_norms(t, m))


def sm_clock() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier digest.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_digest: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = SOURCE.read_text()
    sources = {"package": src, "package stamped": stamped(src)}
    for threads, copies in GRID:
        values = (f"constexpr int THREADS = {threads};", f"constexpr int COPIES = {copies};")
        text = src
        for old, new in zip(CONSTANTS, values):
            text = replace_once(text, old, new)
        sources[(threads, copies)] = text
    if args.parent:
        parent = (Path(args.parent) / "digest.cu").read_text()
        sources.update({"parent": parent, "parent stamped": stamped(parent)})
    report = {"stages": {}, "times": {}, "grid": []}
    with tempfile.TemporaryDirectory() as td:
        libs, report["ptxas"] = build(sources, td)
        dmat = flagship_block(dev)
        want = sm.digest_batch_ref(dmat, K)
        new = launcher(libs["package"], dmat, K, torch.int64)
        got = new()
        torch.cuda.synchronize()
        report["package equals plain"] = all(
            torch.equal(a, b) for a, b in ((got[0][:, 2:], want[0][:, 2:]), (got[1], want[1]),
                                           (got[2], want[2])))
        report["stages"]["package"] = stage_cycles(
            libs["package stamped"], launcher(libs["package stamped"], dmat, K, torch.int64))
        times = {}
        if args.parent:
            old = launcher(libs["parent"], dmat, K, torch.int32)

            def old_wrapper():
                _stats, top, idx = old()
                top, order = torch.sort(top, dim=1, stable=True)
                return idx.gather(1, order).long()

            top16 = old()[1].clone()
            idx16 = old()[2].clone()

            def old_tail():
                top, order = torch.sort(top16, dim=1, stable=True)
                return idx16.gather(1, order).long()

            report["stages"]["parent"] = stage_cycles(
                libs["parent stamped"], launcher(libs["parent stamped"], dmat, K, torch.int32))
        order = (["parent", "package", "package", "parent"] if args.parent
                 else ["package", "package"]) + ["plain"]
        for who in order:
            if who == "package":
                times.setdefault("package kernel alone", []).append(median_ms(new))
                times.setdefault("package wrapper", []).append(
                    median_ms(lambda: sm.digest_batch(dmat, K)))
            elif who == "parent":
                times.setdefault("parent kernel alone", []).append(median_ms(old))
                times.setdefault("parent kernel + sort, gather, long", []).append(
                    median_ms(old_wrapper))
                times.setdefault("parent's sort, gather, long alone", []).append(
                    median_ms(old_tail))
            else:
                times["plain"] = [median_ms(lambda: sm.digest_batch_ref(dmat, K), reps=5)]
        report["times"] = times
        ref = new()
        ref = [t.clone() for t in ref]
        for threads, copies in GRID:
            run = launcher(libs[(threads, copies)], dmat, K, torch.int64)
            out = run()
            torch.cuda.synchronize()
            report["grid"].append(dict(
                threads=threads, copies=copies, ms=median_ms(run),
                equal=all(torch.equal(a, b) for a, b in zip(out, ref))))
            print(json.dumps(report["grid"][-1]), flush=True)
    report["card"] = chip_smoke.card_line()
    report["sm clock, max (MHz)"] = sm_clock()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
