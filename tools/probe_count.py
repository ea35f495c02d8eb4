#!/usr/bin/env python3
"""Probe of the k-mer count kernel (``csrc/count_spectra.cu`` with
``csrc/wide_lookup.cuh``), on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_count.py [--parent
DIR] [--only NAME,...]``.  It needs the CUDA toolkit (``nvcc``); the
package's kernels build into ``kpop_tpu_torch/_build`` as on first use, and
the probe builds patched copies of the count source in a temporary
directory.  ``--parent DIR`` names a directory that holds an earlier
``count_spectra.cu`` with its ``wide_lookup.cuh`` (``git show
<commit>:kpop_tpu_torch/csrc/<file>``), from before the bucketed plan: its
entry points take no plan argument and its scratch is ``B Wp + 2 B``
ints.  It is timed beside the package's.  ``--only`` runs the named inputs
alone.

Inputs: those of ``tools/probe_bag.py`` (phase 3's batch at k = 16 on the
cuckoo hash and on the sorted limbs and at k = 10 on the LUT, phase 4's
real batch at k = 10 and at k = 16), a hot batch of phase 3's shape whose
every read set is one k-mer repeated (k = 10), and the benchmark cells'
shapes on random bases: ``genomes`` (64 x 29,903 at k = 10 over every
canonical 10-mer, V = 524,800: u16 counters, 11 slices), ``reads`` (64 x
601,885 bases of joined 150 bp reads, the same vocabulary: u32, 22
slices), ``reads W=...`` (64 read sets of 65,545, 150,009 and 300,009
bases: the rows between), and ``mtb`` (4 read sets of 88,818,803 bases at
k = 12 over every canonical 12-mer, V = 8,390,656: u32, 342 slices; the
fourth read set one k-mer repeated, which fills one bucket).  It prints
one JSON line an input as it goes, then one JSON object:

- ``times``: on each input, the plan ``pipeline.count_plan`` takes and the
  median of 9 single calls between CUDA events, in the order parent,
  read-all, bucketed, bucketed, read-all, parent: the package's launches
  with each plan forced and the parent's, alone on preallocated buffers,
  then the package's ``count_spectra`` as called; and whether each equals
  the plain version;
- ``stages``: on each input, the device time of each launch (the lookup,
  the histogram, the scan, the scatter, the slices, the memset) of each
  plan and of the parent's, from ``torch.profiler``;
- ``variants``: on each input, the device time of each launch of copies of
  the package's source in the bucketed plan: the stores alone (the slices
  write the spectrum without reading an index), ``UNROLL`` 2, a histogram
  tile of one lookup block's windows (2,048: as many global adds a bin as
  a histogram fused into the lookup would make) and ``SCATTER_PER`` 8, and
  whether each equals the plain version (the stores alone do not);
- ``ptxas``: nvcc's register and spill report for the package's source;
- ``card``: the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from kpop_tpu_torch.ops import pipeline as pl  # noqa: E402
from probe_bag import (  # noqa: E402
    CSRC, build, median_ms, patched, real_inputs, stage_times, synthetic_inputs, vocab_of,
)

VARIANTS = {
    "stores_alone": [("    for (int w0 = (a & ~3) + threadIdx.x * RUN; w0 < e; w0 += UNROLL * CHUNK) {",
                      "    for (int w0 = (a & ~3) + threadIdx.x * RUN; w0 < 0; w0 += UNROLL * CHUNK) {")],
    "unroll_2": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")],
    "hist_tile_2048": [("constexpr int HIST_TILE = 16 * CHUNK;",
                        "constexpr int HIST_TILE = LOOKUP_THREADS * RUN;")],
    "scatter_per_8": [("constexpr int SCATTER_PER = 16;", "constexpr int SCATTER_PER = 8;")],
}
#: bases of a 20x read set of M. tuberculosis H37Rv as upstream simulates
#: it (the benchmark's mtb-reads), and of one of sars2-reads
TB_BASES, READS_BASES = 88_818_803, 601_885
STAGES = r"count_\w+|[Mm]emset"


def count_launcher(fns, params, codes, bucket):
    """The kernels' launches alone on preallocated buffers; ``bucket`` the
    plan forced, or None for a parent's entry point, which takes none."""
    Bn, Ln = codes.shape
    V = params.n_vocab
    scratch = torch.empty(pl.count_scratch_ints(Bn, Ln, params.k, V, bool(bucket)),
                          dtype=torch.int32, device=codes.device)
    out = torch.empty((Bn, V), dtype=torch.float32, device=codes.device)
    suffix, vocab = vocab_of(params, codes, bucket is None)
    fn = fns["kpop_count_spectra" + suffix]
    args = (codes.data_ptr(), Bn, Ln, params.k, int(params.canonical), params.base, *vocab, V, 0,
            V, 0) + (() if bucket is None else (int(bucket),))

    def launch():
        err = fn(*args, scratch.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kpop_count_spectra{suffix}: CUDA error {err}")
        return out

    return launch


def canonical_params(k: int, dev) -> pl.ClassifierParams:
    """Every canonical DNA k-mer, in code order, with a one-column
    twister (the count reads only the table)."""
    codes = np.arange(4**k, dtype=np.int64)
    rc, x = np.zeros_like(codes), codes.copy()
    for _ in range(k):
        rc = rc * 4 + (3 - x % 4)
        x //= 4
    vocab = codes[codes <= rc]
    V = len(vocab)
    lut = np.full(4**k + 1, V, dtype=np.int32)
    lut[vocab] = np.arange(V, dtype=np.int32)
    one = torch.ones(1, device=dev)
    return pl.ClassifierParams(torch.as_tensor(lut, device=dev), torch.ones((V, 1), device=dev),
                               one, torch.ones((2, 1), device=dev), torch.ones(2, device=dev),
                               k=k, canonical=True)


def joined_reads(dev, B: int, L: int, seed: int) -> torch.Tensor:
    """``[B, L]`` random bases on the card, -1 every 151st: 150 bp reads
    joined by a break."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 4, (B, L), generator=g, device=dev, dtype=torch.int8)
    codes[:, 150::151] = -1
    return codes


def cell_inputs(dev) -> dict:
    p10, p12 = canonical_params(10, dev), canonical_params(12, dev)
    g = torch.Generator(device=dev).manual_seed(29_903)
    out = {"genomes": (p10, torch.randint(0, 4, (64, 29_903), generator=g, device=dev,
                                          dtype=torch.int8)),
           "reads": (p10, joined_reads(dev, 64, READS_BASES, 1))}
    for L in (65_545, 150_009, 300_009):
        out[f"reads W={L - 9}"] = (p10, joined_reads(dev, 64, L, L))
    mtb = joined_reads(dev, 4, TB_BASES, 12)
    mtb[3] = 0  # one k-mer (all A) in every window: one bucket holds them all
    out["mtb"] = (p12, mtb)
    return out


def plain(params, codes) -> torch.Tensor:
    """The plain version, a read set at a time past 2^26 windows."""
    if codes.numel() <= 1 << 26:
        return pl.count_spectra_ref(params, codes)
    return torch.cat([pl.count_spectra_ref(params, codes[b:b + 1]) for b in range(len(codes))])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier count_spectra.cu and its "
                    "wide_lookup.cuh")
    ap.add_argument("--only", help="comma-separated input names to run alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_count: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = (CSRC / "count_spectra.cu").read_text()
    header = {"package": (CSRC / "wide_lookup.cuh").read_text()}
    sources = {"package": src}
    sources.update({name: patched(src, edits, name) for name, edits in VARIANTS.items()})
    if args.parent:
        sources["parent"] = (Path(args.parent) / "count_spectra.cu").read_text()
        header["parent"] = (Path(args.parent) / "wide_lookup.cuh").read_text()
    report = {"times": {}, "stages": {}, "variants": {}}
    td = tempfile.mkdtemp()
    try:
        libs, report["ptxas"] = build(sources, td, "kpop_count_spectra", header)
        for fn in libs.get("parent", {}).values():  # no plan before the scratch
            fn.argtypes = fn.argtypes[:-4] + fn.argtypes[-3:]
        inputs = synthetic_inputs(dev)
        lut_params, lut_codes = inputs["phase3 k=10 LUT"]
        inputs["hot k=10 LUT"] = (lut_params, torch.zeros_like(lut_codes))
        inputs.update(real_inputs(dev))
        inputs.update(cell_inputs(dev))
        only = set(args.only.split(",")) if args.only else None
        for name, (params, codes) in inputs.items():
            if only and name not in only:
                continue
            want = plain(params, codes)
            plan = pl.count_plan(codes.shape[1] - params.k + 1, params.n_vocab)
            runs = {"read-all": count_launcher(libs["package"], params, codes, False),
                    "bucketed": count_launcher(libs["package"], params, codes, True)}
            if args.parent:
                runs["parent"] = count_launcher(libs["parent"], params, codes, None)
            times = {"plan": plan._asdict()}
            for who, run in runs.items():
                times[who + " equals plain"] = bool(torch.equal(run(), want))
            order = list(runs)[::-1] + list(runs)
            for who in order:
                times.setdefault(who + " alone ms", []).append(median_ms(runs[who]))
            times["count_spectra ms"] = median_ms(lambda: pl.count_spectra(params, codes))
            report["times"][name] = times
            report["stages"][name] = {who: stage_times(run, STAGES) for who, run in runs.items()}
            variants = {}
            for vname in VARIANTS:
                v = count_launcher(libs[vname], params, codes, True)
                variants[vname] = dict(stages=stage_times(v, STAGES),
                                       equal=bool(torch.equal(v(), want)))
            report["variants"][name] = variants
            print(json.dumps({name: [times, report["stages"][name], variants]}), flush=True)
            del want, runs, params, codes
            inputs[name] = None
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(td, ignore_errors=True)
    report["card"] = chip_smoke.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
