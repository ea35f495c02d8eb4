#!/usr/bin/env python3
"""Probe of the k-mer count kernel (``csrc/count_spectra.cu`` with
``csrc/wide_lookup.cuh``), on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_count.py [--parent
DIR]``.  It needs the CUDA toolkit (``nvcc``); the package's kernels build
into ``kpop_tpu_torch/_build`` as on first use, and the probe builds
patched copies of the count source in a temporary directory.  ``--parent
DIR`` names a directory that holds an earlier ``count_spectra.cu`` with its
``wide_lookup.cuh`` (``git show <commit>:kpop_tpu_torch/csrc/<file>``),
whose wide entry point takes the cuckoo table as ``build_cuckoo`` returns
it and whose index scratch is ``B Wp`` ints, timed beside the package's.

Inputs: those of ``tools/probe_bag.py`` (phase 3's batch at k = 16 on the
cuckoo hash and on the sorted limbs and at k = 10 on the LUT, phase 4's
real batch at k = 10 and at k = 16), and a hot batch of phase 3's shape
whose every read set is one k-mer repeated (k = 10).  It prints one JSON
object:

- ``times``: on each input, the median of 9 single calls between CUDA
  events, in the order parent, package, package, parent: each kernel's
  launches alone on preallocated buffers and with its scratch and
  spectrum allocated first (as called), the package's ``count_spectra``,
  and whether each equals the plain version;
- ``stages``: on each input, the device time of each launch (the lookup,
  the slices, the memset of the counts) of the package's kernel and of the
  parent's, from ``torch.profiler``;
- ``variants``: on each input, the device time of each launch of copies of
  the package's source: the stores alone (the slices write the spectrum
  without reading an index), the slices with ``SLICE_BYTES`` of 64 KB and
  with ``UNROLL`` 2, and whether each equals the plain version (the
  stores alone do not);
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
    B, CSRC, L, build, median_ms, patched, real_inputs, stage_times, synthetic_inputs, vocab_of,
)

VARIANTS = {
    "stores_alone": [("    for (int w0 = threadIdx.x * RUN; w0 < n_row; w0 += UNROLL * CHUNK) {",
                      "    for (int w0 = threadIdx.x * RUN; w0 < 0; w0 += UNROLL * CHUNK) {")],
    "slice_64k": [("constexpr int SLICE_BYTES = 96 * 1024;", "constexpr int SLICE_BYTES = 64 * 1024;")],
    "unroll_2": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")],
}


def count_launcher(fns, params, codes, parent: bool = False):
    """The kernels' launches alone on preallocated buffers, and a call as
    the wrapper makes it (scratch and spectrum allocated first)."""
    Bn, Ln = codes.shape
    W = Ln - params.k + 1
    Wp = -(-W // pl.COUNT_RUN) * pl.COUNT_RUN
    ints = Bn * Wp if parent else pl.count_scratch_ints(Bn, Ln, params.k)
    scratch = torch.empty(ints, dtype=torch.int32, device=codes.device)
    out = torch.empty((Bn, params.n_vocab), dtype=torch.float32, device=codes.device)
    suffix, vocab = vocab_of(params, codes, parent)
    fn = fns["kpop_count_spectra" + suffix]
    head = (codes.data_ptr(), Bn, Ln, params.k, int(params.canonical), params.base, *vocab,
            params.n_vocab)

    def launch(s, o):
        err = fn(*head, s.data_ptr(), o.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kpop_count_spectra{suffix}: CUDA error {err}")
        return o

    def wrapper():
        return launch(torch.empty_like(scratch), torch.empty_like(out))

    return (lambda: launch(scratch, out)), wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier count_spectra.cu and its "
                    "wide_lookup.cuh")
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
        inputs = synthetic_inputs(dev)
        lut_params, lut_codes = inputs["phase3 k=10 LUT"]
        inputs["hot k=10 LUT"] = (lut_params, torch.zeros_like(lut_codes))
        inputs.update(real_inputs(dev))
        for name, (params, codes) in inputs.items():
            want = pl.count_spectra_ref(params, codes)
            alone, wrapper = count_launcher(libs["package"], params, codes)
            times = {"package equals plain": bool(torch.equal(alone(), want))}
            runs = {"package": (alone, wrapper)}
            order = ["package", "package"]
            if args.parent:
                runs["parent"] = count_launcher(libs["parent"], params, codes, parent=True)
                times["parent equals plain"] = bool(torch.equal(runs["parent"][0](), want))
                order = ["parent", "package", "package", "parent"]
            for who in order:
                times.setdefault(who + " alone ms", []).append(median_ms(runs[who][0]))
                times.setdefault(who + " as called ms", []).append(median_ms(runs[who][1]))
                if who == "package":
                    times.setdefault("count_spectra ms", []).append(
                        median_ms(lambda: pl.count_spectra(params, codes)))
            report["times"][name] = times
            report["stages"][name] = {who: stage_times(r[0], r"count_\w+|[Mm]emset")
                                      for who, r in runs.items()}
            variants = {}
            for vname in VARIANTS:
                v, _ = count_launcher(libs[vname], params, codes)
                variants[vname] = dict(stages=stage_times(v, r"count_\w+"),
                                       equal=bool(torch.equal(v(), want)))
            report["variants"][name] = variants
            print(json.dumps({name: [times, report["stages"][name], variants]}), flush=True)
            del want, runs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(td, ignore_errors=True)
    report["card"] = chip_smoke.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
