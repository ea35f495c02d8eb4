#!/usr/bin/env python3
"""Probe of the 2-bit read wire in the count and bag kernels, on one CUDA
card.

Run from the root of a checkout: ``python3 tools/probe_wire.py --parent
DIR``.  It needs the CUDA toolkit (``nvcc``, ``cuobjdump``); the package's
kernels build into ``kpop_tpu_torch/_build`` as on first use.  ``DIR``
holds earlier sources (``git show <commit>:kpop_tpu_torch/csrc/<file>``
for ``count_spectra.cu``, ``embedding_bag.cu`` and ``wide_lookup.cuh``),
from before the wire became a template parameter of
``wide_lookup.cuh::window_rows``.  It prints one JSON object:

- ``sass``: for each int8 instantiation of the two kernels that read the
  read sets (``count_lookup``, ``bag_histogram``), the package's
  instructions against the same instantiation in ``DIR``: the count of
  each, whether the opcode sequences are equal, and how many instructions
  differ once constant-bank offsets (the kernel's parameter layout) are
  masked; and the packed instantiations' instruction counts beside them;
- ``ptxas``: nvcc's register and spill report for the package's two
  sources;
- ``checks``: each packed entry point against its int8 twin and the plain
  version on small batches (k = 10 on the LUT, k = 16 on the cuckoo hash
  and on the sorted limbs; f32 and bf16 rows), torch.equal;
- ``times``: on phase 3's inputs (``tools/probe_bag.py``'s synthetic ones:
  k = 16 on the cuckoo hash and the sorted limbs, k = 10 on the LUT), the
  int8 count and f32 bag of ``DIR`` and of the package, and the package's
  packed entry points on the same read sets, each alone on preallocated
  buffers, the median of 9 calls between CUDA events, in the order
  parent, package, packed, then back; and whether each output equals the
  package's;
- ``card``: the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
from kpop_tpu_torch.core.kmers import KmerSpace  # noqa: E402
from kpop_tpu_torch.ops import encode as te  # noqa: E402
from kpop_tpu_torch.ops import pipeline as pl  # noqa: E402

SOURCES = ("count_spectra.cu", "embedding_bag.cu")
KERNELS = ("count_lookup", "bag_histogram")
CONST = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")
PRED = re.compile(r"^@!?U?P[T0-9]\s+")


def tool(name: str) -> str:
    return shutil.which(name) or str(Path(_build.nvcc_path()).parent / name)


def sass(src_dir: Path, src: str, out_dir: Path) -> tuple[dict, str]:
    """The source's kernels -> ({demangled name: [instruction text]},
    ptxas's report)."""
    cubin = out_dir / (src_dir.name + "_" + src + ".cubin")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS[:2], "-std=c++17", "-O3",
                          "-Xptxas", "-v", "-cubin", "-o", str(cubin), str(src_dir / src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc -cubin {src_dir / src}:\n{res.stderr}")
    dump = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    names, out, cur = [], {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            names.append(cur)
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            out[cur].append(m.group(1))
    demangled = subprocess.run([tool("cu++filt") if os.path.exists(tool("cu++filt")) else "c++filt"],
                               input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return {d: out[n] for n, d in zip(names, demangled)}, res.stderr


def key_of(name: str) -> tuple[str, str, str] | None:
    """(kernel, wire, the other template arguments) of a demangled kernel
    name; the parent's have no wire argument (int8 codes)."""
    for k in KERNELS:
        at = name.find(k + "<")
        if at < 0:
            continue
        args = name[at + len(k) + 1: name.index(">(", at)]
        parts = [a.strip() for a in args.split(",")]
        wire = "int8"
        if parts and parts[0].startswith("kpop::") and parts[0].endswith("Wire"):
            wire = "packed" if parts.pop(0) == "kpop::PackedWire" else "int8"
        return k, wire, ", ".join(parts)
    return None


def source_dirs(parent: Path, out_dir: Path) -> dict:
    """name -> a directory holding count_spectra.cu, embedding_bag.cu,
    wide_lookup.cuh and errors.cu: the parent's and the package's."""
    dirs = {}
    for name in ("parent", "package"):
        d = out_dir / name
        d.mkdir()
        src = parent if name == "parent" else _build._CSRC
        for f in (*SOURCES, "wide_lookup.cuh"):
            shutil.copy(src / f, d / f)
        shutil.copy(_build._CSRC / "errors.cu", d / "errors.cu")
        dirs[name] = d
    return dirs


def build_libs(dirs: dict) -> dict:
    """One shared library a directory, built side by side."""
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
         *(str(d / f) for f in (*SOURCES, "errors.cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        lib = ctypes.CDLL(str(dirs[name] / "lib.so"))
        fns = {}
        for entry, sig in _build._SIGNATURES.items():
            if entry.startswith(("kpop_count_spectra", "kpop_embedding_bag")) and hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = sig, ctypes.c_int
                fns[entry] = fn
        libs[name] = fns
    return libs


def launcher(fn, name: str, wire: tuple, params, codes):
    """A zero-argument call of entry point ``fn`` on preallocated buffers;
    returns its output."""
    B, L = codes.shape
    V = params.n_vocab
    suffix, vocab = pl.vocab_args("probe", params, codes)
    head = (*wire, B, L, params.k, int(params.canonical), params.base, *vocab, V)
    if name.startswith("kpop_count_spectra"):
        scratch = torch.empty(pl.count_scratch_ints(B, L, params.k), dtype=torch.int32,
                              device=codes.device)
        out = torch.empty((B, V), dtype=torch.float32, device=codes.device)
        args = (*head, 0, V, 0, scratch.data_ptr(), out.data_ptr())
        bufs = (scratch, out)
    else:
        from kpop_tpu_torch.ops.pairwise import _sm_count

        tw = params.twister
        d = tw.shape[1]
        S = pl.bag_plan(V, d, _sm_count(codes.device))
        Bg = min(pl.BAG_GROUP, B)
        iwork = torch.empty(pl.bag_workspace_ints(Bg, L, params.k, V), dtype=torch.int32,
                            device=codes.device)
        fwork = torch.empty(S * Bg * d, dtype=torch.float32, device=codes.device)
        out = torch.empty((B, d), dtype=torch.float32, device=codes.device)
        args = (*head, tw.data_ptr(), pl.BAG_ROW_TYPES[tw.dtype], d, tw.stride(0), 1, S,
                iwork.data_ptr(), fwork.data_ptr(), out.data_ptr())
        bufs = (iwork, fwork, out)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return bufs[-1]

    return run


def timings(libs: dict, dev) -> dict:
    """The int8 count and f32 bag of every library, and the package's
    packed entry points, on phase 3's inputs, in turns."""
    sys.path.insert(0, str(ROOT / "tools"))
    from probe_bag import synthetic_inputs

    out = {}
    for what, (params, codes) in synthetic_inputs(dev).items():
        reads = chip_smoke.packed_reads(codes)
        suffix, _ = pl.vocab_args("probe", params, codes)
        for kernel in ("kpop_count_spectra", "kpop_embedding_bag"):
            name = kernel + suffix
            runs = {lib: launcher(fns[name], name, (codes.data_ptr(),), params, codes)
                    for lib, fns in libs.items()}
            runs["packed"] = launcher(libs["package"][name + "_packed"], name + "_packed",
                                      (reads.packed.data_ptr(), reads.valid.data_ptr()), params,
                                      codes)
            ref = runs["package"]().clone()
            order = list(runs) + list(runs)[::-1]
            samples = {lib: [] for lib in runs}
            for lib in order:
                samples[lib].append(median_ms(runs[lib]))
            out[f"{what}, {name}"] = {
                lib: dict(ms=v, equal=bool(torch.equal(runs[lib](), ref)))
                for lib, v in samples.items()}
            del runs, ref
            torch.cuda.empty_cache()
        del params, codes, reads
        torch.cuda.empty_cache()
    return out


def median_ms(fn, reps: int = 9) -> float:
    return chip_smoke.time_ms(fn, reps=reps, warmup=1)


def compare_sass(dirs: dict, out_dir: Path) -> tuple[list, str]:
    rows, reports = [], []
    for src in SOURCES:
        pkg, report = sass(dirs["package"], src, out_dir)
        par, _ = sass(dirs["parent"], src, out_dir)
        reports.append(report)
        pkg_by = {key_of(n): v for n, v in pkg.items() if key_of(n)}
        par_by = {key_of(n): v for n, v in par.items() if key_of(n)}
        for key, old in sorted(par_by.items()):
            packed = pkg_by.get((key[0], "packed", key[2]))
            row = dict(kernel=key[0], template=key[2], parent=len(old),
                       packed=None if packed is None else len(packed))
            new = pkg_by.get(key)
            row["package"] = None if new is None else sass_diff(new, old)
            rows.append(row)
    return rows, "\n".join(line for r in reports for line in r.splitlines()
                           if "registers" in line or "spill" in line or "Function properties" in line)


def sass_diff(new: list, old: list) -> dict:
    """A kernel's instructions against the parent's: counts, opcode
    sequences equal, instructions that differ with constant-bank offsets
    masked, and the opcodes whose counts differ most (new minus old)."""
    from collections import Counter

    ops, old_ops = ([PRED.sub("", i).split()[0] for i in x] for x in (new, old))
    masked = [CONST.sub("c[param]", i) for i in new], [CONST.sub("c[param]", i) for i in old]
    diff = Counter(ops)
    diff.subtract(Counter(old_ops))
    return dict(n=len(new), opcodes_equal=ops == old_ops,
                differ_masked=sum(a != b for a, b in zip(*masked)) + abs(len(new) - len(old)),
                opcode_counts=dict(sorted(((k, v) for k, v in diff.items() if v),
                                          key=lambda kv: -abs(kv[1]))[:12]))


def checks(dev) -> list:
    """Each packed entry point torch.equal to its int8 twin and to the plain
    version on a small batch."""
    rng = np.random.default_rng(4)
    codes = chip_smoke.read_like_codes(rng, 6, 2000)
    reads = te.PackedReads(*(torch.as_tensor(a, device=dev) for a in te.pack_reads_2bit(codes)),
                           codes.shape[1])
    codes = torch.as_tensor(codes, device=dev)
    d = 96
    out = []
    lut = chip_smoke.random_params(rng, dev, 50_000, d, 8)
    space = KmerSpace("DNA-ds", 16)
    kmers = chip_smoke.wide_vocabulary(rng, codes, 16, 4, True, 60_000)
    tw = torch.randn((60_000, d), generator=torch.Generator(dev).manual_seed(1), device=dev)
    cases = dict(lut=lut, cuckoo=chip_smoke.wide_params(dev, space, kmers, tw),
                 sorted=chip_smoke.wide_params(dev, space, kmers, tw, sorted_limbs=True))
    for name, params in cases.items():
        for dtype in ("f32", "bf16"):
            p = params if dtype == "f32" else chip_smoke.bf16_of(params)
            count = pl.count_spectra(p, reads)
            bag = pl.project_reads(p, reads)
            torch.cuda.synchronize()
            out.append(dict(
                vocab=name, rows=dtype,
                count_equal_int8=torch.equal(count, pl.count_spectra(p, codes)),
                count_equal_plain=torch.equal(count, pl.count_spectra_ref(p, te.as_codes(reads))),
                bag_equal_int8=torch.equal(bag, pl.project_reads(p, codes)),
                bag_max_abs_to_plain=float((bag - pl.project_reads_ref(p, codes)).abs().max())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_wire: no CUDA device", file=sys.stderr)
        return 2
    _build.lib()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as td:
        dirs = source_dirs(args.parent.resolve(), Path(td))
        libs = build_libs(dirs)
        rows, ptxas = compare_sass(dirs, Path(td))
        report = dict(sass=rows, ptxas=ptxas, checks=checks(dev), times=timings(libs, dev),
                      card=chip_smoke.card_line())
    print(json.dumps(report))
    bad = [c for c in report["checks"] if not (c["count_equal_int8"] and c["count_equal_plain"]
                                               and c["bag_equal_int8"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
