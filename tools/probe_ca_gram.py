#!/usr/bin/env python3
"""Probe of the CA Gram kernel's design choices, on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_ca_gram.py [--parent
DIR]``.  It needs the CUDA toolkit (``nvcc``) and builds its copies of the
kernel in a temporary directory.  ``--parent DIR`` names a directory that
holds an earlier ``ca_gram.cu`` (``git show <commit>:kpop_tpu_torch/csrc/
ca_gram.cu``) whose one entry point adds a block's Gram into G with its
``accumulate`` flag (the API before the accumulator), timed beside the
package's.  The table is a seeded Poisson u8 table of the headline
training shape (367,987 k-mers x 512 classes), in one launch and in the
row blocks of phase 4's streamed fit (``chip_smoke.stream_geometry``: 10
blocks of 36,799 rows).  It prints one JSON object:

- ``ptxas``: nvcc's register and spill report for ``csrc/ca_gram.cu``;
- ``dmma_tflops``: the float64 tensor-core rate of ``mma.sync`` at the
  shapes m8n8k4, m16n8k8 and m16n8k16, from a loop of independent products
  on registers (csrc/ca_gram.cu uses m16n8k8);
- ``one_launch`` and ``streamed``: ``residual_gram``, and a
  ``GramAccumulator`` fed the blocks, with the split-K grid sized to
  several waves of resident blocks (``waves``), median and least of 9
  calls, and the error to the plain version;
- ``variants``: the same two calls through copies of the source on
  preallocated buffers, in the order package, variant, variant, package:
  gamma in shared memory in place of registers with two or three blocks an
  SM (``gamma_smem_edits``, the probe's own patch of the source), and u8
  counts converted to double by the conversion instruction in place of
  their bits;
- ``parent``: with ``--parent``, the earlier kernel in one launch and in
  the same blocks, in the order parent, package, package, parent;
- ``dgemm_ms``, ``addmm_ms`` and ``plain_ms``: one cuBLAS DGEMM ``S.T @ S``
  on a pre-built float64 S, ``torch.addmm`` of each block's ``S_b^T S_b``
  into G on pre-built float64 blocks, and the plain version;
- ``card``: the card's name and power limit.
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
from kpop_tpu_torch.ops import gram  # noqa: E402
from kpop_tpu_torch.parallel import sharded  # noqa: E402

K, NS, LAMBDA = chip_smoke.GRAM_K, chip_smoke.GRAM_NS, chip_smoke.GRAM_LAMBDA
ITERS, BLOCKS, THREADS = 2000, 132 * 8, 128
SRC = ROOT / "kpop_tpu_torch" / "csrc" / "ca_gram.cu"
BITS = "__hiloint2double(0x43300000, x) - 4503599627370496.0"


def gamma_smem_edits(blocks_per_sm: int) -> list[tuple[str, str]]:
    """The edits that move gamma of the block's columns from each thread's
    registers into shared memory (2 TILE doubles after the panels, loaded
    once by the block), with ``blocks_per_sm`` blocks an SM in the launch
    bounds of the u8, u16 and f32 wires (f64's segments keep two)."""
    return [
        ("constexpr size_t SMEM_BYTES = 2 * 2 * PANEL * sizeof(double);",
         "constexpr size_t SMEM_BYTES = (2 * 2 * PANEL + 2 * TILE) * sizeof(double);"),
        ("__launch_bounds__(THREADS, 2)",
         f"__launch_bounds__(THREADS, sizeof(T) == 8 ? 2 : {blocks_per_sm})"),
        ("""    double gI[SEG], gJ[SEG];  // gamma of the thread's columns, for the block
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
        gI[j] = I0 + c0 + j < ns ? gamma[I0 + c0 + j] : 0.0;
        gJ[j] = J0 + c0 + j < ns ? gamma[J0 + c0 + j] : 0.0;
    }
""", """    double* sG = sS + 2 * 2 * PANEL;  // gamma of panels I and J
    {
        const int col = (tid < TILE ? I0 : J0 - TILE) + tid;
        sG[tid] = col < ns ? gamma[col] : 0.0;
        __syncthreads();
    }
"""),
        ("a * fma(p, gI[j], as_double(nI[j]))", "a * fma(p, sG[c0 + j], as_double(nI[j]))"),
        ("a2 * fma(p, gI[j], as_double(nI[j]))", "a2 * fma(p, sG[c0 + j], as_double(nI[j]))"),
        ("fma(p, gJ[j], as_double(nJ[j]))", "fma(p, sG[TILE + c0 + j], as_double(nJ[j]))"),
    ]


# copies of the source: name -> (edits, blocks an SM the grid is sized for)
VARIANTS = {
    "gamma_smem_2": (gamma_smem_edits(2), 2),
    "gamma_smem_3": (gamma_smem_edits(3), 3),
    "u8_converted": ([("uint8_t x) {\n    return " + BITS, "uint8_t x) {\n    return (double)x")],
                     2),
}

_BENCH = r"""
__device__ __forceinline__ void m884(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void m1688(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void m16816(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                   "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int SHAPE>
__global__ void bench(double* out, int iters) {
    double c[8][4] = {}, a[8], b[4];
    for (int i = 0; i < 8; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
    for (int i = 0; i < 4; ++i) b[i] = 1.0 - threadIdx.x * 1e-3 + i;
    for (int it = 0; it < iters; ++it)
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // eight independent accumulators
            if (SHAPE == 0) m884(c[i], a + i, b + (i & 3));
            else if (SHAPE == 1) m1688(c[i], a + (i & 1) * 4, b + (i & 1) * 2);
            else m16816(c[i], a, b);
        }
    double s = 0.0;
    for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_dmma(int shape, double* out, int blocks, int threads, int iters, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (shape == 0) bench<0><<<blocks, threads, 0, st>>>(out, iters);
    else if (shape == 1) bench<1><<<blocks, threads, 0, st>>>(out, iters);
    else bench<2><<<blocks, threads, 0, st>>>(out, iters);
    return (int)cudaGetLastError();
}
"""
#: shape -> floating-point operations of one warp's product
SHAPES = {"m8n8k4": 2 * 8 * 8 * 4, "m16n8k8": 2 * 16 * 8 * 8, "m16n8k16": 2 * 16 * 8 * 16}
_P, _I = ctypes.c_void_p, ctypes.c_int


def nvcc(*args: str) -> str:
    """Run nvcc with the kernels' flags; raise on failure, else return its
    output."""
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *args],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    return res.stdout + res.stderr


def patched(src: str, edits, what: str) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: {old!r} is not one place of the source")
        src = src.replace(old, new)
    return src


def build(sources: dict, tmp: Path) -> tuple[dict, list[str]]:
    """One library per source, built side by side; the ptxas report of
    ``package``."""
    procs, paths = {}, {}
    for key, text in sources.items():
        (tmp / f"{key}.cu").write_text(text)
        paths[key] = tmp / f"lib{key}.so"
        procs[key] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
             str(tmp / f"{key}.cu"), "-o", str(paths[key])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, report = {}, []
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(paths[key]))
        libs[key].kpop_ca_gram.argtypes = _build._SIGNATURES["kpop_ca_gram"]
        if key != "parent":
            libs[key].kpop_ca_gram_finish.argtypes = _build._SIGNATURES["kpop_ca_gram_finish"]
        if key == "package":
            report = [line.strip() for line in out.splitlines()
                      if "registers" in line or "spill" in line]
    return libs, report


def time_ms(fn, reps: int = 9) -> tuple[float, float]:
    """Median and least device time of ``fn()`` in ms, by CUDA events."""
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


def dmma_rates(tmp: Path) -> dict:
    src, lib_path = tmp / "probe_dmma.cu", tmp / "libprobe_dmma.so"
    src.write_text(_BENCH)
    nvcc("-shared", "-o", str(lib_path), str(src))
    fn = ctypes.CDLL(str(lib_path)).probe_dmma
    fn.argtypes = (_I, _P, _I, _I, _I, _P)
    out = torch.empty(BLOCKS * THREADS, dtype=torch.float64, device="cuda")
    rates = {}
    for shape, (name, flops) in enumerate(SHAPES.items()):
        def run():
            err = fn(shape, out.data_ptr(), BLOCKS, THREADS, ITERS, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe_dmma: CUDA error {err}")
        ms = time_ms(run, reps=5)[0]
        rates[name] = BLOCKS * THREADS // 32 * ITERS * 8 * flops / ms / 1e9
    return rates


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def package_call(lib, x, vecs, rows: int, resident: int):
    """The Gram of ``x`` in blocks of ``rows`` through a library of the
    package's API (a launch a block into the partials, then the finish),
    on buffers allocated once, its split-K grid sized for ``resident``
    blocks an SM (as many SMs more as the package's plan counts fewer)."""
    ns = x.shape[1]
    n_sm = gram._sm_count(x.device) * resident // gram.RESIDENT_PER_SM
    slices = gram.split_plan(rows, ns, n_sm)[0]
    f64 = torch.float64
    partial = torch.empty(gram.partial_doubles(ns, slices), dtype=f64, device=x.device)
    factors = torch.empty(rows + ns, dtype=f64, device=x.device)
    G = torch.empty((ns, ns), dtype=f64, device=x.device)
    alpha, u, beta, v = vecs

    def run():
        st = torch.cuda.current_stream().cuda_stream
        for n, i in enumerate(range(0, x.shape[0], rows)):
            j = min(x.shape[0], i + rows)
            check(lib.kpop_ca_gram(x[i:j].data_ptr(), 0, j - i, ns, alpha[i:j].data_ptr(),
                                   u[i:j].data_ptr(), beta.data_ptr(), v.data_ptr(), slices,
                                   gram.slice_rows(j - i, slices), partial.data_ptr(),
                                   factors.data_ptr(), int(n == 0), st), "kpop_ca_gram")
        check(lib.kpop_ca_gram_finish(partial.data_ptr(), slices, ns, beta.data_ptr(),
                                      G.data_ptr(), st), "kpop_ca_gram_finish")
        return G

    return run


def parent_call(lib, x, vecs, rows: int):
    """The same through a parent's entry point: one launch, or a launch a
    block accumulating into G (its split-K workspace and slice sum a
    launch)."""
    ns = x.shape[1]
    n_sm = gram._sm_count(x.device)
    slices = gram.split_plan(rows, ns, n_sm)[0]
    f64 = torch.float64
    ws = torch.empty(rows + ns + slices * ns * ns, dtype=f64, device=x.device)
    G = torch.empty((ns, ns), dtype=f64, device=x.device)
    alpha, u, beta, v = vecs
    blocked = rows < x.shape[0]

    def run():
        st = torch.cuda.current_stream().cuda_stream
        if blocked:
            G.zero_()
        for i in range(0, x.shape[0], rows):
            j = min(x.shape[0], i + rows)
            sl, R = gram.split_plan(j - i, ns, n_sm)
            check(lib.kpop_ca_gram(x[i:j].data_ptr(), 0, j - i, ns, alpha[i:j].data_ptr(),
                                   u[i:j].data_ptr(), beta.data_ptr(), v.data_ptr(), sl, R,
                                   G.data_ptr(), ws.data_ptr(), int(blocked), st), "parent")
        return G

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory holding an earlier ca_gram.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    table = chip_smoke.poisson_table(K, NS, LAMBDA, seed=4)
    alpha, u, beta, v, r, _ = sharded.residual_vectors(table, None)
    x = torch.as_tensor(table, device=dev)
    vecs = [torch.as_tensor(a, device=dev) for a in (alpha * (r > 0), u, beta, v)]
    _, step = chip_smoke.stream_geometry(K, NS, "u8", dev)
    plain = gram.residual_gram_ref(x, *vecs)
    scale = float(plain.abs().max())

    def rel(G) -> float:
        return float((G - plain).abs().max()) / scale

    def streamed(waves: int):
        acc = gram.GramAccumulator(vecs[2], vecs[3], step, waves)
        for i in range(0, K, step):
            acc.add(x[i : i + step], vecs[0][i : i + step], vecs[1][i : i + step])
        return acc.finish()

    report = {"block_rows": step, "one_launch": {}, "streamed": {}, "variants": {}}
    for w in (2, 3, 4, 6):
        report["one_launch"][w] = dict(
            plan=gram.split_plan(K, NS, gram._sm_count(dev), w), rel_err=rel(
                gram.residual_gram(x, *vecs, waves=w)),
            ms=time_ms(lambda: gram.residual_gram(x, *vecs, waves=w)))
    for w in (1, 2, 3, 4):
        report["streamed"][w] = dict(
            slices=gram.split_plan(step, NS, gram._sm_count(dev), w)[0],
            rel_err=rel(streamed(w)), ms=time_ms(lambda: streamed(w)))
    src = SRC.read_text()
    sources = {"package": src}
    sources.update({name: patched(src, edits, name) for name, (edits, _) in VARIANTS.items()})
    if args.parent:
        sources["parent"] = (Path(args.parent) / "ca_gram.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs, report["ptxas"] = build(sources, Path(tmp))
        report["dmma_tflops"] = dmma_rates(Path(tmp))
        base = {rows: package_call(libs["package"], x, vecs, rows, gram.RESIDENT_PER_SM)
                for rows in (K, step)}
        for name, (_, resident) in VARIANTS.items():
            out = {}
            for label, rows in (("one_launch", K), ("streamed", step)):
                run = package_call(libs[name], x, vecs, rows, resident)
                out[label + "_rel_err"] = rel(run())
                for who, fn in (("package", base[rows]), (name, run), (name, run),
                                ("package", base[rows])):
                    out.setdefault(f"{label} {who} ms", []).append(time_ms(fn)[0])
            report["variants"][name] = out
        if args.parent:
            out = {}
            for label, rows in (("one_launch", K), ("streamed", step)):
                run = parent_call(libs["parent"], x, vecs, rows)
                out[label + "_rel_err"] = rel(run())
                for who, fn in (("parent", run), ("package", base[rows]), ("package", base[rows]),
                                ("parent", run)):
                    out.setdefault(f"{label} {who} ms", []).append(time_ms(fn)[0])
            report["parent"] = out
    S = gram.residual(x, *vecs)
    blocks = [S[i : i + step] for i in range(0, K, step)]
    G = torch.empty((NS, NS), dtype=torch.float64, device=dev)

    def addmm():
        G.zero_()
        for b in blocks:
            G.addmm_(b.T, b)
        return G

    report["dgemm_ms"] = time_ms(lambda: S.T @ S)
    report["addmm_ms"] = time_ms(addmm)
    report["addmm_rel_err"] = rel(addmm())
    del S, blocks
    report["plain_ms"] = time_ms(lambda: gram.residual_gram_ref(x, *vecs), reps=3)
    report["shape"] = [K, NS]
    report["card"] = chip_smoke.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
