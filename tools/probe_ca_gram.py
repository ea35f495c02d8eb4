#!/usr/bin/env python3
"""Probe of the CA Gram kernel's design choices, on one CUDA card.

Run from the root of a checkout: ``python3 tools/probe_ca_gram.py``.  It
needs the CUDA toolkit (``nvcc``) and builds its own code in a temporary
directory.  It prints one JSON object:

- ``ptxas``: nvcc's register and spill report for ``csrc/ca_gram.cu``;
- ``dmma_tflops``: the float64 tensor-core rate of ``mma.sync`` at the
  shapes m8n8k4, m16n8k8 and m16n8k16, from a loop of independent products
  on registers (csrc/ca_gram.cu uses m16n8k8);
- ``waves``: ``residual_gram`` at the headline training shape (a seeded
  Poisson u8 table of 367,987 k-mers x 512 classes) with the split-K grid
  sized to 2 to 8 waves of resident blocks (its ``waves`` argument),
  median and least of 9 calls, and its error to the plain version;
- ``dgemm_ms`` and ``plain_ms``: one cuBLAS DGEMM ``S.T @ S`` on a
  pre-built float64 S, and the plain version, on the same table;
- ``card``: the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kpop_tpu_torch import _build  # noqa: E402
from kpop_tpu_torch.ops import gram  # noqa: E402
from kpop_tpu_torch.parallel import sharded  # noqa: E402

K, NS, LAMBDA = 367_987, 512, 1.0
ITERS, BLOCKS, THREADS = 2000, 132 * 8, 128

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


def nvcc(*args: str) -> str:
    """Run nvcc with the kernels' flags; raise on failure, else return its
    output."""
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *args],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    return res.stdout + res.stderr


def ptxas_report(tmp: Path) -> list[str]:
    """Register and spill lines of ptxas for csrc/ca_gram.cu."""
    src = Path(_build.__file__).resolve().parent / "csrc" / "ca_gram.cu"
    out = nvcc("-Xptxas=-v", "-c", str(src), "-o", str(tmp / "ca_gram.o"))
    return [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]


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
    fn.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    table = np.empty((K, NS), dtype=np.uint8)
    for i in range(0, K, 1 << 15):
        table[i : i + (1 << 15)] = rng.poisson(LAMBDA, size=(min(1 << 15, K - i), NS))
    alpha, u, beta, v, r, _ = sharded.residual_vectors(table, None)
    x = torch.as_tensor(table, device=dev)
    vecs = [torch.as_tensor(a, device=dev) for a in (alpha * (r > 0), u, beta, v)]
    plain = gram.residual_gram_ref(x, *vecs)
    scale = float(plain.abs().max())
    waves = {}
    for w in (2, 3, 4, 5, 6, 8):
        err = float((gram.residual_gram(x, *vecs, waves=w) - plain).abs().max()) / scale
        waves[w] = dict(plan=gram.split_plan(K, NS, waves=w),
                        ms=time_ms(lambda: gram.residual_gram(x, *vecs, waves=w)), rel_err=err)
    S = gram.residual(x, *vecs)
    dgemm = time_ms(lambda: S.T @ S)
    del S
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        built = dict(ptxas=ptxas_report(Path(tmp)), dmma_tflops=dmma_rates(Path(tmp)))
    print(json.dumps(dict(
        built, waves=waves, dgemm_ms=dgemm,
        plain_ms=time_ms(lambda: gram.residual_gram_ref(x, *vecs), reps=3),
        shape=[K, NS], card=card,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
