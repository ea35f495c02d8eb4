#!/usr/bin/env python3
"""Smoke run of kpop_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); without a card it exits 2 and
prints no result.  It imports nothing of JAX or of the JAX package
(``kpop_tpu``).  Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` builds ``kpop_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``kpop_tpu_torch/_build/`` (on first use);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with the median time of both, the time of
   one PyTorch call that computes the same function where there is one
   (``library_ms``) and the least time the card could take (``bound_ms``);
   the distance tile also at phase 6's relatedness batch (2048 x 10,000 x
   512, and its last batch of 1,696), on raw spectra (512 x 512 x 367,987)
   and, for timing, at 4096 x 4096 x 512, each against float64 on the card
   too; the count also at 130 read sets, at a vocabulary of 100,003 and on a
   protein LUT (base 20, k = 5), each torch.equal to its plain version and
   to a second call; the row digest on the relatedness batch's tile (2048 x
   10,000, k=16, k = DIGEST_K_MAX and DIGEST_K_MAX + 1), on ties and signed
   zeros, on rows of 367,987 and with k = N, each the same on a second
   call; for the count and the digest each input's kernel time alone and
   its wrapper's; the
   CA Gram on a seeded Poisson u8 table of the headline shape (367,987 x
   512) against its plain version and a numpy float64 Gram, with one cuBLAS
   DGEMM as its yardstick; the embedding bag also against a float64 bag
   of the same f32 twister, with the known windows and distinct hit rows
   of its batch, and at 130 read sets (a full group of 128 and a partial
   one) against both; the wide count and the wide bag (k above the
   dense-LUT limit) against their plain versions on the slice's batch at
   k=16 with a vocabulary of 1,011,930 on the cuckoo hash and on the
   sorted-limb fallback, at DNA-ds k=30 and on protein read sets at k=8,
   the count torch.equal to its plain version and to a second call, the
   bag within the bag's tolerances and the float64 check;
4. slice: the headline workload of ``bench.py`` (k=10, 512 classes x 4
   tips of a 30 kb genome, seed 0, 1,024 held-out read sets of 150 bp pairs
   at 1x coverage; vocabulary ~368k, d=511), trained on the card
   (``ca_fit_sharded(phi="device")``: the wall split into masses, upload,
   Gram, eigh and phi, the fit within tests/test_dd.py's bounds of the host
   float64 ``fit_ca``, and the peak device memory of the fit that streams
   phi to the host) and classified through the dense and the bag route
   with parameters built around the device twister: top-1 accuracy >= 0.95
   on each, every kernel launched, each route's device time a batch,
   distances within 1e-4 of the host float64 chain, and the serving rate;
5. cli: the README quick start trained by ``kpop-twist-torch`` with its
   default backend (the device CA), then through ``bin/kpop-classify-torch``
   and ``kpop-twistdb-torch -s``, 0 misclassified of 100 on each, the
   summaries within 2e-4 of ``kpop-twistdb``'s host float64 lines, and
   ``kpop-countdb-torch --distances`` against ``kpop-countdb``'s host
   distances; the three tools run in this process without ``--backend``
   and must launch their kernels on the card;
6. relatedness: ``bench.py``'s relatedness flagship (100,000 queries x
   10,000 targets x 512 dims, seed 2, keep 2, batch 2048) through
   ``summarize_rowwise_device`` on the tile route (``pallas``) and the
   matrix-product route (``jax``): the first 2,000 queries' lines within
   2e-4 of the host float64 lines, tile and digest launched, and the
   queries/s of both routes and of the host; then phase 4's 512 class
   spectra (367,987 k-mers) through ``distance_rowwise_device`` on the
   tile, as ``kpop-countdb --distances --backend pallas`` computes them,
   against float64 on the card;
7. large k: phase 4's genomes counted at k=16 (vocabulary 1,011,930),
   trained on the card (``phi="device"``), parameters built around the
   device twister with the cuckoo hash, phase 4's held-out read sets
   served on both routes: top-1 accuracy >= 0.95 on each, the wide count,
   the wide bag and the tile launched, each route's device time a batch,
   and the first batch within 1e-4 of the host float64 chain through the
   same fit with phi on the host.

The kernel table is printed as one JSON line, then the card's name and
power limit, and last the result line
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 10
N_CLASSES = 512
GENOME_LEN = 30_000
BATCH = 128
ACCURACY_GATE = 0.95  # bench.py:695, fatal here
HOST_CHAIN_ATOL = 1e-4
COUNT_TOL = "exact (torch.equal)"
BAG_RTOL, BAG_ATOL = 1e-5, 1e-6
LIBRARY_RTOL = 1e-3  # a library call against the plain version, of max |x|
PAIR_RTOL, PAIR_ATOL = 2e-4, 1e-5  # tests/test_pallas.py:32
F64_ERR_RATIO = 4.0  # distance tile's error to float64 against the plain version's
DIGEST_B, DIGEST_N, DIGEST_K = 2048, 10_000, 16  # the relatedness flagship batch
DIGEST_RTOL = 1e-5
# the relatedness flagship of bench.py:349-361: seed 2, queries x targets x
# dims of standard normals, metric 1/dims, euclidean, keep 2, batch 2048
REL_Q, REL_T, REL_D, REL_KEEP = 100_000, 10_000, 512, 2
REL_HOST_Q = 2000  # queries held to the host float64 path (bench.py:382)
SUMMARY_BOUND = 2e-4  # x max(1, |x|), tests/test_device_summaries.py:55
# the CA Gram at the headline shape: a seeded Poisson u8 table of 367,987
# k-mers x 512 classes, held to float64 within 1e-12 of the largest |G|
GRAM_K, GRAM_NS, GRAM_LAMBDA = 367_987, 512, 1.0
GRAM_RTOL = 1e-12
# the card's peaks for the bound of each kernel, from NVIDIA's H100 SXM
# data sheet
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
F64_TC_FLOPS = 67e12  # FP64 tensor cores
F64_FLOPS = 34e12  # FP64 outside the tensor cores
SLICE_KERNELS = ("kpop_count_spectra", "kpop_embedding_bag", "kpop_pairwise_dist")
# phase 7: phase 4's corpus counted at k = 16 (two limbs: k_hi 1, k_lo 15),
# whose vocabulary the phase 3 wide rows take the size of
LARGE_K = 16
LARGE_K_VOCAB = 1_011_930
LARGE_K_KERNELS = ("kpop_count_spectra_wide", "kpop_embedding_bag_wide", "kpop_pairwise_dist")
# the device CA against the host float64 fit_ca: tests/test_dd.py:81-84
CA_BOUNDS = dict(sv=1e-8, inertia=1e-8, coords=1e-6, twister=1e-5)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_alone_ms(name: str, *args, reps: int = 10) -> float:
    """Median device time of one kernel entry point alone, called on
    prepared buffers with no wrapper around it (its launches are not
    counted in ``_build.LAUNCHES``)."""
    import torch

    from kpop_tpu_torch import _build

    fn = getattr(_build.lib(), name)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return time_ms(run, reps=reps)


# ---------------- phase 3: kernels against their plain versions ----------


def random_params(rng, dev, V: int, d: int, C: int):
    """Classifier parameters with a random k=10 vocabulary of V k-mers."""
    import torch

    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    n = 4**K
    perm = rng.permutation(n)
    pos0 = int(np.nonzero(perm == 0)[0][0])
    perm[[0, pos0]] = perm[[pos0, 0]]  # the all-A k-mer is in the vocabulary
    lut = np.full(n + 1, V, dtype=np.int32)
    lut[perm[:V]] = np.arange(V, dtype=np.int32)
    metric = rng.random(d)
    metric /= metric.sum()
    coords = rng.standard_normal((C, d))
    norms = np.sqrt((coords**2 * metric).sum(axis=1))

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    return ClassifierParams(
        torch.as_tensor(lut, device=dev),
        f32(rng.standard_normal((V, d))),
        f32(metric), f32(coords), f32(norms), k=K, canonical=True,
    )


def read_like_codes(rng, B: int, L: int) -> np.ndarray:
    """[B, L] int8 bases shaped like joined 150 bp reads: -1 breaks every
    151 bases, ragged -1 tails, a row repeating one 10-mer pattern and a
    row of one k-mer repeated ~L times."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.int8)
    codes[:, 150::151] = -1
    for i in range(B):
        codes[i, L - int(rng.integers(0, 300)) :] = -1
    n = min(L, 3000)
    codes[0, :n] = np.tile(rng.integers(0, 4, size=10, dtype=np.int8), 300)[:n]
    codes[1, :] = 0
    return codes


def distances_f64(a, b, m, na, nb):
    """The distance tile in float64 on the card, from the same f32 inputs."""
    import torch

    a, b, m, na, nb = (x.double() for x in (a, b, m, na, nb))
    a = a / na[:, None]
    b = b / nb[:, None]
    am = a * m[None, :]
    d2 = (am * a).sum(dim=1)[:, None] + (b * b * m[None, :]).sum(dim=1)[None, :] - 2.0 * am @ b.T
    return torch.sqrt(torch.clamp(d2, min=0.0))


def bag_f64(params, codes):
    """The embedding bag in float64 on the card, from the same f32
    twister: the exact counts of the plain counter times the twister,
    divided by each read set's known count."""
    from kpop_tpu_torch.ops import pipeline as pl

    counts = pl.count_spectra_ref(params, codes).double()
    known = counts.sum(dim=1)
    return (counts @ params.twister.double()) / known.clamp(min=1.0)[:, None]


def bag_errors(params, codes, what: str) -> tuple[float, float]:
    """The bag on the card against its plain version (``BAG_RTOL``,
    ``BAG_ATOL``) and float64 (``F64_ERR_RATIO`` of the plain version's
    error): its max abs error to float64, and the plain version's."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    got = pl.project_reads(params, codes)
    want = pl.project_reads_ref(params, codes)
    exact = bag_f64(params, codes)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=BAG_RTOL, atol=BAG_ATOL):
        raise AssertionError(
            "embedding bag %s differs from its plain version: max abs %.3g"
            % (what, float((got - want).abs().max()))
        )
    err = float((got.double() - exact).abs().max())
    plain_err = float((want.double() - exact).abs().max())
    if not np.isfinite(err) or err > F64_ERR_RATIO * plain_err:
        raise AssertionError(
            "embedding bag %s: max abs error to float64 %.3g, plain version %.3g"
            % (what, err, plain_err)
        )
    return err, plain_err


def bag_two_groups(params, rng, L: int) -> None:
    """The bag at 130 read sets: the kernel's passes over a full group of
    128 and a partial one of 2, the second holding a read set of one
    k-mer, against the plain version and float64."""
    import torch

    codes = read_like_codes(rng, 130, L)
    codes[129, :] = 0
    codes = torch.as_tensor(codes, device=params.twister.device)
    err, plain_err = bag_errors(params, codes, "at [130, %d]" % L)
    log("kernel embedding_bag at [130, %d] (two passes, the second of 2 read sets): "
        "max abs err to float64 %.3g, plain version %.3g" % (L, err, plain_err))


def bound(nbytes: float, flops_ms: float) -> dict:
    """The least time for the work: the larger of its bytes over the HBM
    rate and the time of its operations at peak (``flops_ms``, already in
    ms), with the side that bounds it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def tile_bound(a, b, m, na, nb) -> dict:
    """Distance tile: each input read once (a and b once when they are one
    tensor), the [Q, T] output written once; the cross term as the kernel
    computes it, three TF32 products of 2 Q T D operations each on the
    tensor cores, and 3 (Q + T) D float32 operations for the norms."""
    Q, D = a.shape
    T = b.shape[0]
    ins = a.nbytes + (0 if b.data_ptr() == a.data_ptr() else b.nbytes) + m.nbytes + na.nbytes + nb.nbytes
    ops_ms = (3 * 2.0 * Q * T * D / TF32_FLOPS + 3.0 * (Q + T) * D / F32_FLOPS) * 1e3
    return bound(ins + Q * T * 4, ops_ms)


def cdist_ms(a, b, m, na, nb) -> float:
    """One torch.cdist on the rows scaled by sqrt(m) / n: the library call
    that computes the tile's function (a yardstick; the port never calls
    it)."""
    import torch

    sm = torch.sqrt(m)[None, :]
    a_s = (a / na[:, None]) * sm
    b_s = a_s if b.data_ptr() == a.data_ptr() and nb.data_ptr() == na.data_ptr() else (b / nb[:, None]) * sm
    ms = time_ms(lambda: torch.cdist(a_s, b_s), reps=5)
    del a_s, b_s
    return ms


def tile_check(args, shape: str, strict: bool):
    """The distance tile against its plain version and float64 on the card:
    its max abs error to float64 at most F64_ERR_RATIO times the plain
    version's, and with ``strict`` allclose to the plain version.  Returns
    the tile and the three errors."""
    import torch

    from kpop_tpu_torch.ops import pairwise as pw

    got = pw.distance_tile(*args)
    want = pw.distance_tile_ref(*args)
    exact = distances_f64(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_f64 = float((got.double() - exact).abs().max())
    plain_err_f64 = float((want.double() - exact).abs().max())
    if strict and not torch.allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
        raise AssertionError(
            "distance tile differs from its plain version at %s: max abs %.3g" % (shape, err)
        )
    if not np.isfinite(err_f64) or err_f64 > F64_ERR_RATIO * plain_err_f64:
        raise AssertionError(
            "distance tile at %s: max abs error to float64 %.3g, plain version %.3g"
            % (shape, err_f64, plain_err_f64)
        )
    return got, dict(err=err, err_f64=err_f64, plain_err_f64=plain_err_f64)


def tile_row(args, shape: str, strict: bool, path: str | None) -> dict:
    """:func:`tile_check` and the median times of the tile and its plain
    version.  ``path`` names the main path whose launch count the kernel
    table prints beside this row (None: a timing row kept out of it).  The
    tile itself is returned under ``out``."""
    from kpop_tpu_torch.ops import pairwise as pw

    got, errs = tile_check(args, shape, strict)
    tol = f"err to float64 <= {F64_ERR_RATIO:g}x the plain version's"
    if strict:
        tol = f"rtol {PAIR_RTOL}, atol {PAIR_ATOL}; " + tol
    return dict(
        errs, out=got,
        ms=time_ms(lambda: pw.distance_tile(*args)),
        plain_ms=time_ms(lambda: pw.distance_tile_ref(*args)),
        library_ms=cdist_ms(*args) if path is not None else None,
        **tile_bound(*args),
        shape=shape, tol=tol,
        source="kpop_tpu_torch/csrc/pairwise.cu",
        replaces="kpop_tpu/ops/pallas_pairwise.py:43",
        launch="kpop_pairwise_dist", path=path,
    )


def raw_spectra(dev, C: int, V: int):
    """[C, V] f32 k-mer counts of related classes, made on the card from a
    seeded generator: a shared root presence at 16 % of the vocabulary
    (about 60k k-mers, two 30 kb tips per class), each class flipping 1 %
    of it, and counts of 1 or 2."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    root = torch.rand(V, device=dev, generator=gen) < 0.16
    present = root[None, :] ^ (torch.rand(C, V, device=dev, generator=gen) < 0.01)
    twice = torch.rand(C, V, device=dev, generator=gen) < 0.1
    return present.float() * (1.0 + twice.float())


def max_rel(got, want) -> float:
    """Largest |got - want| / |want| (0/0 counts as 0), in float64."""
    import torch

    got, want = got.double(), want.double()
    diff = (got - want).abs()
    return float(torch.where(diff == 0, 0.0, diff / want.abs()).max())


def digest_blocks(dev, flagship):
    """Distance blocks for the row digest, made on the card: the flagship
    batch (the tile of 2048 queries against 10,000 targets that phase 3
    checked, k=16, and at k = DIGEST_K_MAX, the most the kernel orders
    itself, and one above it), a block of repeated values with zeros of
    both signs, rows wider than shared memory (raw-spectra width), and k =
    N (``--summary-keep-at-most all``)."""
    import torch

    from kpop_tpu_torch.ops.summaries import DIGEST_K_MAX

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ties = torch.randint(0, 6, (256, DIGEST_N), generator=gen, device=dev).float()
    negative = torch.rand(ties.shape, generator=gen, device=dev) < 0.5
    ties = torch.where((ties == 0) & negative, torch.full_like(ties, -0.0), ties)
    wide = torch.rand((16, 367_987), generator=gen, device=dev)
    keep_all = torch.rand((64, 2000), generator=gen, device=dev)
    return [
        (f"[{DIGEST_B}, {DIGEST_N}] k={DIGEST_K}", flagship, DIGEST_K),
        (f"[{DIGEST_B}, {DIGEST_N}] k={DIGEST_K_MAX}", flagship, DIGEST_K_MAX),
        (f"[{DIGEST_B}, {DIGEST_N}] k={DIGEST_K_MAX + 1}", flagship, DIGEST_K_MAX + 1),
        (f"[256, {DIGEST_N}] ties and +-0, k={DIGEST_K}", ties, DIGEST_K),
        (f"[16, 367987] k={DIGEST_K}", wide, DIGEST_K),
        ("[64, 2000] k=N", keep_all, 2000),
    ]


def digest_row(dev, flagship) -> dict:
    """The row digest against its plain version on the card: median, MAD,
    the k smallest values and their columns equal (both take ties lowest
    column first); mean and std within DIGEST_RTOL of the plain version and
    of a float64 digest of the same block.  Timed at the flagship block."""
    import torch

    from kpop_tpu_torch.ops import summaries as sm

    blocks = digest_blocks(dev, flagship)
    errs = []
    for shape, dmat, k in blocks:
        (stats, top, idx), (rstats, rtop, ridx) = sm.digest_batch(dmat, k), sm.digest_batch_ref(dmat, k)
        again = sm.digest_batch(dmat, k)
        d64 = dmat.double()
        moments64 = torch.stack([d64.mean(dim=1), d64.std(dim=1)], dim=1)
        torch.cuda.synchronize()
        exact = {
            "median and MAD": torch.equal(stats[:, 2:], rstats[:, 2:]),
            "top values": torch.equal(top, rtop),
            "top columns": torch.equal(idx, ridx),
            "+0.0 zeros": not bool(torch.signbit(top[top == 0]).any()),
            "same on a second call": all(torch.equal(a, b) for a, b in zip((stats, top, idx), again)),
        }
        rel_plain = max_rel(stats[:, :2], rstats[:, :2])
        rel_f64 = max_rel(stats[:, :2], moments64)
        if not all(exact.values()) or max(rel_plain, rel_f64) > DIGEST_RTOL:
            raise AssertionError(
                "row digest differs from its plain version at %s: %s, mean/std "
                "rel %.3g to plain, %.3g to float64" % (shape, exact, rel_plain, rel_f64)
            )
        errs.append(float((stats - rstats).abs().max()))
        B, N = dmat.shape
        alone = kernel_alone_ms("kpop_row_digest", dmat.data_ptr(), B, N, k, stats.data_ptr(),
                                top.data_ptr(), idx.data_ptr())
        wrapper = time_ms(lambda: sm.digest_batch(dmat, k))
        log("kernel row_digest at %s: exact %s; mean/std rel %.3g to plain, %.3g to "
            "float64; kernel alone %.4f ms, wrapper %.4f ms"
            % (shape, sorted(exact), rel_plain, rel_f64, alone, wrapper))
        del again
    shape, dmat, k = blocks[0]
    # the block read once, the stats and the k smallest values and columns
    # written once; 2 B N operations for the moments (float32 rate)
    B, N = dmat.shape
    out_bytes = sum(t.nbytes for t in sm.digest_batch(dmat, k))
    return dict(
        bound(dmat.nbytes + out_bytes, 2.0 * B * N / F32_FLOPS * 1e3),
        library_ms=None,
        err=max(errs),
        ms=time_ms(lambda: sm.digest_batch(dmat, k)),
        plain_ms=time_ms(lambda: sm.digest_batch_ref(dmat, k), reps=5),
        shape=shape,
        tol=f"median, MAD, top values and columns torch.equal; mean/std rel {DIGEST_RTOL:g}",
        source="kpop_tpu_torch/csrc/digest.cu",
        replaces="kpop_tpu/ops/summaries.py:93",
        launch="kpop_row_digest", path="relatedness",
    )


def poisson_table(K: int, ns: int, lam: float, seed: int) -> np.ndarray:
    """[K, ns] u8 counts from a seeded Poisson generator, made in blocks."""
    rng = np.random.default_rng(seed)
    out = np.empty((K, ns), dtype=np.uint8)
    step = 1 << 15
    for i in range(0, K, step):
        out[i : i + step] = rng.poisson(lam, size=(min(step, K - i), ns))
    return out


def gram_row(dev) -> dict:
    """The residual-Gram kernel at the headline training shape against its
    plain version and a numpy float64 Gram of the same residual, each
    within GRAM_RTOL of the largest |G|; timed with the plain version and,
    as the yardstick, one cuBLAS DGEMM S^T S on a pre-built float64 S."""
    import torch

    from kpop_tpu_torch.ops import gram
    from kpop_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    table = poisson_table(GRAM_K, GRAM_NS, GRAM_LAMBDA, seed=4)
    alpha, u, beta, v, r, _ = sharded.residual_vectors(table, None)
    alpha = alpha * (r > 0)
    want = np.zeros((GRAM_NS, GRAM_NS))
    step = 1 << 15
    for i in range(0, GRAM_K, step):
        S = table[i : i + step] * alpha[i : i + step, None] * beta[None, :] - np.outer(u[i : i + step], v)
        want += S.T @ S
    del S
    host_s = time.perf_counter() - t0
    x = torch.as_tensor(table, device=dev)
    vecs = [torch.as_tensor(a, device=dev) for a in (alpha, u, beta, v)]
    got = gram.residual_gram(x, *vecs)
    plain = gram.residual_gram_ref(x, *vecs)
    again = gram.residual_gram(x, *vecs)
    torch.cuda.synchronize()
    scale = float(np.abs(want).max())
    g, pl_ = got.cpu().numpy(), plain.cpu().numpy()
    rel_f64 = float(np.abs(g - want).max()) / scale
    rel_plain = float(np.abs(g - pl_).max()) / scale
    plain_rel_f64 = float(np.abs(pl_ - want).max()) / scale
    log("kernel ca_gram at [%d, %d] u8: max |G - plain| %.3g, |G - numpy float64| %.3g "
        "(plain %.3g) of max |G| %.6g; symmetric %s, bit-identical on a second call %s "
        "(numpy reference %.1f s)"
        % (GRAM_K, GRAM_NS, rel_plain, rel_f64, plain_rel_f64, scale,
           bool(np.array_equal(g, g.T)), bool(torch.equal(got, again)), host_s))
    if not (rel_f64 <= GRAM_RTOL and rel_plain <= GRAM_RTOL) or not torch.equal(got, again):
        raise AssertionError(
            f"ca_gram off float64: {rel_plain:.3g} to plain, {rel_f64:.3g} to numpy "
            f"(bound {GRAM_RTOL:g} of max |G|), reproducible {bool(torch.equal(got, again))}"
        )
    ms = time_ms(lambda: gram.residual_gram(x, *vecs))
    plain_ms = time_ms(lambda: gram.residual_gram_ref(x, *vecs), reps=5)
    S = gram.residual(x, *vecs)
    library_ms = time_ms(lambda: S.T @ S, reps=5)
    del S
    K, ns = GRAM_K, GRAM_NS
    # the table and the vectors read once, G written once; K ns (ns + 1)
    # operations for the distinct entries of G on the FP64 tensor cores,
    # 3 K ns for the rebuild outside them
    nbytes = x.nbytes + sum(t.nbytes for t in vecs) + got.nbytes
    row = dict(
        bound(nbytes, (K * ns * (ns + 1.0) / F64_TC_FLOPS + 3.0 * K * ns / F64_FLOPS) * 1e3),
        err=float(np.abs(g - pl_).max()), err_f64=rel_f64 * scale, plain_err_f64=plain_rel_f64 * scale,
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        shape=f"[{K}, {ns}] u8 Poisson({GRAM_LAMBDA:g}) table",
        tol=f"rel {GRAM_RTOL:g} of max |G| to plain and to numpy float64; bit-reproducible",
        source="kpop_tpu_torch/csrc/ca_gram.cu",
        replaces="kpop_tpu/parallel/sharded.py:174",
        launch="kpop_ca_gram", path="train",
    )
    del x, vecs, got, plain, again
    torch.cuda.empty_cache()
    return row


def count_check(params, codes, what: str):
    """The count on the card torch.equal to its plain version and to
    itself on a second call; logs the wrapper's time and the kernels'
    alone.  Returns the spectra."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    got = pl.count_spectra(params, codes)
    again = pl.count_spectra(params, codes)
    want = pl.count_spectra_ref(params, codes)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError(
            "count_spectra at %s differs from its plain version at %d cells, from itself at %d"
            % (what, int((got != want).sum()), int((got != again).sum())))
    B, L = codes.shape
    W = L - params.k + 1
    Wp = -(-W // pl.COUNT_RUN) * pl.COUNT_RUN
    scratch = torch.empty(B * Wp, dtype=torch.int32, device=codes.device)
    out = torch.empty_like(got)
    suffix, vocab = pl.vocab_args("count_spectra", params, codes)
    alone = kernel_alone_ms(
        "kpop_count_spectra" + suffix, codes.data_ptr(), B, L, params.k, int(params.canonical),
        params.base, *vocab, params.n_vocab, scratch.data_ptr(), out.data_ptr())
    wrapper = time_ms(lambda: pl.count_spectra(params, codes))
    bits, cells, slices = pl.count_plan(W, params.n_vocab)
    log("kernel count_spectra at %s: %s (plain and a second call); %d slices of %d u%d "
        "counters; kernels alone %.4f ms, wrapper %.4f ms"
        % (what, COUNT_TOL, slices, cells, bits, alone, wrapper))
    del again, want, scratch, out
    return got


def count_blocks(dev, rng, L: int) -> dict:
    """More count inputs: 130 read sets (the walkers' last pass partial), a
    vocabulary of 100,003 k-mers (not a multiple of a slice, its last row
    hit by a read set of one k-mer), and a protein LUT (base 20, k = 5,
    200,000 k-mers)."""
    import torch

    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    def params_of(lut, V, k, canonical, base):
        z = torch.zeros(4, dtype=torch.float32, device=dev)
        return ClassifierParams(torch.as_tensor(lut, device=dev),
                                torch.zeros((V, 4), dtype=torch.float32, device=dev), z,
                                torch.zeros((1, 4), dtype=torch.float32, device=dev),
                                torch.ones(1, dtype=torch.float32, device=dev),
                                k=k, canonical=canonical, base=base)

    def lut_of(n, V):
        lut = np.full(n + 1, V, dtype=np.int32)
        perm = rng.permutation(n)
        perm = np.concatenate([perm[perm != 0][: V - 1], [0]])  # all-zero k-mer: row V - 1
        lut[perm] = np.arange(V, dtype=np.int32)
        return lut

    out = {}
    V = 367_987
    out[f"[130, {L}], V={V}"] = (
        params_of(lut_of(4**K, V), V, K, True, 4),
        torch.as_tensor(read_like_codes(rng, 130, L), device=dev))
    V = 100_003
    out[f"[128, {L}], V={V}"] = (
        params_of(lut_of(4**K, V), V, K, True, 4),
        torch.as_tensor(read_like_codes(rng, 128, L), device=dev))
    V, kp = 200_000, 5
    codes = rng.integers(0, 20, size=(128, 10_000), dtype=np.int8)
    codes[:, 100::101] = -1
    codes[1, :] = 0
    out[f"protein [128, 10000], base 20, k={kp}, V={V}"] = (
        params_of(lut_of(20**kp, V), V, kp, False, 20), torch.as_tensor(codes, device=dev))
    return out


def wide_vocabulary(rng, codes, k: int, base: int, canonical: bool, V: int) -> np.ndarray:
    """V distinct uint64 k-mer codes, in no order: a quarter of the valid
    window codes of ``codes`` (so that each read set hits some of its
    k-mers and misses others), the all-zero k-mer, and random codes."""
    import torch

    from kpop_tpu_torch.ops.encode import split_k, window_codes_batch_wide

    hi, lo, ok = window_codes_batch_wide(codes, k, canonical, base)
    full = (hi.long() * base ** split_k(k, base)[1] + lo.long())[ok]
    seen = torch.unique(full).cpu().numpy().astype(np.uint64)
    del hi, lo, ok, full
    seen = seen[seen != 0]
    picked = seen[rng.random(len(seen)) < 0.25][: V - 1]
    extra = rng.integers(0, base**k, size=2 * V, dtype=np.uint64)
    extra = np.setdiff1d(extra, np.concatenate([picked, [0]]).astype(np.uint64))
    out = np.concatenate([[0], picked, rng.permutation(extra)[: V - 1 - len(picked)]]).astype(np.uint64)
    assert len(out) == V and len(np.unique(out)) == V
    return rng.permutation(out)


def wide_blocks(dev, rng, codes, twister) -> dict:
    """Large-k inputs for the wide count and bag, each with classifier
    parameters around a random twister: phase 3's batch at k = 16 with
    V = LARGE_K_VOCAB (the phase 7 vocabulary's size; a cuckoo table of [6,
    2^21]) on the cuckoo hash and on the sorted-limb fallback, the same
    batch at DNA-ds k = 30 (two 30-bit limbs, V = 367,987), and protein
    read sets at k = 8 (base 20, V = 200,000)."""
    import torch

    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.ops import pipeline as pl
    from kpop_tpu_torch.ops.encode import split_k

    def params_of(space, kmer_codes, tw, sorted_limbs=False):
        if sorted_limbs:  # the fallback the builder takes when no seed converges
            limb = np.uint64(space.base ** split_k(space.k, space.base)[1])
            ordered = np.sort(kmer_codes)
            vocab = dict(vocab_lut=None, vocab_hi=(ordered // limb).astype(np.int32),
                         vocab_lo=(ordered % limb).astype(np.int32))
        else:
            vocab, _order = pl.wide_vocab(space, kmer_codes)
        vocab = {n: torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
                 for n, a in vocab.items()}
        d = tw.shape[1]
        return pl.ClassifierParams(
            twister=tw, metric=torch.full((d,), 1.0 / d, device=dev),
            class_coords=torch.zeros((1, d), device=dev), class_norms=torch.ones(1, device=dev),
            k=space.k, canonical=space.canonical, base=space.base, **vocab)

    B, L = codes.shape
    out = {}
    space = KmerSpace("DNA-ds", LARGE_K)
    kmers = wide_vocabulary(rng, codes, LARGE_K, 4, True, LARGE_K_VOCAB)
    out[f"[{B}, {L}], k={LARGE_K}, V={LARGE_K_VOCAB}, cuckoo"] = (params_of(space, kmers, twister), codes)
    out[f"[{B}, {L}], k={LARGE_K}, V={LARGE_K_VOCAB}, sorted limbs"] = (
        params_of(space, kmers, twister, sorted_limbs=True), codes)
    V = 367_987
    space = KmerSpace("DNA-ds", 30)
    kmers = wide_vocabulary(rng, codes, 30, 4, True, V)
    out[f"[{B}, {L}], k=30, V={V}, cuckoo"] = (params_of(space, kmers, twister[:V]), codes)
    V = 200_000
    space = KmerSpace("protein", 8)
    prot = rng.integers(0, 20, size=(128, 10_000), dtype=np.int8)
    prot[:, 100::101] = -1
    prot[1, :] = 0
    prot = torch.as_tensor(prot, device=dev)
    kmers = wide_vocabulary(rng, prot, 8, 20, False, V)
    out[f"protein [128, 10000], base 20, k=8, V={V}, cuckoo"] = (
        params_of(space, kmers, twister[:V]), prot)
    return out


def wide_rows(dev, rng, codes, d: int) -> dict:
    """The wide count and bag against their plain versions on every
    :func:`wide_blocks` input (the count torch.equal to the plain version
    and to a second call, the bag within BAG_RTOL/BAG_ATOL and the float64
    check), each count input with its kernels' time alone and its
    wrapper's; the rows of the kernel table at the first input."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    twister = torch.randn((LARGE_K_VOCAB, d), generator=torch.Generator(dev).manual_seed(6),
                          device=dev)
    blocks = wide_blocks(dev, rng, codes, twister)
    rows = {}
    for i, (what, (params, c)) in enumerate(blocks.items()):
        got = count_check(params, c, what)
        err, plain_err = bag_errors(params, c, what)
        table = params.cuckoo if params.cuckoo is not None else torch.cat([params.vocab_hi, params.vocab_lo])
        log("kernel embedding_bag_wide at %s: max abs err to float64 %.3g, plain version %.3g; "
            "table %.1f MB" % (what, err, plain_err, table.nbytes / 1e6))
        # the lookup's share: device ms of each launch of one call
        # (torch.profiler), the count's lookup and slices, the bag's stages
        for name, fn in (("count", pl.count_spectra), ("bag", pl.project_reads)):
            by_kernel = device_ms_by_kernel(lambda: fn(params, c))
            log("kernel %s_wide at %s, device ms by launch: %s" % (name, what, ", ".join(
                "%s %.4f" % (k.replace("void ", "").replace("(anonymous namespace)::", "")
                             .split("(")[0][:32], v)
                for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1]))))
        if i:
            del got
            continue
        B, L = c.shape
        W = L - params.k + 1
        idx = pl.vocab_lookup(params, c)
        known = idx < params.n_vocab
        hit = int(torch.unique(idx[known]).numel())
        n_known = int(known.sum())
        del idx, known
        log("kernel wide lookup at %s: %d of %d windows known, %d distinct rows hit"
            % (what, n_known, B * W, hit))
        common = dict(library_ms=None, shape=what, path="large_k",
                      replaces="kpop_tpu/ops/cuckoo.py:121")
        # codes and the table read once, the [B, V] spectra written once;
        # one add per window
        rows["count_spectra_wide"] = dict(
            bound(c.nbytes + table.nbytes + got.nbytes, B * W / F32_FLOPS * 1e3),
            err=0.0, tol=COUNT_TOL,
            ms=time_ms(lambda: pl.count_spectra(params, c)),
            plain_ms=time_ms(lambda: pl.count_spectra_ref(params, c), reps=3),
            source="kpop_tpu_torch/csrc/count_spectra.cu", launch="kpop_count_spectra_wide",
            **common)
        del got
        bag = pl.project_reads(params, c)
        # codes and the table read once, each hit twister row read once, the
        # [B, d] output written once; an add per known window and column
        rows["embedding_bag_wide"] = dict(
            bound(c.nbytes + table.nbytes + hit * d * 4 + bag.nbytes, float(n_known) * d / F32_FLOPS * 1e3),
            err=float((bag - pl.project_reads_ref(params, c)).abs().max()),
            err_f64=err, plain_err_f64=plain_err,
            tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}; err to float64 <= {F64_ERR_RATIO:g}x the plain version's",
            ms=time_ms(lambda: pl.project_reads(params, c), reps=5),
            plain_ms=time_ms(lambda: pl.project_reads_ref(params, c), reps=3),
            source="kpop_tpu_torch/csrc/embedding_bag.cu", launch="kpop_embedding_bag_wide",
            **common)
        del bag
    del blocks, twister
    torch.cuda.empty_cache()
    return rows


def phase_kernels(dev, B: int, L: int, V: int, d: int, C: int, big: int):
    import torch

    from kpop_tpu_torch.ops import pairwise as pw
    from kpop_tpu_torch.ops import pipeline as pl

    rng = np.random.default_rng(1)
    params = random_params(rng, dev, V, d, C)
    codes = torch.as_tensor(read_like_codes(rng, B, L), device=dev)
    rows = {}

    got = count_check(params, codes, f"[{B}, {L}], V={V}")
    if float(got[1].max()) < L - 300 - K:
        raise AssertionError("a repeated k-mer was not counted every time")
    for what, (p_, c_) in count_blocks(dev, np.random.default_rng(5), L).items():
        count_check(p_, c_, what)
        del p_, c_
    # codes and LUT read once, the [B, V] spectra written once; one add per
    # window
    rows["count_spectra"] = dict(
        bound(codes.nbytes + params.vocab_lut.nbytes + got.nbytes, B * (L - K + 1) / F32_FLOPS * 1e3),
        library_ms=None,
        err=0.0,
        ms=time_ms(lambda: pl.count_spectra(params, codes)),
        plain_ms=time_ms(lambda: pl.count_spectra_ref(params, codes), reps=5),
        shape=f"[{B}, {L}] int8 codes, k={K}, V={V}", tol=COUNT_TOL,
        source="kpop_tpu_torch/csrc/count_spectra.cu",
        replaces="kpop_tpu/ops/pipeline.py:179",
        launch="kpop_count_spectra", path="slice",
    )
    del got

    bag_err_f64, bag_plain_err_f64 = bag_errors(params, codes, "at the slice's batch")
    bag_two_groups(params, np.random.default_rng(3), L)
    got = pl.project_reads(params, codes)
    want = pl.project_reads_ref(params, codes)
    # codes and LUT read once, each twister row the reads hit read once, the
    # [B, d] output written once; an add per known window and column.  The
    # library call: F.embedding_bag over the looked-up indices, weighted by
    # 1 / n_known per read set (the same function in one call)
    idx = pl.vocab_lookup(params, codes)
    known = idx < V
    flat = idx[known].long()
    per_row = known.sum(dim=1)
    offsets = torch.cumsum(per_row, 0) - per_row
    weights = (1.0 / torch.clamp(per_row, min=1).float()).repeat_interleave(per_row)
    bag_lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        flat, params.twister, offsets, mode="sum", per_sample_weights=weights)
    # the library sums each bag in f32 in one sequence: on the row that
    # repeats one k-mer 30,199 times that drifts to about 3e-4 relative
    lib_err = float((bag_lib() - want).abs().max())
    if not lib_err <= LIBRARY_RTOL * float(want.abs().max()):
        raise AssertionError(f"F.embedding_bag does not compute the bag's function: {lib_err:.3g}")
    hit = int(torch.unique(flat).numel())
    # what a gather of one row per known window moves, against the hit
    # rows read once
    log("kernel embedding_bag: %d known windows hit %d distinct rows of %d; a row per "
        "window gathers %.4g GB, the hit rows once %.4g GB (each hit row %.2fx a batch); "
        "max abs err to float64 %.3g, plain version %.3g"
        % (flat.numel(), hit, V, flat.numel() * 4.0 * d / 1e9, hit * 4.0 * d / 1e9,
           flat.numel() / max(hit, 1), bag_err_f64, bag_plain_err_f64))
    rows["embedding_bag"] = dict(
        bound(codes.nbytes + params.vocab_lut.nbytes + hit * d * 4 + got.nbytes,
              float(flat.numel()) * d / F32_FLOPS * 1e3),
        library_ms=time_ms(bag_lib, reps=5),
        err=float((got - want).abs().max()),
        err_f64=bag_err_f64, plain_err_f64=bag_plain_err_f64,
        ms=time_ms(lambda: pl.project_reads(params, codes), reps=5),
        plain_ms=time_ms(lambda: pl.project_reads_ref(params, codes), reps=3),
        shape=f"[{B}, {L}] int8 codes, k={K}, twister [{V}, {d}]",
        tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}; err to float64 <= {F64_ERR_RATIO:g}x the plain version's",
        source="kpop_tpu_torch/csrc/embedding_bag.cu",
        replaces="kpop_tpu/ops/pipeline.py:200",
        launch="kpop_embedding_bag", path="slice",
    )
    del idx, known, flat, per_row, offsets, weights, bag_lib
    rows.update(wide_rows(dev, np.random.default_rng(7), codes, d))

    # the distance tile at four shapes.  The slice's: [B, d] twisted reads
    # against [C, d] classes, with the class norms of the parameters, as
    # distances_to_classes calls it
    twisted = got
    m = params.metric
    args = (twisted, params.class_coords, m, pw.row_norms(twisted, m), params.class_norms)
    rows["pairwise_dist"] = tile_row(
        args, f"[{B}, {d}] x [{C}, {d}]", strict=True, path="slice"
    )
    del got, want, args
    # the relatedness engine's: phase 6's batch of normalized queries
    # against its targets (a ragged target edge), and its last, shorter
    # batch; the batch's tile feeds the row digest below
    D = REL_D
    q = torch.as_tensor(rng.standard_normal((DIGEST_B, D), dtype=np.float32), device=dev)
    t = torch.as_tensor(rng.standard_normal((REL_T, D), dtype=np.float32), device=dev)
    mr = torch.full((D,), 1.0 / D, dtype=torch.float32, device=dev)
    nq, nt = pw.row_norms(q, mr), pw.row_norms(t, mr)
    rows["pairwise_dist_relatedness"] = tile_row(
        (q, t, mr, nq, nt), f"[{DIGEST_B}, {D}] x [{REL_T}, {D}]", strict=True,
        path="relatedness",
    )
    tail = REL_Q % DIGEST_B
    _, tail_errs = tile_check(
        (q[:tail], t, mr, nq[:tail], nt), f"[{tail}, {D}] x [{REL_T}, {D}]", strict=True
    )
    log("kernel pairwise_dist at the last relatedness batch [%d, %d] x [%d, %d]: "
        "max abs err %.3g to plain, %.3g to float64 (plain %.3g)"
        % (tail, D, REL_T, D, tail_errs["err"], tail_errs["err_f64"], tail_errs["plain_err_f64"]))
    flagship = rows["pairwise_dist_relatedness"].pop("out")
    del q, t, mr, nq, nt
    # the square block the tile was tuned at: a timing row, off the
    # kernel table (no main path launches this shape)
    a = torch.as_tensor(rng.standard_normal((big, 512), dtype=np.float32), device=dev)
    b = torch.as_tensor(rng.standard_normal((big, 512), dtype=np.float32), device=dev)
    mb = torch.as_tensor(rng.random(512, dtype=np.float32), device=dev)
    args = (a, b, mb, pw.row_norms(a, mb), pw.row_norms(b, mb))
    rows["pairwise_dist_square"] = tile_row(
        args, f"[{big}, 512] x [{big}, 512]", strict=True, path=None
    )
    del a, b, mb, args
    # C raw class spectra against themselves, as kpop-countdb --distances
    # --backend pallas computes them (metric 1, rows normalized)
    a = raw_spectra(dev, C, V)
    ones = torch.ones(V, dtype=torch.float32, device=dev)
    na = pw.row_norms(a, ones)
    rows["pairwise_dist_raw_spectra"] = tile_row(
        (a, a, ones, na, na), f"[{C}, {V}] x [{C}, {V}] counts", strict=False,
        path="countdb_distances",
    )
    del a, ones, na
    for r in rows.values():
        r.pop("out", None)
    rows["row_digest"] = digest_row(dev, flagship)
    del flagship
    torch.cuda.empty_cache()
    rows["ca_gram"] = gram_row(dev)
    for name, r in rows.items():
        log(
            "kernel %-26s %s: max abs err %.3g (%s); kernel %.4f ms, plain "
            "%.4f ms, library %s ms, bound %.4f ms (%s)"
            % (name, r["shape"], r["err"], r["tol"], r["ms"], r["plain_ms"],
               "%.4f" % r["library_ms"] if r["library_ms"] is not None else "none",
               r["bound_ms"], r["bound_by"])
        )
    return rows


# ---------------- phase 4: the slice at the headline shape ---------------


def load_phylo():
    spec = importlib.util.spec_from_file_location(
        "kpop_smoke_phylo", os.path.join(REPO, "tests", "data", "phylo.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve through sys.modules
    spec.loader.exec_module(mod)
    return mod


def simulate_corpus(rng, n_classes: int, genome_len: int, tips_per_class=4,
                    between=0.08, within=0.15, rate=0.01) -> dict:
    """The genomes of the covid-shaped corpus of bench.py
    (``_build_corpus``): sibling clades of a random tree.  Returns each
    class's (tip number, base codes) by class index."""
    phylo = load_phylo()
    tree = phylo.random_clade_tree(
        rng, n_classes, tips_per_class, between=between, within=within
    )
    root = rng.integers(0, 4, size=genome_len)
    seqs = phylo.sim_seq(rng, tree, root, rate=rate)
    by_class: dict = {}
    for name, codes in seqs.items():
        by_class.setdefault(int(name.split("-")[1]) - 1, []).append(
            (int(name.split("-")[0]), codes)
        )
    return by_class


def count_corpus(by_class: dict, k: int):
    """The corpus counted at ``k`` (no draw from the rng): the first half
    of each clade's tips summed as the class's training counts, the rest
    held out.  Returns (space, vocabulary hex labels, [K, C] int32 table,
    held-out (class, codes))."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.kmers import KmerSpace

    space = KmerSpace("DNA-ds", k)
    n_classes = len(by_class)
    vocab_index: dict = {}
    cols, held_out = [], []
    for c in range(n_classes):
        members = sorted(by_class[c], key=lambda m: m[0])
        half = len(members) // 2
        train = ["".join("ACGT"[b] for b in g) for _, g in members[:half]]
        held_out.extend((c, g.astype(np.int8)) for _, g in members[half:])
        codes, counts = spectrum_of_sequences(space, train)
        rows = np.empty(len(codes), dtype=np.int64)
        for i, cd in enumerate(codes):
            rows[i] = vocab_index.setdefault(int(cd), len(vocab_index))
        cols.append((rows, counts))
    table = np.zeros((len(vocab_index), n_classes), dtype=np.int32)
    for c, (rows, counts) in enumerate(cols):
        table[rows, c] = counts
    inv = np.empty(len(vocab_index), dtype=np.uint64)
    for code, row in vocab_index.items():
        inv[row] = code
    return space, [space.code_to_hex(int(cd)) for cd in inv], table, held_out


def read_set_batches(rng, held_out, batch: int):
    """Each held-out tip as one query: its 150 bp read pairs at 1x coverage
    (tests/data/phylo.py sim_paired_reads) joined by 'N' breaks, in batches
    of ``batch`` (bench.py's serving payload)."""
    phylo = load_phylo()
    perm = rng.permutation(len(held_out))
    batches = []
    for b0 in range(0, len(held_out) - batch + 1, batch):
        tips = [held_out[j] for j in perm[b0 : b0 + batch]]
        seqs = []
        for _c, g in tips:
            r1, r2 = phylo.sim_paired_reads(rng, g.astype(np.int64), coverage=1.0)
            seqs.append("N".join(r1 + r2))
        batches.append((np.array([c for c, _ in tips], dtype=np.int64), seqs))
    return batches


def serve(step, batches):
    """The serve loop of kpop-classify: dispatch a batch, then materialize
    the previous one (one batch in flight).  Returns the [B, C] distance
    blocks in order."""
    out, pending = [], None
    for _truth, seqs in batches:
        handle = step.dispatch(seqs)
        if pending is not None:
            out.append(step.materialize(pending))
        pending = handle
    out.append(step.materialize(pending))
    return out


def device_ms_by_kernel(fn) -> dict:
    """Device time of one run of ``fn()`` in ms, summed per kernel name by
    ``torch.profiler`` (copies included; the host ops that launched them
    are not counted again)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return out


def serve_routes(label: str, params, batches, kernels) -> tuple:
    """The main path: the read sets served on the dense and the bag route,
    every launch count set to 0 just before and read just after, each of
    ``kernels`` launched; finite [read sets, classes] distances and top-1
    accuracy >= ACCURACY_GATE on each route; then each route's device time
    a batch and its largest kernels.  Returns (distance blocks by route,
    launches, accuracy, device ms a batch)."""
    from kpop_tpu_torch import _build
    from kpop_tpu_torch.cli.classify import DeviceStep

    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    dmats = {path: serve(DeviceStep(params, path), batches) for path in ("dense", "bag")}
    launches = dict(_build.LAUNCHES)
    log("%s: kernel launches on the main path: %s" % (label, json.dumps(launches)))
    missing = [name for name in kernels if launches[name] == 0]
    if missing:
        raise AssertionError("%s: kernels never launched on the main path: %s" % (label, missing))
    truth = np.concatenate([t for t, _ in batches])
    accuracy = {}
    for path, blocks in dmats.items():
        dmat = np.concatenate(blocks)
        if dmat.shape != (len(truth), params.class_coords.shape[0]) or not np.isfinite(dmat).all():
            raise AssertionError(f"{label}, {path}: bad distances {dmat.shape}")
        accuracy[path] = float((dmat.argmin(axis=1) == truth).mean())
        log("%s: %s route top-1 accuracy %.4f over %d read sets"
            % (label, path, accuracy[path], len(truth)))
        if accuracy[path] < ACCURACY_GATE:
            raise AssertionError(f"{label}, {path}: accuracy {accuracy[path]} < {ACCURACY_GATE}")
    busy = {}
    for path in ("dense", "bag"):
        by_kernel = device_ms_by_kernel(lambda: serve(DeviceStep(params, path), batches))
        busy[path] = sum(by_kernel.values()) / len(batches)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
        log("%s: %s route device time %.4f ms a batch of %d (torch.profiler), largest: %s"
            % (label, path, busy[path], len(batches[0][0]),
               ", ".join("%s %.4f" % (k[:40], v / len(batches)) for k, v in top)))
    return dmats, launches, accuracy, busy


def host_chain_distances(space, twister, coords, metric_vec, seqs):
    """Host float64 golden chain: Twister.project_entries, then
    distance_rowwise against the classes."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.kmers import hex_labels_vectorized
    from kpop_tpu_torch.core.matrix import NamedMatrix
    from kpop_tpu_torch.core.space import Distance, distance_rowwise

    entries = []
    for s in seqs:
        codes, counts = spectrum_of_sequences(space, [s])
        labels = hex_labels_vectorized(codes, space.hex_width)
        entries.append(list(zip(labels, counts.astype(np.float64))))
    projected = twister.project_entries(entries)
    dims = list(twister.dim_names)
    tmat = NamedMatrix(["c%d" % i for i in range(len(coords))], dims, coords)
    qmat = NamedMatrix(["q%d" % i for i in range(len(seqs))], dims, projected)
    return distance_rowwise(Distance.of_string("euclidean"), metric_vec, tmat, qmat).data


def ca_errors(coords, inertia, twister, sv, host) -> dict:
    """Max abs errors of a device CA fit against the host float64 fit_ca:
    sv, inertia, and per column up to sign (tests/test_ca_streamed.py:
    32-37) the sample coordinates and the [K, d] twister."""
    tw = twister.cpu().numpy()
    err = dict(sv=float(np.abs(sv - host.sv).max()),
               inertia=float(np.abs(inertia - host.inertia).max()), coords=0.0, twister=0.0)
    for j in range(len(host.sv)):
        a, b = coords[:, j], host.sample_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        err["coords"] = max(err["coords"], float(np.abs(a - sign * b).max()))
        err["twister"] = max(
            err["twister"], float(np.abs(tw[:, j].astype(np.float64) - sign * host.twister[j]).max())
        )
    return err


def phase_slice(dev, n_classes: int, genome_len: int, batch: int, card: str):
    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.cli.classify import DeviceStep, pick_path
    from kpop_tpu_torch.core.ca import fit_ca
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu_torch.core.space import Metric
    from kpop_tpu_torch.core.twister import Twister
    from kpop_tpu_torch.ops.pipeline import params_around_twister
    from kpop_tpu_torch.parallel import sharded

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genomes = simulate_corpus(rng, n_classes, genome_len)
    space, vocab_hex, table, held_out = count_corpus(genomes, K)
    log("slice: corpus of %d classes, vocabulary %d, %d held-out tips (%.1f s)"
        % (n_classes, table.shape[0], len(held_out), time.perf_counter() - t0))
    t0 = time.perf_counter()
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    ca = fit_ca(table * col_w[None, :])
    d = ca.n_dims
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(ca.dim_names, vocab_hex, ca.twister)),
        KPopMatrix(
            MatrixType.INERTIA,
            NamedMatrix(["inertia"], ca.dim_names, ca.inertia[None, :]),
        ),
    )
    log("slice: host float64 CA fit (the reference), twister [%d, %d] (%.1f s)"
        % (len(vocab_hex), d, time.perf_counter() - t0))

    # the train path: the device CA as bench.py:509-511 calls it, the
    # twister left on the card; every count set to 0 just before, read
    # just after
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    coords, inertia, phi_dev, sv = sharded.ca_fit_sharded(
        table, col_weights=col_w, phi="device", device=dev
    )
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    phases = dict(sharded.LAST_CA_PHASES)
    log("slice: device CA fit on the %s wire, %.3f s: %s; launches %s; on %s"
        % (sharded.LAST_DD_UPLOAD, train_s,
           ", ".join("%s %.4f s" % kv for kv in phases.items()),
           json.dumps(train_launches), card))
    if not train_launches["kpop_ca_gram"]:
        raise AssertionError("the train path never launched the Gram kernel")
    if phi_dev.shape != (len(vocab_hex), d) or phi_dev.dtype != torch.float32 or phi_dev.device.type != dev.type:
        raise AssertionError(f"device twister {phi_dev.dtype} {tuple(phi_dev.shape)} on {phi_dev.device}")
    # the f32 twister on the card cannot hold entries of a few hundred to
    # 1e-5, so the bounds hold the same fit with phi="host" (float64), and
    # the card's twister must be exactly that fit rounded to f32
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    coords64, inertia64, tw64, sv64 = sharded.ca_fit_sharded(table, col_weights=col_w, device=dev)
    peak = torch.cuda.max_memory_allocated() - live
    log("slice: device CA fit with phi on the host: peak device memory %.4g GB above the "
        "%.4g GB live before it; a float64 twister kept on the card would be %.4g GB"
        % (peak / 1e9, live / 1e9, tw64.size * 8 / 1e9))
    tw64 = torch.as_tensor(np.ascontiguousarray(tw64.T))
    rounded = torch.equal(phi_dev.cpu(), tw64.float())
    same = all(np.array_equal(a, b) for a, b in ((coords, coords64), (inertia, inertia64), (sv, sv64)))
    ca_err = ca_errors(coords64, inertia64, tw64, sv64, ca)
    log("slice: device CA (phi on the host, float64) vs host fit_ca, max abs (columns up "
        "to sign): %s; bounds %s; the card's twister is that fit rounded to f32: %s, its "
        "other outputs equal: %s; max |twister| %.6g (%.1f s)"
        % (json.dumps(ca_err), json.dumps(CA_BOUNDS), rounded, same,
           float(tw64.abs().max()), time.perf_counter() - t0))
    bad = {k: v for k, v in ca_err.items() if not v <= CA_BOUNDS[k]}
    if bad or not (rounded and same):
        raise AssertionError(f"device CA off the host float64 fit: {bad}, f32 rounding {rounded}, "
                             f"outputs equal {same}")
    del tw64

    # serving parameters around the device twister (bench.py:563-589), no
    # download and no re-upload
    t0 = time.perf_counter()
    params = params_around_twister(space, vocab_hex, phi_dev, inertia, coords)
    torch.cuda.synchronize()
    log("slice: classifier parameters around the device twister, %.1f MB (%.1f s)"
        % (params.twister.numel() * 4 / 1e6, time.perf_counter() - t0))
    batches = read_set_batches(rng, held_out, batch)
    n_seqs = sum(len(t) for t, _ in batches)
    width = max(len(s) for _, seqs in batches for s in seqs)
    dmats, launches, accuracy, _busy = serve_routes("slice", params, batches, SLICE_KERNELS)

    t0 = time.perf_counter()
    metric_vec = twister.metrics_vector(Metric.of_string("powers(1,1,2)"))
    want = host_chain_distances(space, twister, ca.sample_coords, metric_vec, batches[0][1])
    host_err = {path: float(np.abs(blocks[0] - want).max()) for path, blocks in dmats.items()}
    log("slice: first batch vs host float64 chain: max abs %s (bound %g; %.1f s)"
        % (json.dumps(host_err), HOST_CHAIN_ATOL, time.perf_counter() - t0))
    if max(host_err.values()) > HOST_CHAIN_ATOL:
        raise AssertionError(f"distances off the host float64 chain: {host_err}")

    # serving rate: host encode, upload, device step and download, one
    # batch in flight, route picked as kpop-classify's default 'auto' does
    auto = pick_path(batch, width - K + 1, params.n_vocab, d)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve(DeviceStep(params, "auto"), batches)
        rates.append(n_seqs / (time.perf_counter() - t0))
    log("slice: serving %s seqs/s over %d read sets per pass (route %s; "
        "host encode + upload + device step + download), on %s"
        % ([round(r, 1) for r in rates], n_seqs, auto, card))
    return dict(launches=launches, train_launches=train_launches, accuracy=accuracy,
                host_err=host_err, seqs_per_s=rates, vocab=params.n_vocab, d=d,
                train_s=train_s, train_phases=phases, ca_err=ca_err, table=table,
                genomes=genomes, batches=batches)


# ---------------- phase 5: the quick start through the CLI ---------------


def run_default_cli(name: str, argv: list[str], want: tuple[str, ...]) -> dict:
    """One of the port's CLIs in this process, with no --backend and
    KPOP_PLATFORM unset (the port's default: the card): its launches, each
    count set to 0 just before and read just after, must include ``want``."""
    import importlib

    from kpop_tpu_torch import _build

    main = importlib.import_module(f"kpop_tpu_torch.cli.{name}").main
    os.environ.pop("KPOP_PLATFORM", None)
    for kernel in _build.LAUNCHES:
        _build.LAUNCHES[kernel] = 0
    if main(argv) != 0:
        raise AssertionError(f"kpop-{name}-torch {' '.join(argv)} failed")
    launches = dict(_build.LAUNCHES)
    log("cli: kpop-%s-torch with the default backend, kernel launches %s"
        % (name, json.dumps(launches)))
    missing = [kernel for kernel in want if not launches[kernel]]
    if missing:
        raise AssertionError(f"kpop-{name}-torch's default backend never launched {missing}")
    return launches


def phase_cli() -> dict:
    """The quick start: counted by the JAX tools, trained by
    kpop-twist-torch, classified by kpop-classify-torch, summarized by
    kpop-twistdb-torch -s and the class distances by kpop-countdb-torch
    --distances.  The three relatedness and training tools run here in
    this process with their default backend; the JAX tools give the host
    float64 lines and distances they are held to."""
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType

    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = REPO
    env.pop("KPOP_PLATFORM", None)  # the port's default: the card
    counts = (
        "set -eo pipefail\n"
        f"{sys.executable} {REPO}/tests/data/make_clusters.py clusters-small.fasta\n"
        "for CLASS in C1 C2 C3 C4 C5 C6 C7 C8 C9 C10; do cat clusters-small.fasta |\n"
        "  awk -v CLASS=$CLASS '{nr=(NR-1)%4; ok=(nr==0?$0~(\"-\"CLASS\"$\"):nr==1&&ok); if (ok) print}' |\n"
        "  kpop-count -k 5 -L -f /dev/stdin |\n"
        "  kpop-countdb -k /dev/stdin -R '~.' -A $CLASS -L $CLASS -N -D -t /dev/stdout\n"
        "done | kpop-countdb -k /dev/stdin -o Classes.5\n"
        "cat clusters-small.fasta |\n"
        "  awk '{nr=(NR-1)%4; if (nr==2) split($0,s,\"[>-]\"); if (nr==3) print \">\"s[2]\"-\"s[3]\"\\n\"$0}' > test.fasta\n"
    )
    serve = (
        "set -eo pipefail\n"
        "kpop-classify-torch -T Classes.5 -t Classes.5 -f test.fasta -o Test_prediction.5\n"
        # the relatedness tools: the test set twisted once, then summarized
        # against the classes, and the classes' spectral distances, by the
        # JAX tools' float64 host path
        "kpop-count -k 5 -L -f test.fasta | kpop-twistdb -i T Classes.5 -k /dev/stdin -o t Test.5\n"
        "kpop-twistdb -i T Classes.5 -i t Classes.5 -s Test.5 Host.5\n"
        "kpop-countdb -i Classes.5 --distances '~.' '~.' HostD.5\n"
    )
    launches = {}
    with tempfile.TemporaryDirectory() as td:
        def sh(script: str, what: str) -> None:
            res = subprocess.run(["bash", "-c", script], cwd=td, env=env,
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"quick start ({what}) failed:\n" + res.stderr[-4000:])

        def at(name: str) -> str:
            return os.path.join(td, name)

        sh(counts, "counts")
        launches["twist"] = run_default_cli(
            "twist", ["-i", at("Classes.5"), "-o", at("Classes.5")], ("kpop_ca_gram",))
        sh(serve, "classify and host references")
        launches["twistdb"] = run_default_cli(
            "twistdb", ["-i", "T", at("Classes.5"), "-i", "t", at("Classes.5"),
                        "-s", at("Test.5"), at("Torch.5")],
            ("kpop_pairwise_dist", "kpop_row_digest"))
        launches["countdb"] = run_default_cli(
            "countdb", ["-i", at("Classes.5"), "--distances", "~.", "~.", at("TorchD.5")],
            ("kpop_pairwise_dist",))
        lines = {}
        for name in ("Test_prediction.5", "Torch.5", "Host.5"):
            with open(os.path.join(td, name + ".KPopSummary.txt")) as f:
                lines[name] = f.read().splitlines()
        dmats = {
            name: KPopMatrix.of_binary(MatrixType.DMATRIX, os.path.join(td, name)).matrix
            for name in ("TorchD.5", "HostD.5")
        }
    for name, tool in (("Test_prediction.5", "kpop-classify-torch"),
                       ("Torch.5", "kpop-twistdb-torch -s")):
        if len(lines[name]) != 100:
            raise AssertionError(f"{tool}: {len(lines[name])} summaries, not 100")
        wrong = sum(ln.split("\t")[0].split("-")[1] != ln.split("\t")[5] for ln in lines[name])
        log("cli: %s quick start: %d misclassified of %d" % (tool, wrong, len(lines[name])))
        if wrong:
            raise AssertionError(f"{tool}: {wrong} misclassified")
    check_summaries(lines["Torch.5"], lines["Host.5"])
    log("cli: kpop-twistdb-torch -s within %g of kpop-twistdb's host "
        "summaries, same targets" % SUMMARY_BOUND)
    got, want = dmats["TorchD.5"], dmats["HostD.5"]
    # d^2 bound: the self-distances on the diagonal carry the float32
    # cancellation of |a|^2 + |b|^2 - 2 a.b (a few 1e-6 in d^2)
    err2 = float(np.abs(got.data**2 - want.data**2).max())
    if got.row_names != want.row_names or not np.allclose(
        got.data**2, want.data**2, rtol=4e-5, atol=4e-6
    ):
        raise AssertionError(f"kpop-countdb-torch --distances: max |d^2 - host| {err2:.3g}")
    log("cli: kpop-countdb-torch --distances %s: max |d^2 - host d^2| %.3g"
        % (list(got.data.shape), err2))
    return launches


# ---------------- phase 6: the relatedness engine ------------------------


def check_summaries(got, want, f64=None, col_index=None) -> tuple[int, int]:
    """Hold device summary lines to host float64 lines of the same queries:
    equal names; mean, std, median and MAD, and each listed distance and
    z-score by position, within SUMMARY_BOUND * max(1, |x|).  With ``f64``
    every listed target's float64 distance is within the same bound of the
    listed distance, and a line may list more or fewer targets than the
    host's where the longer list ends in one tie group (distances that tie
    in float32 and not in float64, or the reverse).  Without ``f64`` the
    targets and their number are the host's.  Returns how many lines list
    their targets in another order (near-ties swap in float32) and how many
    differ by such a tie group."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} summary lines, host {len(want)}")
    swapped = ties = 0
    for j, (g, w) in enumerate(zip(got, want)):
        pg, pw = g.split("\t"), w.split("\t")
        n = min(len(pg), len(pw))
        bad = pg[0] != pw[0] or (len(pg) - 5) % 3 or (len(pw) - 5) % 3
        for i in range(1, n if not bad else 1):
            if i >= 5 and (i - 5) % 3 == 0:
                continue  # a target name
            a, b = float(pg[i]), float(pw[i])
            bad |= not abs(a - b) <= SUMMARY_BOUND * max(1.0, abs(b))
        if len(pg) != len(pw):
            longer = pg if len(pg) > len(pw) else pw
            bad |= f64 is None or len(set(longer[n - 2 :: 3])) != 1
            ties += 1
        if f64 is not None:
            for name, d in zip(pg[5::3], pg[6::3]):
                exact = f64[j, col_index[name]]
                bad |= not abs(float(d) - exact) <= SUMMARY_BOUND * max(1.0, exact)
        else:
            bad |= pg[5::3] != pw[5::3]
        if bad:
            raise AssertionError(f"summary line {j}: {g[:300]!r}\nhost: {w[:300]!r}")
        swapped += pg[5:n:3] != pw[5:n:3]
    return swapped, ties


def countdb_spectra(table: np.ndarray):
    """The class spectra of a [V, C] count table as ``kpop-countdb
    --distances`` sees them (``CounterDB.submatrix_normalized``): one row
    per class, divided by its count sum."""
    from kpop_tpu_torch.core.matrix import NamedMatrix

    sums = table.sum(axis=0).astype(np.float64)
    spectra = table.T.astype(np.float64) / np.where(sums == 0.0, 1.0, sums)[:, None]
    return NamedMatrix(
        ["c%d" % i for i in range(table.shape[1])],
        ["k%d" % i for i in range(table.shape[0])],
        spectra,
    )


def phase_relatedness(dev, card: str, table: np.ndarray) -> dict:
    """bench.py's relatedness flagship through summarize_rowwise_device on
    both routes, held to the host float64 path on its first REL_HOST_Q
    queries, then phase 4's count table through distance_rowwise_device
    (pallas), held to float64 on the card."""
    import io

    import torch

    from kpop_tpu_torch.core.matrix import NamedMatrix
    from kpop_tpu_torch.core.space import Distance, distance_rowwise, summarize_rowwise
    from kpop_tpu_torch import _build
    from kpop_tpu_torch.ops import pairwise as pw
    from kpop_tpu_torch.ops import summaries as sm

    rng = np.random.default_rng(2)
    dims = ["Dim%d" % (i + 1) for i in range(REL_D)]
    targets = NamedMatrix(
        ["t%d" % i for i in range(REL_T)], dims, rng.standard_normal((REL_T, REL_D))
    )
    queries = NamedMatrix(
        ["q%d" % i for i in range(REL_Q)], dims, rng.standard_normal((REL_Q, REL_D))
    )
    head = NamedMatrix(queries.row_names[:REL_HOST_Q], dims, queries.data[:REL_HOST_Q])
    metric = np.full(REL_D, 1.0 / REL_D)
    dist = Distance.of_string("euclidean")

    def summarize(backend, qmat):
        buf = io.StringIO()
        n = sm.summarize_rowwise_device(
            dist, metric, targets, qmat, keep_at_most=REL_KEEP, normalize=True,
            out=buf, batch=DIGEST_B, backend=backend,
        )
        lines = buf.getvalue().split("\n")[:-1]
        if n != qmat.n_rows or len(lines) != n:
            raise AssertionError(f"{backend}: {n} rows, {len(lines)} lines of {qmat.n_rows}")
        return lines

    lines, rates, launches = {}, {}, {}
    for backend in ("pallas", "jax"):
        summarize(backend, head)  # warm-up: allocator, cuBLAS, pinned pool
        # the main path: every count set to 0 just before, read just after
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        lines[backend] = summarize(backend, queries)
        rates[backend] = REL_Q / (time.perf_counter() - t0)
        launches[backend] = dict(_build.LAUNCHES)
        log("relatedness: %s route, kernel launches %s" % (backend, json.dumps(launches[backend])))
    if not (launches["pallas"]["kpop_pairwise_dist"] and launches["pallas"]["kpop_row_digest"]):
        raise AssertionError("pallas route: the tile or the digest never launched")
    if launches["jax"]["kpop_pairwise_dist"] or not launches["jax"]["kpop_row_digest"]:
        raise AssertionError("jax route: expected digest launches and no tile")

    t0 = time.perf_counter()
    host = summarize_rowwise(dist, metric, targets, head, REL_KEEP, True)
    host_rate = REL_HOST_Q / (time.perf_counter() - t0)
    f64 = distance_rowwise(dist, metric, targets, head).data
    col_index = {name: i for i, name in enumerate(targets.row_names)}
    for backend, got in lines.items():
        swapped, ties = check_summaries(got[:REL_HOST_Q], host, f64, col_index)
        log("relatedness: %s route, first %d queries within %g of the host float64 "
            "lines; %d list their targets in another order, %d differ by a float32 "
            "tie group" % (backend, REL_HOST_Q, SUMMARY_BOUND, swapped, ties))
    log("relatedness: %d queries x %d targets x %d dims, keep %d, batch %d: pallas "
        "%.1f, jax %.1f queries/s (upload + distances + digest + download + "
        "format); host float64 %.1f queries/s over %d; on %s"
        % (REL_Q, REL_T, REL_D, REL_KEEP, DIGEST_B, rates["pallas"], rates["jax"],
           host_rate, REL_HOST_Q, card))

    # kpop-countdb --distances --backend pallas on phase 4's class spectra
    smat = countdb_spectra(table)
    ones = np.ones(table.shape[0])
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    got = sm.distance_rowwise_device(dist, ones, smat, smat, normalize=True, backend="pallas").data
    pallas_s = time.perf_counter() - t0
    count_launches = dict(_build.LAUNCHES)
    if not count_launches["kpop_pairwise_dist"]:
        raise AssertionError("countdb distances: the tile never launched")
    t0 = time.perf_counter()
    plain = sm.distance_rowwise_device(dist, ones, smat, smat, normalize=True, backend="jax").data
    plain_s = time.perf_counter() - t0
    a = torch.as_tensor(smat.data, device=dev)
    ones64 = torch.ones(a.shape[1], dtype=torch.float64, device=dev)
    na = pw.row_norms(a, ones64)
    exact = distances_f64(a, a, ones64, na, na).cpu().numpy()
    del a, na
    err, plain_err = float(np.abs(got - exact).max()), float(np.abs(plain - exact).max())
    log("relatedness: countdb distances %s: max abs err to float64 %.3g on the tile "
        "route (%.2f s), %.3g on the matmul route (%.2f s; host transfers included)"
        % (list(got.shape), err, pallas_s, plain_err, plain_s))
    if not np.isfinite(err) or err > F64_ERR_RATIO * plain_err:
        raise AssertionError(f"countdb distances: error to float64 {err:.3g}, plain {plain_err:.3g}")
    torch.cuda.empty_cache()
    return dict(
        launches={"relatedness": launches["pallas"], "countdb_distances": count_launches},
        queries_per_s=rates, host_queries_per_s=host_rate,
    )


# ---------------- phase 7: large k at full width -------------------------


def phase_large_k(dev, genomes: dict, batches, card: str) -> dict:
    """Phase 4's genomes counted at k = LARGE_K (above the dense-LUT limit),
    trained on the card (``phi="device"``), parameters built around the
    device twister with the cuckoo hash, and phase 4's held-out read sets
    served on both routes: top-1 accuracy >= ACCURACY_GATE on each, the
    wide count, the wide bag and the tile launched, each route's device
    time a batch, and the first batch within HOST_CHAIN_ATOL of the host
    float64 chain through the twister of the same fit with phi on the host
    (float64; phase 4 shows the card's twister is that fit rounded to
    f32)."""
    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu_torch.core.space import Metric
    from kpop_tpu_torch.core.twister import Twister
    from kpop_tpu_torch.ops.pipeline import params_around_twister
    from kpop_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    space, vocab_hex, table, _ = count_corpus(genomes, LARGE_K)
    n_classes = table.shape[1]
    log("large k: phase 4's genomes counted at k=%d: vocabulary %d (%d expected), %d classes "
        "(%.1f s)" % (LARGE_K, len(vocab_hex), LARGE_K_VOCAB, n_classes, time.perf_counter() - t0))
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    coords, inertia, phi_dev, _sv = sharded.ca_fit_sharded(
        table, col_weights=col_w, phi="device", device=dev
    )
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if not _build.LAUNCHES["kpop_ca_gram"]:
        raise AssertionError("large k: the train path never launched the Gram kernel")
    log("large k: device CA fit of [%d, %d], %.3f s: %s"
        % (*table.shape, train_s, ", ".join("%s %.4f s" % kv for kv in sharded.LAST_CA_PHASES.items())))
    t0 = time.perf_counter()
    coords64, inertia64, tw64, _ = sharded.ca_fit_sharded(table, col_weights=col_w, device=dev)
    del table
    rounded = torch.equal(phi_dev.cpu(), torch.from_numpy(np.ascontiguousarray(tw64.T)).float())
    log("large k: the same fit with phi on the host (float64, the host chain's twister): the "
        "card's twister is it rounded to f32: %s (%.1f s)" % (rounded, time.perf_counter() - t0))
    if not rounded:
        raise AssertionError("large k: the device twister is not the float64 fit rounded to f32")

    t0 = time.perf_counter()
    params = params_around_twister(space, vocab_hex, phi_dev, inertia, coords)
    del phi_dev
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if params.cuckoo is None:
        raise AssertionError("large k: the cuckoo build failed on the corpus vocabulary")
    log("large k: parameters around the device twister, cuckoo table %s (%.1f MB), twister "
        "%.1f MB (%.1f s)" % (list(params.cuckoo.shape), params.cuckoo.nbytes / 1e6,
                              params.twister.nbytes / 1e6, time.perf_counter() - t0))
    dmats, launches, accuracy, busy = serve_routes("large k", params, batches, LARGE_K_KERNELS)
    log("large k: on %s" % card)

    t0 = time.perf_counter()
    dims = ["Dim%d" % (i + 1) for i in range(tw64.shape[0])]
    twister64 = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, vocab_hex, tw64)),
        KPopMatrix(MatrixType.INERTIA, NamedMatrix(["inertia"], dims, inertia64[None, :])),
    )
    metric_vec = twister64.metrics_vector(Metric.of_string("powers(1,1,2)"))
    want = host_chain_distances(space, twister64, coords64, metric_vec, batches[0][1])
    host_err = {path: float(np.abs(blocks[0] - want).max()) for path, blocks in dmats.items()}
    log("large k: first batch vs host float64 chain: max abs %s (bound %g; %.1f s)"
        % (json.dumps(host_err), HOST_CHAIN_ATOL, time.perf_counter() - t0))
    if max(host_err.values()) > HOST_CHAIN_ATOL:
        raise AssertionError(f"large k: distances off the host float64 chain: {host_err}")
    return dict(launches=launches, accuracy=accuracy, host_err=host_err, busy=busy,
                vocab=params.n_vocab, train_s=train_s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from kpop_tpu_torch import _build

    # 1. device
    card = card_line()
    log("device: %s | torch %s, CUDA %s, %d device(s)" % (
        card, torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    dev = torch.device("cuda")
    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    log("build: %s in %.1f s (nvcc %.1f s; %s)" % (
        _build.library_path().name, time.perf_counter() - t0,
        _build.BUILD_SECONDS, " ".join(_build.NVCC_FLAGS)))
    # 3. kernels
    rows = phase_kernels(dev, B=BATCH, L=30208, V=367_987, d=511, C=N_CLASSES, big=4096)
    # 4. slice
    t0 = time.perf_counter()
    sl = phase_slice(dev, N_CLASSES, GENOME_LEN, BATCH, card)
    log("slice: %.1f s (device CA fit %.3f s)" % (time.perf_counter() - t0, sl["train_s"]))
    # 5. cli
    phase_cli()
    # 6. relatedness
    t0 = time.perf_counter()
    rel = phase_relatedness(dev, card, sl.pop("table"))
    log("relatedness: %.1f s" % (time.perf_counter() - t0))
    # 7. large k
    t0 = time.perf_counter()
    lk = phase_large_k(dev, sl.pop("genomes"), sl.pop("batches"), card)
    log("large k: %.1f s (device CA fit %.3f s)" % (time.perf_counter() - t0, lk["train_s"]))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kpop_tpu"))
    if loaded:
        raise AssertionError("JAX or the JAX package was imported: %s" % loaded[:10])

    launches = {"slice": sl["launches"], "train": sl["train_launches"], **rel["launches"],
                "large_k": lk["launches"]}
    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=launches[r["path"]][r["launch"]], max_abs_err=r["err"],
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
             path=r["path"], **{k: r[k] for k in ("err_f64", "plain_err_f64") if k in r})
        for name, r in rows.items()
        if r["path"] is not None
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
