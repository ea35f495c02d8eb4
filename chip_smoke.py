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
   bag within the bag's tolerances and the float64 check, each bag input
   with the regime its accumulate takes, and the wide bag's row with one
   ``F.embedding_bag`` call on the rows of the plain wide lookup as its
   yardstick; the streamed fit's Gram pass (the same table in the row
   blocks of phase 4's streamed fits, and in phase 7's block rows, through
   one ``GramAccumulator`` each) against the one-launch Gram, the plain
   version of its order and numpy, each bit-reproducible, with the DGEMM
   and 10 ``torch.addmm`` of the blocks on pre-built float64 S as its
   yardsticks; the bag on bf16 rows at the slice's batch (k=10, the staged
   regime), on short read sets at k=10 (the gather regime), at k=16 on the
   cuckoo hash (the gather regime) and on read sets of one genome at k=16
   (the staged regime), each against its plain version on the bf16
   twister and a float64 bag of the bf16 values, torch.equal to the f32
   rows' order on the widened values, with ``F.embedding_bag`` on the bf16
   rows as its yardstick; each bag row with its device time
   (``torch.profiler``) beside its time as called; the dense route's bf16
   product (f32 output)
   against its plain version; the wrappers past the kernels' batch limits:
   the count at 70,000 read sets (k=5) against its plain version and the
   bag at 128 read sets of 8,388,608 windows against its own row groups
   launched one by one and its plain version; and each entry point on the
   2-bit read wire (``_packed``: DNA at 2 bits a base and a validity bit a
   position, packed on the host) on the same read sets: the LUT count, the
   wide count on the cuckoo hash and the sorted limbs, the range count
   (phase 7's first batch), the bag on f32 and bf16 rows in the staged and
   the gather regime on the LUT and the cuckoo hash, each torch.equal to
   the int8 entry point (the count also to its plain version, the bag
   within its tolerances of its plain version and float64), its time as
   called and its kernels' alone beside the int8 entry point's, and its
   bound with the wire read at 3/8 of a byte a base (logged; off the kernel
   table, since no served path takes the wire); and the card's encode
   of raw bytes (``kpop_encode_bytes``) at the benchmark's read-set batch
   (64 x 601,885 bytes with dashes), staged as the serving step stages
   them, torch.equal to its plain version and to the host encoder's codes,
   its time as called and alone, bound by the bytes read and written;
3b. the bag at the benchmark's cell sars2-k12-genomes: 64 held-out
   genomes of 29,903 bases through every canonical 12-mer of a
   [8,390,656, 1,635] f32 twister (54.9 GB), its launches counted, in
   the gather regime the cell takes, within the bag's tolerances of its
   plain version, torch.equal with the staged and the gather regime each
   forced by a build with the cut moved, its error to float64 over the hit
   rows recorded beside the plain version's; its kernel-table row
   (``embedding_bag_lineage_k12``);
4. slice: the headline workload of ``bench.py`` (k=10, 512 classes x 4
   tips of a 30 kb genome, seed 0, 1,024 held-out read sets of 150 bp pairs
   at 1x coverage; vocabulary ~368k, d=511), trained on the card
   (``ca_fit_sharded(phi="device")``: the wall split into masses, upload,
   Gram, eigh and phi, the fit within tests/test_dd.py's bounds of the host
   float64 ``fit_ca``, and the peak device memory of the fit that streams
   phi to the host) and classified through the dense and the bag route
   with parameters built around the device twister, on the serving step's
   default wire on a card (raw bytes, encoded on the card): top-1 accuracy
   >= 0.95 on each, every kernel launched (the encode too), each route's
   device time a batch, distances within 1e-4 of the host float64 chain,
   and the serving rate on each wire; the same read sets served again as
   int8 codes encoded on the host (``DeviceStep(wire="codes")``),
   distances equal to the bytes wire's, the twin not launching the encode;
   the same table
   fitted again on the streamed path with its budget forced
   (STREAM_BLOCKS row blocks, phi on the host and on the card), within
   tests/test_dd.py's bounds of ``fit_ca``, its sv within 1e-10 of the
   resident fit's, its device memory within the budget, its uploads from
   pinned memory; the same on the u16 wire (the table x 257) and on the f64
   wire (the weighted table, not exactly f32), each held to ``fit_ca`` and
   to its own resident fit; then both routes
   served with a bf16 twister cast from the streamed fit's: accuracy >= 0.95
   on each, distances within 2e-2 x max(1, |x|) of the f32 route, and no
   f32 copy of the twister;
5. cli: the README quick start trained by ``kpop-twist-torch`` with its
   default backend (the device CA), then through ``bin/kpop-classify-torch``
   (also with ``--dtype bf16``, its lines within 2e-2 x max(1, |x|) of the
   f32 run's) and ``kpop-twistdb-torch -s``, 0 misclassified of 100 on
   each, the summaries within 2e-4 of ``kpop-twistdb``'s host float64
   lines, and
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
   trained on the card on the streamed path with the budget forced (phi on
   the host, then ``phi="device"``), parameters built around the device
   twister with the cuckoo hash, phase 4's held-out read sets served on
   both routes, on the bytes wire and as host-encoded int8 codes (equal
   distances): top-1 accuracy >= 0.95 on each, the wide
   count, the wide bag and the tile launched (and the encode on the bytes
   wire), each route's device time a batch, and the
   first batch within 1e-4 of the host float64 chain through the fit with
   phi on the host; then the twister cast to bf16 serves the bag route at
   accuracy >= 0.95, and the same bf16 parameters built from the host
   twister (as ``kpop-classify-torch --dtype bf16`` builds them) take less
   device memory than an f32 twister and equal the card's cast bit for bit;
   the first batch is also counted in the row ranges of 4 ranks (the
   ``count_spectra_rows`` row), as phase 3's k = 10 batch is: each range
   torch.equal to its plain version and to the whole kernel's columns, and
   the first range on the 2-bit wire (``count_spectra_rows_packed``);
8. sharded: phase 7's k = 16 table trained rank-sharded by 4 gloo ranks on
   the one card (``chip_smoke.py --sharded-rank``, the kernels built by this
   process first; NCCL refuses two ranks on one card), its sv within 1e-10
   of phase 7's fit and the same bits on every rank; phase 4's held-out
   read sets served k-mer-sharded through ``kpop-classify-torch``'s layout
   choice and serve step, with ``--kmer-parallel 4`` and with
   ``KPOP_PARAMS_HBM_BYTES=600000000``, on f32 and bf16 shards: accuracy >=
   0.95, the first batch within 1e-4 of the host float64 chain (bf16
   within 2e-2 x max(1, |x|) of f32), each rank's shard and device memory,
   the launches of the main path summed over the ranks (the encode among
   them: the step takes the bytes wire), the rate, and a batch split into
   the rank's rows staged and uploaded, the card's encode, count, product,
   all-reduce (gloo: through the host) and distances; then the same at
   world size 1 over NCCL, whose all-reduce runs on the card.

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
# the Gram's entry points: a kpop_ca_gram a row block, one kpop_ca_gram_finish
# a Gram pass
GRAM_LAUNCHES = ("kpop_ca_gram", "kpop_ca_gram_finish")
# the card's peaks for the bound of each kernel, from NVIDIA's H100 SXM
# data sheet
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
F64_TC_FLOPS = 67e12  # FP64 tensor cores
F64_FLOPS = 34e12  # FP64 outside the tensor cores
# the kernels each main path launches: on the bytes wire (DeviceStep's
# default on a card) the card's encode too, on its "codes" twin not
SLICE_CODES_KERNELS = ("kpop_count_spectra", "kpop_embedding_bag", "kpop_pairwise_dist")
SLICE_KERNELS = SLICE_CODES_KERNELS + ("kpop_encode_bytes",)
# phase 3's encode row: the read-set cell's batch of the benchmark, 64 rows
# of 601,885 bytes
ENCODE_B, ENCODE_L = 64, 601_885
# phase 3's count where it buckets: at sars2-reads' batch (ENCODE_B read
# sets of ENCODE_L bases, k = 10, into READS_V rows) and at TB_B read sets
# of mtb-reads' (TB_L bases, k = 12, into TB_V rows)
READS_V = 524_800
TB_K, TB_B, TB_L, TB_V = 12, 2, 88_818_803, 8_390_656
# phase 3b: the bag at the benchmark's lineage cell at k = 12
# (sars2-k12-genomes): every canonical 12-mer a row of a [V, LINEAGE_D] f32
# twister, LINEAGE_B held-out genomes of LINEAGE_LEN bases, in the regime
# the cell takes
LINEAGE_K, LINEAGE_D, LINEAGE_B, LINEAGE_LEN = 12, 1_635, 64, 29_903
LINEAGE_REGIME = "gather"
# phase 8: the count in the row ranges of COUNT_RANGES ranks
COUNT_RANGES = 4
# phase 7: phase 4's corpus counted at k = 16 (two limbs: k_hi 1, k_lo 15),
# whose vocabulary the phase 3 wide rows take the size of
LARGE_K = 16
LARGE_K_VOCAB = 1_011_930
LARGE_K_CODES_KERNELS = ("kpop_count_spectra_wide", "kpop_embedding_bag_wide",
                         "kpop_pairwise_dist")
LARGE_K_KERNELS = LARGE_K_CODES_KERNELS + ("kpop_encode_bytes",)
# the 2-bit read wire: what each packed entry point replaces (the TPU's
# unpack pass, then the count or the bag)
PACKED_COUNT_REPLACES = "kpop_tpu/ops/encode.py:213 with kpop_tpu/ops/pipeline.py:179"
PACKED_BAG_REPLACES = "kpop_tpu/ops/encode.py:213 with kpop_tpu/ops/pipeline.py:200"
PACKED_WIDE_REPLACES = PACKED_COUNT_REPLACES + " and :165-176"
PACKED_WIDE_BAG_REPLACES = PACKED_BAG_REPLACES + " and :165-176"
# the device CA against the host float64 fit_ca: tests/test_dd.py:81-84
CA_BOUNDS = dict(sv=1e-8, inertia=1e-8, coords=1e-6, twister=1e-5)
# the streamed CA fit: the budget forced so that the table streams in
# STREAM_BLOCKS row blocks (at least STREAM_BLOCKS_MIN), its sv within
# STREAM_SV_RTOL of the resident fit's largest (only the order of the
# Gram's float64 sums differs)
STREAM_BLOCKS, STREAM_BLOCKS_MIN, STREAM_SV_RTOL = 10, 8, 1e-10
# bf16 twisters: a route's distances within BF16_BOUND * max(1, |x|) of the
# f32 route's (tests/test_cli_extras.py:429); F.embedding_bag on bf16 rows
# rounds its weights and its output to bf16 (2^-9 each), so it is held to
# the plain version within BF16_LIBRARY_RTOL of its largest value; the bf16
# product with an f32 output against the f32 product of the widened values
# within BF16_PRODUCT_RTOL of its largest value (the same exact products,
# summed in f32 in another order over 367,987 terms)
BF16_BOUND = 2e-2
BF16_LIBRARY_RTOL = 1e-2
BF16_PRODUCT_RTOL = 1e-4


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


def device_call_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn()`` in ms: every kernel and copy it
    runs, by ``torch.profiler``, over ``reps`` calls after a warm-up, per
    call.  Unlike :func:`time_ms` it leaves out the host time before the
    first launch, during which the card idles."""
    fn()
    return sum(device_ms_by_kernel(lambda: [fn() for _ in range(reps)]).values()) / reps


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


def random_params(rng, dev, V: int, d: int, C: int, k: int = K):
    """Classifier parameters with a random vocabulary of V k-mers (k = 10
    unless ``k`` says), the all-A k-mer row 0."""
    import torch

    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    n = 4**k
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
        f32(metric), f32(coords), f32(norms), k=k, canonical=True,
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
    error): its max abs error to float64, and the plain version's.
    ``codes``: int8 codes or the 2-bit wire (unpacked for the plain version
    and float64)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    from kpop_tpu_torch.ops.encode import as_codes

    got = pl.project_reads(params, codes)
    want = pl.project_reads_ref(params, as_codes(codes))
    exact = bag_f64(params, as_codes(codes))
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


def bag_library_call(params, codes, want, rtol: float = LIBRARY_RTOL):
    """One PyTorch call that computes the bag's function, as its yardstick:
    ``F.embedding_bag`` (mode sum) over the rows the plain lookup gives,
    weighted by 1 / n_known per read set.  Held to the plain version
    ``want`` within LIBRARY_RTOL of its largest value (the library sums
    each bag in f32 in one sequence: on the row that repeats one k-mer
    30,199 times that drifts to about 3e-4 relative).  Returns the call,
    the known windows, the distinct rows they hit, and the distinct (row,
    read set) entries and the tiles that hold them of a pass of the kernel
    (which picks its regime by entries a tile, pipeline.bag_regime)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    idx = pl.vocab_lookup(params, codes)
    known = idx < params.n_vocab
    flat = idx[known].long()
    per_row = known.sum(dim=1)
    offsets = torch.cumsum(per_row, 0) - per_row
    weights = (1.0 / torch.clamp(per_row, min=1).float()).repeat_interleave(per_row)
    weights = weights.to(params.twister.dtype)
    call = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        flat, params.twister, offsets, mode="sum", per_sample_weights=weights)
    lib_err = float((call().float() - want).abs().max())
    if not lib_err <= rtol * float(want.abs().max()):
        raise AssertionError(f"F.embedding_bag does not compute the bag's function: {lib_err:.3g}")
    sets = torch.arange(codes.shape[0], device=codes.device)[:, None].expand_as(idx)[known]
    entries = int(torch.unique(flat * pl.BAG_GROUP + sets % pl.BAG_GROUP).numel())
    tiles = int(torch.unique(flat // pl.BAG_TILE_ROWS).numel())
    return call, int(flat.numel()), int(torch.unique(flat).numel()), entries, tiles


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


def with_twister(params, twister):
    """The same classifier parameters around another twister."""
    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    return ClassifierParams(
        params.vocab_lut, twister, params.metric,
        params.class_coords, params.class_norms, k=params.k, canonical=params.canonical,
        base=params.base, vocab_hi=params.vocab_hi, vocab_lo=params.vocab_lo,
        cuckoo=params.cuckoo, cuckoo_seeds=params.cuckoo_seeds)


def batch_limits(dev, params, rng) -> None:
    """The wrappers' row groups past the kernels' batch limits, on the
    card.  The count at 70,000 read sets (k = 5, a random vocabulary of 512
    k-mers: a 143 MB spectrum), above the 65,535 of its grid: two launches,
    torch.equal to the plain version.  The bag on 128 read sets of
    8,388,608 windows (1.07 GB of codes, phase 3's parameters), past the
    2^31 - 1 of its keys: launches of 127 and 1 read sets
    (``bag_row_groups``), torch.equal to the same groups launched one by
    one, and within the bag's tolerance of the plain version on three read
    sets."""
    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.ops import pipeline as pl

    n, V = 4**5, 512
    lut = np.full(n + 1, V, dtype=np.int32)
    lut[rng.permutation(n)[:V]] = np.arange(V, dtype=np.int32)
    p5 = pl.ClassifierParams(
        torch.as_tensor(lut, device=dev), torch.randn((V, 64), device=dev),
        torch.full((64,), 1.0 / 64, device=dev), torch.randn((3, 64), device=dev),
        torch.ones(3, device=dev), k=5, canonical=True)
    codes = torch.as_tensor(read_like_codes(rng, 70_000, 400), device=dev)
    _build.LAUNCHES["kpop_count_spectra"] = 0
    got = pl.count_spectra(p5, codes)
    launched = _build.LAUNCHES["kpop_count_spectra"]
    same = torch.equal(got, pl.count_spectra_ref(p5, codes))
    log("count at [70000, 400], k=5, V=%d: %d launches (groups %s), torch.equal to the plain "
        "version %s; %.4f ms" % (V, launched, pl.count_row_groups(70_000), same,
                                 time_ms(lambda: pl.count_spectra(p5, codes), reps=3)))
    if launched != len(pl.count_row_groups(70_000)) or not same:
        raise AssertionError(f"count of 70,000 read sets: {launched} launches, equal {same}")
    del p5, codes, got
    W = 8_388_608
    codes = torch.randint(0, 4, (BATCH, W + K - 1), dtype=torch.int8, device=dev,
                          generator=torch.Generator(dev).manual_seed(11))
    codes[:, 150::151] = -1
    groups = pl.bag_row_groups(BATCH, W)
    _build.LAUNCHES["kpop_embedding_bag"] = 0
    got = pl.project_reads(params, codes)
    launched = _build.LAUNCHES["kpop_embedding_bag"]
    parts = torch.cat([pl.project_reads(params, codes[b0:b1]) for b0, b1 in groups])
    same = torch.equal(got, parts)
    some = [0, 1, BATCH - 1]
    want = pl.project_reads_ref(params, codes[some], chunk=1 << 16)
    err = float((got[some] - want).abs().max())
    close = bool(torch.allclose(got[some], want, rtol=BAG_RTOL, atol=BAG_ATOL))
    log("embedding_bag at [%d, %d] (%d windows a read set, 2 x 128 x W > 2^31 - 1): %d launches "
        "(groups %s), torch.equal to the groups launched one by one %s; read sets %s within "
        "rtol %g, atol %g of the plain version %s (max abs %.3g); %.2f ms"
        % (BATCH, W + K - 1, W, launched, groups, same, some, BAG_RTOL, BAG_ATOL, close, err,
           time_ms(lambda: pl.project_reads(params, codes), reps=3)))
    if launched != len(groups) or len(groups) < 2 or not (same and close):
        raise AssertionError(f"bag above the key limit: {launched} launches of {groups}, equal "
                             f"{same}, within tolerance {close}")
    del codes, got, parts, want
    torch.cuda.empty_cache()


def canonical_lut(k: int) -> tuple[np.ndarray, int]:
    """Every canonical DNA k-mer a vocabulary row, in code order: the
    ``4^k + 1`` int32 LUT (``V`` where a code is no row) and ``V``."""
    codes = np.arange(4**k, dtype=np.int64)
    rc = np.zeros_like(codes)
    x = codes.copy()
    for _ in range(k):
        rc = rc * 4 + (3 - x % 4)
        x //= 4
    canon = codes[codes <= rc]
    V = len(canon)
    lut = np.full(4**k + 1, V, dtype=np.int32)
    lut[canon] = np.arange(V, dtype=np.int32)
    return lut, V


def with_regime_cut(tile_entries: int, fn):
    """``fn()`` on the kernels built with the bag's regime cut at
    ``tile_entries`` entries a tile (0: the staged regime always, 2^30: the
    gather), then the kernels of the cut as it was."""
    from kpop_tpu_torch import _build
    from kpop_tpu_torch.ops import pipeline as pl

    cut = pl.BAG_GATHER_TILE_ENTRIES
    pl.BAG_GATHER_TILE_ENTRIES = tile_entries
    _build._lib = None
    try:
        return fn()
    finally:
        pl.BAG_GATHER_TILE_ENTRIES = cut
        _build._lib = None


def lineage_bag_row(dev) -> tuple[dict, dict]:
    """The bag at the benchmark's cell sars2-k12-genomes: LINEAGE_B
    held-out genomes of LINEAGE_LEN bases (one tip of each of LINEAGE_B
    lineages of :func:`simulate_corpus`'s tree) through every canonical
    12-mer of a ``[8,390,656, 1,635]`` f32 twister (54.9 GB).  The launch
    count reset before the call and read after it; the regime the batch
    takes is LINEAGE_REGIME (asserted from its entries and tiles); the
    result within BAG_RTOL, BAG_ATOL of the plain version and torch.equal
    in both regimes forced (:func:`with_regime_cut`).  Its error to a
    float64 bag over the hit rows is recorded beside the plain version's,
    not held to F64_ERR_RATIO of it: at this shape each of the kernel's
    slices sums some 3,000 entries a read set in sequence, where the plain
    version sums chunks of 2,048 windows as trees, and the kernel's error
    reads about 7x the plain version's, some 1e-5 of the values (an open
    question, PERF.md section 7).  Returns the kernel table's row (the bound: the codes read,
    each hit row read once and the output written; a multiply and an add a
    column for each (read set, row) entry) and the launches of the call."""
    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.ops import pipeline as pl

    k, d, B = LINEAGE_K, LINEAGE_D, LINEAGE_B
    torch.cuda.empty_cache()
    lut, V = canonical_lut(k)
    rng = np.random.default_rng(23)
    by_class = simulate_corpus(rng, B, LINEAGE_LEN, tips_per_class=2)
    held = np.stack([max(by_class[c], key=lambda m: m[0])[1] for c in range(B)])
    codes = torch.as_tensor(held.astype(np.int8), device=dev)
    metric = np.full(d, 1.0 / d, dtype=np.float32)
    params = pl.ClassifierParams(
        torch.as_tensor(lut, device=dev),
        torch.randn((V, d), generator=torch.Generator(dev).manual_seed(23), device=dev),
        torch.as_tensor(metric, device=dev), torch.zeros((4, d), device=dev),
        torch.ones(4, device=dev), k=k, canonical=True)
    what = f"[{B}, {LINEAGE_LEN}], k={k}, twister [{V}, {d}]"
    _build.LAUNCHES["kpop_embedding_bag"] = 0
    got = pl.project_reads(params, codes)
    launches = {"kpop_embedding_bag": _build.LAUNCHES["kpop_embedding_bag"]}
    groups = pl.bag_row_groups(B, LINEAGE_LEN - k + 1)
    if launches["kpop_embedding_bag"] != len(groups):
        raise AssertionError(f"embedding_bag at {what}: {launches} launches for groups {groups}")
    want = pl.project_reads_ref(params, codes)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=BAG_RTOL, atol=BAG_ATOL):
        raise AssertionError(f"embedding_bag at {what} differs from its plain version: max abs "
                             f"{err:.3g}")
    bag_lib, n_known, hit, entries, tiles = bag_library_call(params, codes, want)
    regime = pl.bag_regime(entries, tiles)
    if regime != LINEAGE_REGIME:
        raise AssertionError(f"embedding_bag at {what}: {entries} entries over {tiles} tiles take "
                             f"the {regime} regime, the cell's is {LINEAGE_REGIME}")
    staged = with_regime_cut(0, lambda: pl.project_reads(params, codes))
    staged_ms = with_regime_cut(0, lambda: time_ms(lambda: pl.project_reads(params, codes),
                                                   reps=3))
    gather = with_regime_cut(2**30, lambda: pl.project_reads(params, codes))
    same = torch.equal(staged, gather) and torch.equal(got, gather)
    if not same:
        raise AssertionError(f"embedding_bag at {what}: the staged and gather regimes differ "
                             f"(max abs {float((staged - gather).abs().max()):.3g})")
    del staged, gather
    # float64 over the hit rows: the exact counts times the widened rows
    idx = pl.vocab_lookup(params, codes)
    cols = torch.unique(idx[idx < V]).long()
    counts = pl.count_spectra_ref(params, codes)[:, cols].double()
    exact = (counts @ params.twister[cols].double()) / counts.sum(dim=1).clamp(min=1.0)[:, None]
    err_f64 = float((got.double() - exact).abs().max())
    plain_err_f64 = float((want.double() - exact).abs().max())
    del idx, cols, counts, exact
    if not np.isfinite(err_f64):
        raise AssertionError(f"embedding_bag at {what}: error to float64 {err_f64}")
    row = dict(
        bound(codes.nbytes + hit * d * 4 + got.nbytes, 2.0 * entries * d / F32_FLOPS * 1e3),
        library_ms=time_ms(bag_lib, reps=3),
        err=err, err_f64=err_f64, plain_err_f64=plain_err_f64, regime=regime,
        ms=time_ms(lambda: pl.project_reads(params, codes), reps=5),
        device_ms=device_call_ms(lambda: pl.project_reads(params, codes)),
        plain_ms=time_ms(lambda: pl.project_reads_ref(params, codes), reps=3),
        shape=f"[{B}, {LINEAGE_LEN}] int8 codes, k={k}, twister [{V}, {d}]: sars2-k12-genomes",
        tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}; the staged and gather regimes torch.equal",
        source="kpop_tpu_torch/csrc/embedding_bag.cu",
        replaces="kpop_tpu/ops/pipeline.py:200",
        launch="kpop_embedding_bag", path="lineage_k12",
    )
    log("kernel embedding_bag at %s: %d known windows hit %d distinct rows (%d entries over %d "
        "tiles: the %s regime); %.4f ms as called (device %.4f), the staged regime forced "
        "%.4f, plain %.2f, F.embedding_bag %.4f, bound %.4f (%s); max abs err %.3g to the plain "
        "version, %.3g to float64 (plain %.3g)"
        % (what, n_known, hit, entries, tiles, regime, row["ms"], row["device_ms"], staged_ms,
           row["plain_ms"], row["library_ms"], row["bound_ms"], row["bound_by"], err, err_f64,
           plain_err_f64))
    del params, codes, got, want, bag_lib
    torch.cuda.empty_cache()
    return row, launches


def bf16_of(params):
    """The same classifier parameters with the twister cast to bf16 on its
    device, in the rows the port lays bf16 twisters out in
    (``pipeline.bf16_rows``): the only copy made."""
    from kpop_tpu_torch.ops.pipeline import bf16_rows

    return with_twister(params, bf16_rows(params.twister))


def bag_bf16_row(params, codes, table, shape: str, replaces: str, launch: str, path: str,
                 regime: str | None = None) -> dict:
    """The bag on the same inputs with the twister cast to bf16: held to
    its plain version on the bf16 twister and to a float64 bag of the bf16
    values (``bag_errors``), off the f32 twister's bag by more than the
    bag's tolerance (it read the bf16 rows, not f32 ones), and torch.equal
    to the kernel's bag of the f32 twister that holds the bf16 values
    widened (each bf16 element widened exactly, then the f32 rows' products
    in their order: the order tests/test_torch_bag.py emulates); its regime
    (``regime``, where given, must be taken), its time as called and its
    device time (``device_ms``), its bound with each hit row read once at 2
    d bytes, and ``F.embedding_bag`` on the bf16 rows as the library
    yardstick.  ``table`` is the vocabulary the kernel reads
    (the LUT or the cuckoo table)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    f32_bag = pl.project_reads(params, codes)
    pb = bf16_of(params)
    err, plain_err = bag_errors(pb, codes, "bf16 at " + shape)
    got = pl.project_reads(pb, codes)
    want = pl.project_reads_ref(pb, codes)
    moved = float((got - f32_bag).abs().max())
    if not moved > BAG_ATOL + BAG_RTOL * float(f32_bag.abs().max()):
        raise AssertionError(f"bf16 bag at {shape} equals the f32 twister's bag ({moved:.3g}): "
                             "it did not read bf16 rows")
    widened = pl.project_reads(with_twister(params, pb.twister.float()), codes)
    if not torch.equal(got, widened):
        raise AssertionError(f"bf16 bag at {shape} differs from the f32 rows' order on the "
                             f"widened values: {float((got - widened).abs().max()):.3g}")
    del widened
    lib, n_known, hit, entries, tiles = bag_library_call(pb, codes, want, rtol=BF16_LIBRARY_RTOL)
    d = pb.twister.shape[1]
    taken = pl.bag_regime(entries, tiles)
    log("kernel embedding_bag bf16 at %s: %d known windows, %d distinct rows, %d entries in %d "
        "tiles: the %s regime; max abs err to float64 of the bf16 values %.3g, plain version "
        "%.3g; %.3g off the f32 twister's bag; equal to the f32 order on the widened values"
        % (shape, n_known, hit, entries, tiles, taken, err, plain_err, moved))
    if regime is not None and taken != regime:
        raise AssertionError(f"bf16 bag at {shape} takes the {taken} regime, not {regime}")
    row = dict(
        bound(codes.nbytes + table.nbytes + hit * d * 2 + got.nbytes,
              float(n_known) * d / F32_FLOPS * 1e3),
        library_ms=time_ms(lib, reps=5),
        err=float((got - want).abs().max()), err_f64=err, plain_err_f64=plain_err,
        ms=time_ms(lambda: pl.project_reads(pb, codes), reps=5),
        device_ms=device_call_ms(lambda: pl.project_reads(pb, codes)),
        plain_ms=time_ms(lambda: pl.project_reads_ref(pb, codes), reps=3),
        shape=shape + ", bf16 twister", regime=taken,
        tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL} of the plain version on the bf16 twister; err to "
            f"float64 <= {F64_ERR_RATIO:g}x the plain version's; torch.equal to the f32 rows' "
            "order on the widened values",
        source="kpop_tpu_torch/csrc/embedding_bag.cu", replaces=replaces, launch=launch, path=path,
    )
    del pb, got, want, f32_bag, lib
    torch.cuda.empty_cache()
    return row


def bf16_product_check(spectra, twister) -> None:
    """The dense route's bf16 product (``pipeline.bf16_product``: one
    ``aten::mm.dtype`` GEMM, bf16 operands, f32 output) against its plain
    version (the f32 product of the widened values) within
    BF16_PRODUCT_RTOL of its largest value, with both errors to a float64
    product of the same bf16 values and the times of both beside the f32
    route's SGEMM.  A card whose torch has no ``aten::mm.dtype`` fails."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    if not hasattr(torch.ops.aten.mm, "dtype"):
        raise AssertionError("this torch has no aten::mm.dtype: the bf16 product has no kernel")
    a, b = spectra.to(torch.bfloat16), pl.bf16_rows(twister)
    got = pl.bf16_product(a, b)
    flat_b = b.contiguous()  # the same values in rows of d: cuBLAS may take another kernel
    flat_err = float((pl.bf16_product(a, flat_b) - got).abs().max())
    if not flat_err <= BF16_PRODUCT_RTOL * float(got.abs().max()):
        raise AssertionError(f"bf16 product: the twister's padded rows change it by {flat_err:.3g}")
    flat_ms = time_ms(lambda: pl.bf16_product(a, flat_b))
    del flat_b
    want = pl.bf16_product_ref(a, b)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err = float((got - want).abs().max())
    if got.dtype != torch.float32 or not err <= BF16_PRODUCT_RTOL * scale:
        raise AssertionError(f"bf16 product {got.dtype}: max abs {err:.3g} off the plain version")
    errs = [float((t.double() - exact).abs().max()) for t in (got, want)]
    del exact
    ms = time_ms(lambda: pl.bf16_product(a, b))
    plain_ms = time_ms(lambda: pl.bf16_product_ref(a, b), reps=5)
    sgemm_ms = time_ms(lambda: spectra @ twister, reps=5)
    log("bf16 product [%d, %d] x [%d, %d] (aten::mm.dtype, f32 output; the twister in rows of "
        "%d): max abs %.3g to plain (bound %g of max |x| %.6g); to float64 %.3g, plain %.3g; "
        "%.4f ms (contiguous twister %.4f ms), plain %.4f ms, the f32 route's SGEMM %.4f ms"
        % (*a.shape, *b.shape, b.stride(0), err, BF16_PRODUCT_RTOL, scale, errs[0], errs[1], ms,
           flat_ms, plain_ms, sgemm_ms))


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


def gram_row(dev) -> tuple[dict, dict]:
    """The residual-Gram kernel at the headline training shape against its
    plain version and a numpy float64 Gram of the same residual, each
    within GRAM_RTOL of the largest |G|; timed with the plain version and,
    as the yardstick, one cuBLAS DGEMM S^T S on a pre-built float64 S.
    Then the streamed fit's blocked call: the same table in the row blocks
    that phase 4's streamed fits take (:func:`stream_geometry`), each launch
    adding its Gram into G, held within GRAM_RTOL of the one-launch Gram
    and of numpy and against the plain version's blocks (``G +=
    residual_gram_ref``), and at phase 7's block rows against the plain
    blocks.  Returns the two rows."""
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
        launch=GRAM_LAUNCHES, path="train",
    )
    # the streamed fits' Gram pass at their own geometry, on views of the
    # resident table (the upload is the streamed fit's, phase 4): one
    # GramAccumulator fed phase 4's blocks, and one fed phase 7's block rows
    # (the table in 3 of them and a short last one)
    _, step = stream_geometry(K, ns, "u8", dev)
    _, wide_step = stream_geometry(LARGE_K_VOCAB, ns, "u8", dev)

    def accumulated(rows: int, plain: bool = False):
        if plain:  # the same order in plain PyTorch, on the card
            slices = gram.split_plan(rows, ns, gram._sm_count(dev))[0]
            partial = torch.zeros((slices, ns, ns), dtype=torch.float64, device=dev)
            for i in range(0, K, rows):
                gram.accumulate_ref(partial, x[i:i + rows], vecs[0][i:i + rows],
                                    vecs[1][i:i + rows], vecs[2], vecs[3])
            return gram.finish_ref(partial, vecs[2])
        acc = gram.GramAccumulator(vecs[2], vecs[3], rows)
        for i in range(0, K, rows):
            acc.add(x[i:i + rows], vecs[0][i:i + rows], vecs[1][i:i + rows])
        return acc.finish()

    n_blocks = -(-K // step)
    checks = {}
    for label, rows in (("phase 4", step), ("phase 7", wide_step)):
        Gb, Gb_plain = accumulated(rows), accumulated(rows, plain=True)
        again = torch.equal(Gb, accumulated(rows))
        gbn = Gb.cpu().numpy()
        checks[label] = dict(
            one=float(np.abs(gbn - g).max()) / scale, f64=float(np.abs(gbn - want).max()) / scale,
            plain=float(np.abs(gbn - Gb_plain.cpu().numpy()).max()) / scale,
            plain_f64=float(np.abs(Gb_plain.cpu().numpy() - want).max()), again=again,
            blocks=-(-K // rows), rows=rows)
        log("kernel ca_gram accumulated over %d blocks of %d rows (%s's): max |G - one launch| "
            "%.3g, |G - plain order| %.3g, |G - numpy float64| %.3g of max |G|; bit-identical on "
            "a second call %s" % (-(-K // rows), rows, label, checks[label]["one"],
                                  checks[label]["plain"], checks[label]["f64"], again))
        if label == "phase 4":
            gb_err = float(np.abs(gbn - Gb_plain.cpu().numpy()).max())
        del Gb, Gb_plain
    bad = {k: v for k, v in checks.items()
           if not (max(v["one"], v["f64"], v["plain"]) <= GRAM_RTOL and v["again"])}
    if bad:
        raise AssertionError(f"accumulated ca_gram off (bound {GRAM_RTOL:g} of max |G|, "
                             f"bit-reproducible): {bad}")
    # the same-geometry library yardstick: torch.addmm of each block's
    # S_b^T S_b into G, on pre-built float64 blocks of S
    S = gram.residual(x, *vecs)
    blocks = [S[i:i + step] for i in range(0, K, step)]
    G_lib = torch.zeros((ns, ns), dtype=torch.float64, device=dev)

    def addmm():
        G_lib.zero_()
        for b in blocks:
            G_lib.addmm_(b.T, b)
        return G_lib

    addmm_rel = float((addmm() - got).abs().max()) / scale
    addmm_ms = time_ms(addmm)
    del S, blocks, G_lib
    # the kernels' own device time, one launch and the streamed pass
    for label, rows in (("one launch", K), ("phase 4's blocks", step)):
        by_kernel = device_ms_by_kernel(lambda: accumulated(rows))
        log("kpop_ca_gram's kernels in %s, device ms (torch.profiler): %s" % (label, ", ".join(
            "%s %.4f" % (k.replace("void ", "").replace("(anonymous namespace)::", "")
                         .split("(")[0][:40], v) for k, v in by_kernel.items())))
    log("ca_gram's same-geometry yardstick: %d torch.addmm into G on pre-built float64 blocks "
        "of S, %.4f ms, %.3g of max |G| off the kernel" % (n_blocks, addmm_ms, addmm_rel))
    blocked_row = dict(
        row,
        # G's partials read and written once more a block (the first block
        # writes them, the finish reads them once)
        **bound(nbytes + 2 * (n_blocks - 1) * got.nbytes,
                (K * ns * (ns + 1.0) / F64_TC_FLOPS + 3.0 * K * ns / F64_FLOPS) * 1e3),
        err=gb_err, err_f64=checks["phase 4"]["f64"] * scale,
        plain_err_f64=checks["phase 4"]["plain_f64"],
        ms=time_ms(lambda: accumulated(step)),
        plain_ms=time_ms(lambda: accumulated(step, plain=True), reps=5),
        addmm_ms=addmm_ms,
        shape=f"[{K}, {ns}] u8 Poisson({GRAM_LAMBDA:g}) table in {n_blocks} blocks of {step} rows",
        tol=f"rel {GRAM_RTOL:g} of max |G| to one launch, to the plain order and to numpy "
            "float64; bit-reproducible",
        path="train_streamed", block_rows=step, wide_block_rows=wide_step,
        replaces="kpop_tpu/parallel/sharded.py:639",
    )
    del x, vecs, got, plain, again
    torch.cuda.empty_cache()
    return row, blocked_row


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
    plan = pl.count_plan(codes.shape[1] - params.k + 1, params.n_vocab)
    alone = count_alone_ms(params, codes)
    wrapper = time_ms(lambda: pl.count_spectra(params, codes))
    log("kernel count_spectra at %s: %s (plain and a second call); %d slices of %d u%d "
        "counters, %s; kernels alone %.4f ms, wrapper %.4f ms"
        % (what, COUNT_TOL, plan.slices, plan.cells, plan.bits,
           "bucketed" if plan.bucket else "read-all", alone, wrapper))
    del again, want
    return got


def count_bucketed_rows(dev, shapes=((ENCODE_B, ENCODE_L, K, READS_V),
                                      (TB_B, TB_L, TB_K, TB_V))) -> dict:
    """The count at the read-set cells' shapes, where ``count_plan``
    buckets (asserted): read sets shaped as :func:`read_like_codes` makes
    them (the second of one k-mer, all in one bucket) at each ``(B, L, k,
    V)`` of ``shapes``, each torch.equal to its plain version on the whole
    vocabulary and in COUNT_RANGES row ranges with every read set's known
    windows (:func:`count_check`, :func:`count_rows_check`), the one-k-mer
    read set counted at every window.  Returns the kernel table's row of
    the first shape: the wrapper's time, its kernels' alone, the plain
    version's, and the bound (codes and LUT read once, the spectra written
    once)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    row = None
    for i, (B, L, k, V) in enumerate(shapes):
        rng = np.random.default_rng(21 + i)
        params = random_params(rng, dev, V, 8, 4, k)
        codes = torch.as_tensor(read_like_codes(rng, B, L), device=dev)
        W = L - k + 1
        ranged = pl.count_plan(W, -(-V // COUNT_RANGES))
        if not (pl.count_plan(W, V).bucket and ranged.bucket):
            raise AssertionError(f"count_plan reads all at {B} x {W} windows, k = {k}, V = {V}")
        what = f"[{B}, {L}], k={k}, V={V}"
        got = count_check(params, codes, what)
        one = float(got[1, 0])
        if one != float(np.float32(W)):
            raise AssertionError(f"count_spectra at {what}: the one-k-mer read set counted {one} "
                                 f"of {W} windows")
        count_rows_check(params, codes, what)
        if row is None:
            row = dict(
                bound(codes.nbytes + params.vocab_lut.nbytes + got.nbytes,
                      B * W / F32_FLOPS * 1e3),
                library_ms=None, err=0.0, tol=COUNT_TOL,
                ms=time_ms(lambda: pl.count_spectra(params, codes)),
                alone_ms=count_alone_ms(params, codes),
                plain_ms=time_ms(lambda: pl.count_spectra_ref(params, codes), reps=3),
                shape=f"[{B}, {L}] int8 codes, k={k}, V={V}: the bucketed plan (the slice "
                      "path's launches count genomes, read-all)",
                source="kpop_tpu_torch/csrc/count_spectra.cu",
                replaces="kpop_tpu/ops/pipeline.py:179",
                launch="kpop_count_spectra", path="slice",
            )
        del params, codes, got
        torch.cuda.empty_cache()
    return row


def count_alone_ms(params, codes, row0: int = 0, rows: int | None = None, known: bool = False,
                   wire=None) -> float:
    """The count's kernels alone (:func:`kernel_alone_ms`) on the read sets
    of ``codes``, or on the same read sets on the 2-bit ``wire``
    (``PackedReads``), into rows ``[row0, row0 + rows)``, with the plan and
    scratch that ``count_spectra`` takes (``pipeline.count_workspace``)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    B, L = codes.shape
    V = params.n_vocab
    rows = V if rows is None else rows
    suffix, vocab = pl.vocab_args("count_spectra", params, codes)
    bucket, scratch = pl.count_workspace(B, L, params.k, rows, codes.device)
    out = torch.empty((B, rows), dtype=torch.float32, device=codes.device)
    name, reads = ("kpop_count_spectra" + suffix, (codes.data_ptr(),)) if wire is None else (
        "kpop_count_spectra" + suffix + "_packed", (wire.packed.data_ptr(), wire.valid.data_ptr()))
    return kernel_alone_ms(name, *reads, B, L, params.k, int(params.canonical), params.base,
                           *vocab, V, row0, rows, int(known), bucket, scratch.data_ptr(),
                           out.data_ptr())


def count_rows_check(params, codes, what: str, timed: bool = False):
    """The count over COUNT_RANGES row ranges of ceil(V / COUNT_RANGES)
    rows, as the ranks of k-mer-sharded serving count them (the last one
    past V): each torch.equal to its plain version and to those columns of
    the whole-vocabulary kernel (zero past V), with each read set's count of
    all its known windows equal to the plain version's and to the whole
    spectrum's row sum.  With ``timed``, the kernel table's row of the
    first range."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl

    whole = pl.count_spectra(params, codes)
    V = params.n_vocab
    V_local = -(-V // COUNT_RANGES)
    sums = whole.sum(dim=1, dtype=torch.float64)
    for j in range(COUNT_RANGES):
        row0 = j * V_local
        got, known = pl.count_spectra(params, codes, row0, V_local, known=True)
        want, known_ref = pl.count_spectra_ref(params, codes, row0, V_local, known=True)
        torch.cuda.synchronize()
        n = min(V, row0 + V_local) - row0
        same = (torch.equal(got, want), torch.equal(got[:, :n], whole[:, row0: row0 + n]),
                not got[:, n:].any(), torch.equal(known, known_ref),
                torch.equal(known.double(), sums))
        if not all(same):
            raise AssertionError(f"count_spectra rows [{row0}, {row0 + V_local}) at {what}: "
                                 f"(plain, whole, zero past V, known, row sums) equal: {same}")
        del got, want
    log("kernel count_spectra rows at %s: %d ranges of %d rows, each %s (plain, the whole "
        "kernel's columns) with every read set's known windows" % (what, COUNT_RANGES, V_local,
                                                                   COUNT_TOL))
    if not timed:
        return None
    B, L = codes.shape
    ranges_ms = [time_ms(lambda: pl.count_spectra(params, codes, j * V_local, V_local, known=True))
                 for j in range(COUNT_RANGES)]
    alone = count_alone_ms(params, codes, 0, V_local, True)
    log("kernel count_spectra rows at %s: ms as called by range %s, the first range's kernels "
        "alone %.4f ms; the whole vocabulary %.4f ms as called"
        % (what, ", ".join("%.4f" % t for t in ranges_ms), alone,
           time_ms(lambda: pl.count_spectra(params, codes))))
    table = params.vocab_lut if params.vocab_lut is not None else params.cuckoo
    # codes and the table read once, the [B, V_local] range and the known
    # counts written once; one add per window
    return dict(
        bound(codes.nbytes + table.nbytes + B * V_local * 4 + B * 4,
              B * (L - params.k + 1) / F32_FLOPS * 1e3),
        err=0.0, tol=COUNT_TOL, library_ms=None,
        ms=time_ms(lambda: pl.count_spectra(params, codes, 0, V_local, known=True)),
        plain_ms=time_ms(lambda: pl.count_spectra_ref(params, codes, 0, V_local, known=True),
                         reps=3),
        shape=f"{what}, rows [0, {V_local}) of {V}",
        source="kpop_tpu_torch/csrc/count_spectra.cu",
        replaces="kpop_tpu/parallel/serving.py:113 (the shard's scatter; "
                 "kpop_tpu/ops/pipeline.py:179)",
        launch="kpop_count_spectra" + ("" if params.vocab_lut is not None else "_wide"),
        path="sharded",
    )


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


def wide_params(dev, space, kmer_codes, tw, sorted_limbs: bool = False):
    """Classifier parameters of the uint64 k-mer codes ``kmer_codes`` around
    the twister ``tw``: the cuckoo hash, or the sorted limbs (the fallback
    the builder takes when no seed converges)."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl
    from kpop_tpu_torch.ops.encode import split_k

    if sorted_limbs:
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


def bf16_regime_rows(dev, rng, params, d: int) -> dict:
    """The bag on bf16 rows at d = d in the regime each entry point does not
    take on phase 3's batches (``bag_bf16_row``, the regime asserted): the
    LUT entry point (k = 10) in the gather regime, on 128 read sets of 390
    bases (a few entries a vocabulary tile); the wide one (k = 16, cuckoo) in
    the staged regime, on 128 read sets of 30,208 bases, each 150 bp reads
    from one 20 kb genome, around a vocabulary of 20,000 k-mers that holds a
    quarter of the genome's (thousands of entries a tile)."""
    import torch

    from kpop_tpu_torch.core.kmers import KmerSpace

    rows = {}
    short = torch.as_tensor(read_like_codes(rng, BATCH, 390), device=dev)
    rows["embedding_bag_bf16_gather"] = bag_bf16_row(
        params, short, params.vocab_lut, f"[{BATCH}, 390] int8 codes, k={K}, twister "
        f"{list(params.twister.shape)}", "kpop_tpu/ops/pipeline.py:237", "kpop_embedding_bag",
        "slice_bf16", regime="gather")
    rows["embedding_bag_packed_bf16_gather"] = packed_bag_row(
        bf16_of(params), short, params.vocab_lut, f"[{BATCH}, 390], k={K}, twister "
        f"{list(params.twister.shape)}", PACKED_BAG_REPLACES + " (:237-240)",
        regime="gather")
    genome = rng.integers(0, 4, size=20_000, dtype=np.int8)
    starts = rng.integers(0, len(genome) - 150, size=(BATCH, 30_208 // 151 + 1))
    reads = genome[starts[:, :, None] + np.arange(150)]  # [B, reads, 150]
    dense = np.concatenate([reads, np.full(reads.shape[:2] + (1,), -1, np.int8)], axis=2)
    dense = torch.as_tensor(dense.reshape(BATCH, -1)[:, :30_208].copy(), device=dev)
    space = KmerSpace("DNA-ds", LARGE_K)
    kmers = wide_vocabulary(rng, dense, LARGE_K, 4, True, 20_000)
    tw = torch.randn((20_000, d), generator=torch.Generator(dev).manual_seed(8), device=dev)
    wide = wide_params(dev, space, kmers, tw)
    rows["embedding_bag_wide_bf16_staged"] = bag_bf16_row(
        wide, dense, wide.cuckoo, f"[{BATCH}, 30208] int8 codes of one 20 kb genome, "
        f"k={LARGE_K}, V=20000, cuckoo", "kpop_tpu/ops/pipeline.py:237 with :165-176",
        "kpop_embedding_bag_wide", "large_k_bf16", regime="staged")
    rows["embedding_bag_wide_packed_bf16_staged"] = packed_bag_row(
        bf16_of(wide), dense, wide.cuckoo, f"[{BATCH}, 30208] of one 20 kb genome, k={LARGE_K}, "
        "V=20000, cuckoo", PACKED_WIDE_BAG_REPLACES, regime="staged")
    del short, dense, wide, tw
    torch.cuda.empty_cache()
    return rows


def wide_blocks(dev, rng, codes, twister, first: int = 4) -> dict:
    """Large-k inputs for the wide count and bag, each with classifier
    parameters around a random twister: phase 3's batch at k = 16 with
    V = LARGE_K_VOCAB (the phase 7 vocabulary's size; a cuckoo table of [6,
    2^21]) on the cuckoo hash and on the sorted-limb fallback, the same
    batch at DNA-ds k = 30 (two 30-bit limbs, V = 367,987), and protein
    read sets at k = 8 (base 20, V = 200,000); the ``first`` of them."""
    import torch

    from kpop_tpu_torch.core.kmers import KmerSpace

    def params_of(space, kmer_codes, tw, sorted_limbs=False):
        return wide_params(dev, space, kmer_codes, tw, sorted_limbs)

    B, L = codes.shape
    out = {}
    space = KmerSpace("DNA-ds", LARGE_K)
    kmers = wide_vocabulary(rng, codes, LARGE_K, 4, True, LARGE_K_VOCAB)
    out[f"[{B}, {L}], k={LARGE_K}, V={LARGE_K_VOCAB}, cuckoo"] = (params_of(space, kmers, twister), codes)
    out[f"[{B}, {L}], k={LARGE_K}, V={LARGE_K_VOCAB}, sorted limbs"] = (
        params_of(space, kmers, twister, sorted_limbs=True), codes)
    if first <= 2:
        return out
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
        if i == 1:  # the sorted limbs on the 2-bit wire, beside the cuckoo row
            limbs = packed_count_row(params, c, table, what, PACKED_WIDE_REPLACES)
            rows["count_spectra_wide_packed"]["sorted_limbs"] = {
                k: limbs[k] for k in ("ms", "alone_ms", "int8_ms", "int8_alone_ms", "bound_ms")}
        if i:
            del got
            continue
        B, L = c.shape
        W = L - params.k + 1
        want = pl.project_reads_ref(params, c)
        bag_lib, n_known, hit, entries, tiles = bag_library_call(params, c, want)
        log("kernel wide lookup at %s: %d of %d windows known, %d distinct rows hit, %d "
            "entries in %d tiles: the bag's %s regime"
            % (what, n_known, B * W, hit, entries, tiles, pl.bag_regime(entries, tiles)))
        # no library call counts into a [B, V] spectrum from window codes:
        # index_add_ or a sparse product needs the kernel's own lookup first
        common = dict(shape=what, path="large_k", replaces="kpop_tpu/ops/cuckoo.py:121")
        # codes and the table read once, the [B, V] spectra written once;
        # one add per window
        rows["count_spectra_wide"] = dict(
            bound(c.nbytes + table.nbytes + got.nbytes, B * W / F32_FLOPS * 1e3),
            err=0.0, tol=COUNT_TOL, library_ms=None,
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
            err=float((bag - want).abs().max()),
            err_f64=err, plain_err_f64=plain_err,
            library_ms=time_ms(bag_lib, reps=5),
            tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}; err to float64 <= {F64_ERR_RATIO:g}x the plain version's",
            ms=time_ms(lambda: pl.project_reads(params, c), reps=5),
            device_ms=device_call_ms(lambda: pl.project_reads(params, c)),
            plain_ms=time_ms(lambda: pl.project_reads_ref(params, c), reps=3),
            source="kpop_tpu_torch/csrc/embedding_bag.cu", launch="kpop_embedding_bag_wide",
            **common)
        del bag, want, bag_lib
        rows["embedding_bag_wide_bf16"] = bag_bf16_row(
            params, c, table, what, "kpop_tpu/ops/pipeline.py:237 with :165-176",
            "kpop_embedding_bag_wide", "large_k_bf16")
        # the same batch on the 2-bit wire: the wide count, the wide bag on
        # f32 and bf16 rows (the gather regime)
        rows["count_spectra_wide_packed"] = packed_count_row(
            params, c, table, what, PACKED_WIDE_REPLACES)
        rows["embedding_bag_wide_packed"] = packed_bag_row(
            params, c, table, what, PACKED_WIDE_BAG_REPLACES, regime="gather")
        rows["embedding_bag_wide_packed_bf16"] = packed_bag_row(
            bf16_of(params), c, table, what, PACKED_WIDE_BAG_REPLACES,
            regime="gather")
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
    count_rows_check(params, codes, f"[{B}, {L}], k={K}, V={V}")
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
    rows["count_spectra_bucketed"] = count_bucketed_rows(dev)
    # the dense route's product with the twister cast to bf16
    bf16_product_check(got, params.twister)
    del got

    bag_err_f64, bag_plain_err_f64 = bag_errors(params, codes, "at the slice's batch")
    bag_two_groups(params, np.random.default_rng(3), L)
    batch_limits(dev, params, np.random.default_rng(12))
    got = pl.project_reads(params, codes)
    want = pl.project_reads_ref(params, codes)
    # codes and LUT read once, each twister row the reads hit read once, the
    # [B, d] output written once; an add per known window and column
    bag_lib, n_known, hit, entries, tiles = bag_library_call(params, codes, want)
    # what a gather of one row per known window moves, against the hit
    # rows read once
    log("kernel embedding_bag: %d known windows hit %d distinct rows of %d (%d entries: the "
        "%s regime); a row per window gathers %.4g GB, the hit rows once %.4g GB (each hit "
        "row %.2fx a batch); max abs err to float64 %.3g, plain version %.3g"
        % (n_known, hit, V, entries, pl.bag_regime(entries, tiles), n_known * 4.0 * d / 1e9,
           hit * 4.0 * d / 1e9, n_known / max(hit, 1), bag_err_f64, bag_plain_err_f64))
    rows["embedding_bag"] = dict(
        bound(codes.nbytes + params.vocab_lut.nbytes + hit * d * 4 + got.nbytes,
              float(n_known) * d / F32_FLOPS * 1e3),
        library_ms=time_ms(bag_lib, reps=5),
        err=float((got - want).abs().max()),
        err_f64=bag_err_f64, plain_err_f64=bag_plain_err_f64,
        ms=time_ms(lambda: pl.project_reads(params, codes), reps=5),
        device_ms=device_call_ms(lambda: pl.project_reads(params, codes)),
        plain_ms=time_ms(lambda: pl.project_reads_ref(params, codes), reps=3),
        shape=f"[{B}, {L}] int8 codes, k={K}, twister [{V}, {d}]",
        tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}; err to float64 <= {F64_ERR_RATIO:g}x the plain version's",
        source="kpop_tpu_torch/csrc/embedding_bag.cu",
        replaces="kpop_tpu/ops/pipeline.py:200",
        launch="kpop_embedding_bag", path="slice",
    )
    del bag_lib
    rows["embedding_bag_bf16"] = bag_bf16_row(
        params, codes, params.vocab_lut, f"[{B}, {L}] int8 codes, k={K}, twister [{V}, {d}]",
        "kpop_tpu/ops/pipeline.py:237", "kpop_embedding_bag", "slice_bf16")
    # the same batch on the 2-bit wire: the LUT count, and the bag on f32
    # and on bf16 rows (the staged regime)
    rows["count_spectra_packed"] = packed_count_row(
        params, codes, params.vocab_lut, f"[{B}, {L}], k={K}, V={V}", PACKED_COUNT_REPLACES)
    rows["embedding_bag_packed"] = packed_bag_row(
        params, codes, params.vocab_lut, f"[{B}, {L}], k={K}, twister [{V}, {d}]",
        PACKED_BAG_REPLACES, regime="staged")
    rows["embedding_bag_packed_bf16"] = packed_bag_row(
        bf16_of(params), codes, params.vocab_lut, f"[{B}, {L}], k={K}, twister [{V}, {d}]",
        PACKED_BAG_REPLACES + " (:237-240)", regime="staged")
    rows.update(wide_rows(dev, np.random.default_rng(7), codes, d))
    rows.update(bf16_regime_rows(dev, np.random.default_rng(9), params, d))

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
    rows["encode_bytes"] = encode_bytes_row(dev)
    rows["row_digest"] = digest_row(dev, flagship)
    del flagship
    torch.cuda.empty_cache()
    rows["ca_gram"], rows["ca_gram_streamed"] = gram_row(dev)
    for name, r in rows.items():
        log(
            "kernel %-26s %s: max abs err %.3g (%s); kernel %.4f ms%s, plain "
            "%.4f ms, library %s ms, bound %.4f ms (%s)"
            % (name, r["shape"], r["err"], r["tol"], r["ms"],
               " (device %.4f ms)" % r["device_ms"] if "device_ms" in r else "", r["plain_ms"],
               "%.4f" % r["library_ms"] if r["library_ms"] is not None else "none",
               r["bound_ms"], r["bound_by"])
        )
    return rows


def encode_bytes_row(dev) -> dict:
    """``kpop_encode_bytes`` at the read-set cell's batch: ENCODE_B rows of
    ENCODE_L bytes (ACGT, ``N`` joins, about 1 % of the bytes in runs of 8
    dashes), staged by ``ByteRing`` and uploaded as
    ``DeviceStep(wire="bytes")`` stages them; the wrapper's codes
    torch.equal to ``encode_bytes_ref`` on the card and to the host
    encoder's (``native.encode_batch``, the "codes" wire's) on its columns,
    -1 past them; the wrapper's time, the kernel's alone, the plain
    version's, and the bound: the rows read once and the codes written
    once."""
    import torch

    from kpop_tpu_torch import native
    from kpop_tpu_torch.core.kmers import _DNA_CODE
    from kpop_tpu_torch.ops.encode import ENCODE_CHUNK, ByteRing, encode_bytes, encode_bytes_ref

    rng = np.random.default_rng(17)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for _ in range(ENCODE_B):
        raw = letters[rng.integers(0, 4, size=ENCODE_L)]
        raw[rng.integers(0, ENCODE_L, size=ENCODE_L // 300)] = ord("N")
        for at in rng.integers(0, ENCODE_L, size=ENCODE_L // 800):
            raw[at: at + 8] = ord("-")
        seqs.append(raw.tobytes().decode())
    ring = ByteRing(pinned=dev.type == "cuda")
    staged = ring.reserve(seqs)
    ring.fill(staged)
    rows, lengths = staged.split(staged.buffer.to(dev))
    table = torch.from_numpy(_DNA_CODE).to(dev)
    width = staged.longest
    got = encode_bytes(rows, lengths, width, table)
    host = native.encode_batch(seqs, False)
    codes, w = got.cpu().numpy(), host.shape[1]
    plain = bool(torch.equal(got, encode_bytes_ref(rows, lengths, width, table)))
    if not (plain and np.array_equal(codes[:, :w], host) and (codes[:, w:] == -1).all()):
        raise AssertionError(f"kernel encode_bytes: codes equal to the plain version's {plain}, "
                             f"to the host encoder's {np.array_equal(codes[:, :w], host)}")
    dashes = [s.count("-") for s in seqs]
    log("kernel encode_bytes: %d rows of %d bytes, %d to %d dashes a row; torch.equal to the "
        "plain version and to the host encoder's %d columns"
        % (ENCODE_B, ENCODE_L, min(dashes), max(dashes), w))
    work = torch.empty(ENCODE_B * (-(-max(staged.stride, width) // ENCODE_CHUNK) + 1),
                       dtype=torch.int32, device=dev)
    out = torch.empty_like(got)
    return dict(
        bound(int(lengths.sum()) + lengths.nbytes + got.nbytes, 0.0),
        library_ms=None,
        err=0.0,
        ms=time_ms(lambda: encode_bytes(rows, lengths, width, table)),
        alone_ms=kernel_alone_ms("kpop_encode_bytes", rows.data_ptr(), lengths.data_ptr(),
                                 ENCODE_B, staged.stride, width, table.data_ptr(),
                                 work.data_ptr(), out.data_ptr()),
        plain_ms=time_ms(lambda: encode_bytes_ref(rows, lengths, width, table), reps=3),
        shape=f"[{ENCODE_B}, {ENCODE_L}] u8 bytes with dashes, DNA lint table",
        tol=COUNT_TOL + "; the host encoder's codes on its columns, -1 past them",
        source="kpop_tpu_torch/csrc/encode_bytes.cu",
        replaces="kpop_tpu/native/kpop_native.cpp:347 (on the host)",
        launch="kpop_encode_bytes", path="slice",
    )


# ---------------- the 2-bit wire --------------------------------------------


def packed_reads(codes):
    """int8 codes on the card -> the same read sets on the 2-bit wire on
    the card, packed on the host (``pack_reads_2bit``)."""
    import torch

    from kpop_tpu_torch.ops.encode import PackedReads, pack_reads_2bit

    packed, valid = pack_reads_2bit(codes.cpu().numpy())
    return PackedReads(torch.as_tensor(packed, device=codes.device),
                       torch.as_tensor(valid, device=codes.device), codes.shape[1])


def wire_nbytes(reads) -> int:
    """The wire's bytes: 2 bits a base and 1 bit a position, 3/8 of a byte
    a base."""
    return reads.packed.nbytes + reads.valid.nbytes


def packed_count_row(params, codes, table, what: str, replaces: str,
                     rows_range: tuple | None = None) -> dict:
    """The count on the 2-bit wire (``kpop_count_spectra[_wide]_packed``) on
    the read sets of ``codes``: torch.equal to its plain version (the wire
    unpacked, then the plain count) and to the int8 entry point on the same
    reads, over the whole vocabulary or ``rows_range`` (row0, rows, with
    each read set's known windows); its time as called and its kernels'
    alone, each beside the int8 entry point's in the same call, and its
    bound with the wire read at 3/8 of a byte a base.  No library call
    (as for the count), and off the kernel table: no served path takes the
    wire."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl
    from kpop_tpu_torch.ops.encode import as_codes

    reads = packed_reads(codes)
    V = params.n_vocab
    row0, rows, known = (0, V, False) if rows_range is None else (*rows_range, True)

    def count(r):
        return pl.count_spectra(params, r, row0, rows, known)

    def plain():
        return pl.count_spectra_ref(params, as_codes(reads), row0, rows, known)

    got, twin, want = count(reads), count(codes), plain()
    torch.cuda.synchronize()
    flat = (lambda x: x if isinstance(x, tuple) else (x,))  # noqa: E731
    same = (all(torch.equal(a, b) for a, b in zip(flat(got), flat(twin))),
            all(torch.equal(a, b) for a, b in zip(flat(got), flat(want))))
    if not all(same):
        raise AssertionError(f"packed count at {what}: equal to (the int8 entry point, the plain "
                             f"version): {same}")
    B, L = codes.shape
    name = "kpop_count_spectra" + pl.vocab_args("count_spectra", params, codes)[0]
    alone = count_alone_ms(params, codes, row0, rows, known, reads)
    int8_alone = count_alone_ms(params, codes, row0, rows, known)
    del twin, want
    ms, int8_ms = time_ms(lambda: count(reads)), time_ms(lambda: count(codes))
    plain_ms = time_ms(plain, reps=3)
    W = L - params.k + 1
    log("kernel count_spectra on the 2-bit wire at %s%s: %s (plain, the int8 entry point); "
        "%.4f ms as called (int8 %.4f), kernels alone %.4f (int8 %.4f); wire %d B against %d B "
        "of codes" % (what, "" if rows_range is None else f", rows [{row0}, {row0 + rows})",
                      COUNT_TOL, ms, int8_ms, alone, int8_alone, wire_nbytes(reads), codes.nbytes))
    # the wire and the table read once, the spectra (and the known counts)
    # written once; one add per window
    return dict(
        bound(wire_nbytes(reads) + table.nbytes + B * rows * 4 + (B * 4 if known else 0),
              B * W / F32_FLOPS * 1e3),
        err=0.0, tol=COUNT_TOL + " to the plain version and to the int8 entry point",
        library_ms=None, ms=ms, plain_ms=plain_ms, alone_ms=alone, int8_ms=int8_ms,
        int8_alone_ms=int8_alone,
        shape="%s, the 2-bit wire%s" % (what, "" if rows_range is None else
                                        f", rows [{row0}, {row0 + rows}) of {V}"),
        source="kpop_tpu_torch/csrc/count_spectra.cu", replaces=replaces,
        launch=name + "_packed", path=None,
    )


def packed_bag_row(params, codes, table, what: str, replaces: str,
                   regime: str | None = None) -> dict:
    """The bag on the 2-bit wire (``kpop_embedding_bag[_wide]_packed``) on
    the read sets of ``codes``: torch.equal to the int8 entry point on the
    same reads, within the bag's tolerances of its plain version (the wire
    unpacked, then the plain bag) and of float64 (``bag_errors``), in the
    regime ``regime`` where given; its time as called and its kernels'
    alone, each beside the int8 entry point's in the same call, and its
    bound with the wire read at 3/8 of a byte a base and each hit row once.
    No library call (as for the count), and off the kernel table: no served
    path takes the wire."""
    import torch

    from kpop_tpu_torch.ops import pipeline as pl
    from kpop_tpu_torch.ops.encode import as_codes
    from kpop_tpu_torch.ops.pairwise import _sm_count

    reads = packed_reads(codes)
    got, twin = pl.project_reads(params, reads), pl.project_reads(params, codes)
    torch.cuda.synchronize()
    if not torch.equal(got, twin):
        raise AssertionError(f"packed bag at {what} differs from the int8 entry point: "
                             f"{float((got - twin).abs().max()):.3g}")
    err, plain_err = bag_errors(params, reads, "on the 2-bit wire at " + what)
    bf16 = params.twister.dtype == torch.bfloat16
    want = pl.project_reads_ref(params, codes)
    _lib, n_known, hit, entries, tiles = bag_library_call(
        params, codes, want, rtol=BF16_LIBRARY_RTOL if bf16 else LIBRARY_RTOL)
    taken = pl.bag_regime(entries, tiles)
    if regime is not None and taken != regime:
        raise AssertionError(f"packed bag at {what} takes the {taken} regime, not {regime}")
    B, L = codes.shape
    tw = params.twister
    V, d = tw.shape
    S = pl.bag_plan(V, d, _sm_count(codes.device))
    Bg = min(pl.BAG_GROUP, B)
    iwork = torch.empty(pl.bag_workspace_ints(Bg, L, params.k, V), dtype=torch.int32,
                        device=codes.device)
    fwork = torch.empty(S * Bg * d, dtype=torch.float32, device=codes.device)
    out = torch.empty((B, d), dtype=torch.float32, device=codes.device)
    suffix, vocab = pl.vocab_args("project_reads", params, codes)
    args = (B, L, params.k, int(params.canonical), params.base, *vocab, V, tw.data_ptr(),
            pl.BAG_ROW_TYPES[tw.dtype], d, tw.stride(0), 1, S, iwork.data_ptr(), fwork.data_ptr(),
            out.data_ptr())
    name = "kpop_embedding_bag" + suffix
    alone = kernel_alone_ms(name + "_packed", reads.packed.data_ptr(), reads.valid.data_ptr(),
                            *args)
    int8_alone = kernel_alone_ms(name, codes.data_ptr(), *args)
    del iwork, fwork, out, twin, _lib
    ms = time_ms(lambda: pl.project_reads(params, reads), reps=5)
    int8_ms = time_ms(lambda: pl.project_reads(params, codes), reps=5)
    plain_ms = time_ms(lambda: pl.project_reads_ref(params, as_codes(reads)), reps=3)
    log("kernel embedding_bag on the 2-bit wire at %s%s: torch.equal to the int8 entry point, "
        "the %s regime; max abs err to float64 %.3g, plain version %.3g; %.4f ms as called "
        "(int8 %.4f), kernels alone %.4f (int8 %.4f)"
        % (what, ", bf16 twister" if bf16 else "", taken, err, plain_err, ms, int8_ms, alone,
           int8_alone))
    row = dict(
        bound(wire_nbytes(reads) + table.nbytes + hit * d * tw.element_size() + got.nbytes,
              float(n_known) * d / F32_FLOPS * 1e3),
        err=float((got - want).abs().max()), err_f64=err, plain_err_f64=plain_err,
        tol=f"torch.equal to the int8 entry point; rtol {BAG_RTOL}, atol {BAG_ATOL} of the plain "
            f"version; err to float64 <= {F64_ERR_RATIO:g}x the plain version's",
        library_ms=None, ms=ms, plain_ms=plain_ms, alone_ms=alone, int8_ms=int8_ms,
        int8_alone_ms=int8_alone, regime=taken,
        shape="%s, the 2-bit wire%s" % (what, ", bf16 twister" if bf16 else ""),
        source="kpop_tpu_torch/csrc/embedding_bag.cu", replaces=replaces,
        launch=name + "_packed", path=None,
    )
    del got, want
    torch.cuda.empty_cache()
    return row


def twin_serving(label: str, params, batches, dmats, kernels, paths) -> dict:
    """The read sets served on ``paths`` through ``DeviceStep(wire="codes")``
    (int8 codes encoded on the host), a twin of the default bytes wire: the
    main path of serve_routes (every count set to 0 just before, read just
    after; each of ``kernels`` launched; accuracy >= ACCURACY_GATE), the
    card's encode not launched, and each route's distances equal to
    ``dmats``, the bytes wire's."""
    got, launches, accuracy, busy, launch_ms = serve_routes(label, params, batches, kernels, paths,
                                                            wire="codes")
    if launches["kpop_encode_bytes"]:
        raise AssertionError(f"{label}: the codes wire launched kpop_encode_bytes")
    for path in paths:
        if not np.array_equal(np.concatenate(got[path]), np.concatenate(dmats[path])):
            raise AssertionError(f"{label}, {path}: distances differ from the bytes wire's")
    log("%s: distances equal to the bytes wire's on %s" % (label, ", ".join(paths)))
    return dict(launches=launches, accuracy=accuracy, busy=busy, launch_ms=launch_ms)


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


def serve_routes(label: str, params, batches, kernels, paths=("dense", "bag"),
                 wire: str | None = None) -> tuple:
    """The main path: the read sets served on the dense and the bag route
    (or ``paths``), every launch count set to 0 just before and read just
    after, each of ``kernels`` launched, the read sets sent on ``wire``
    (DeviceStep's; by default its own, the bytes wire on a card); finite
    [read sets, classes]
    distances and top-1 accuracy >= ACCURACY_GATE on each route; then each
    route's device time a batch and its largest kernels.  Returns (distance
    blocks by route, launches, accuracy, device ms a batch, and device ms a
    batch by launch for each route)."""
    from kpop_tpu_torch import _build
    from kpop_tpu_torch.cli.classify import DeviceStep

    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    steps = {path: DeviceStep(params, path, wire=wire) for path in paths}
    dmats = {path: serve(step, batches) for path, step in steps.items()}
    launches = dict(_build.LAUNCHES)
    log("%s: kernel launches on the main path (the %s wire): %s"
        % (label, steps[paths[0]].wire, json.dumps(launches)))
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
    busy, launch_ms = {}, {}
    for path in paths:
        by_kernel = device_ms_by_kernel(lambda: serve(DeviceStep(params, path, wire=wire), batches))
        busy[path] = sum(by_kernel.values()) / len(batches)
        launch_ms[path] = {k: v / len(batches) for k, v in by_kernel.items()}
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        log("%s: %s route device time %.4f ms a batch of %d (torch.profiler), by launch: %s"
            % (label, path, busy[path], len(batches[0][0]),
               ", ".join("%s %.4f" % (k[:40], v / len(batches)) for k, v in top)))
    return dmats, launches, accuracy, busy, launch_ms


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


def stream_geometry(nk: int, ns: int, kind: str, dev) -> tuple[int, int]:
    """The budget forced on a streamed fit of a ``[nk, ns]`` table on the
    ``kind`` wire with phi on the host, so that it streams in STREAM_BLOCKS
    row blocks, and the rows a block that ``ca_fit_sharded`` takes within
    it (``LAST_CA_STREAM["block_rows"]``)."""
    from kpop_tpu_torch.ops import gram
    from kpop_tpu_torch.parallel import sharded

    d = min(nk, ns) - 1
    step = (64 << 20) // (ns * 8)  # phi's sub-blocks: ca_fit_sharded's default block_bytes
    args = (ns, d, sharded.WIRE_BYTES[kind], step, gram._sm_count(dev))
    budget = sharded._stream_footprint(-(-nk // STREAM_BLOCKS), *args)
    return budget, sharded._stream_block_rows(budget, nk, *args)


def streamed_fits(dev, table, col_w, label: str, host=None, sv_resident=None,
                  show_copies: bool = False, kind: str = "u8") -> dict:
    """The table fitted again on the streamed path, its budget forced so
    that it streams in STREAM_BLOCKS row blocks: with phi on the host, then
    with the twister on the card, whose budget adds the twister's bytes, so
    that both take the same blocks.  Each fit's device memory above what
    was live before it stays within its budget; both streamed at least
    STREAM_BLOCKS_MIN blocks; the card's twister is the host fit rounded to
    f32 and the other outputs are equal; with ``host`` the fit is within
    CA_BOUNDS of host ``fit_ca``, with ``sv_resident`` its sv within
    STREAM_SV_RTOL of the resident fit's.  ``kind`` is the wire the table
    must take.  With ``show_copies`` the device
    fit runs once more under torch.profiler, where the blocks' uploads
    must show as copies from pinned memory (the column vectors and V / sv,
    a few MB, go up from pageable memory once a pass).  Returns the device fit's outputs and
    launches (every count set to 0 just before it and read just after),
    the host fit's float64 twister, and the geometry, walls and peaks."""
    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.parallel import sharded

    nk, ns = table.shape
    d = min(nk, ns) - 1
    budget, rows = stream_geometry(nk, ns, kind, dev)
    out = {}
    for phi, limit in (("host", budget), ("device", budget + nk * d * 4)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        fit = sharded.ca_fit_sharded(table, col_weights=col_w, phi=phi, device=dev,
                                     hbm_bytes=limit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - live
        st = dict(sharded.LAST_CA_STREAM or {})
        gram_launches = [_build.LAUNCHES[name] for name in GRAM_LAUNCHES]
        log("%s: streamed fit, phi on the %s: %s; %.3f s: %s; peak device memory %d B above the "
            "%d B live before, budget %d B; kpop_ca_gram launched %d times, "
            "kpop_ca_gram_finish %d"
            % (label, phi, json.dumps(st), wall,
               ", ".join("%s %.4f s" % kv for kv in sharded.LAST_CA_PHASES.items()),
               peak, live, limit, *gram_launches))
        if gram_launches != [st.get("n_blocks"), 1]:
            raise AssertionError(f"{label}: the Gram pass launched {gram_launches} of "
                                 f"{GRAM_LAUNCHES} for {st.get('n_blocks')} blocks")
        if st.get("n_blocks", 0) < STREAM_BLOCKS_MIN or sharded.LAST_DD_UPLOAD != kind \
                or st["block_rows"] != rows:
            raise AssertionError(f"{label}: the fit with phi on the {phi} did not stream in "
                                 f"{STREAM_BLOCKS_MIN} blocks of {rows} rows on the {kind} "
                                 f"wire: {st}")
        if peak > limit:
            raise AssertionError(f"{label}: streamed fit used {peak} B above the {limit} B budget")
        out[phi] = dict(fit=fit, stream=st, wall=wall, phases=dict(sharded.LAST_CA_PHASES),
                        peak=peak, budget=limit, launches=dict(_build.LAUNCHES))
    (c_h, i_h, tw_h, sv_h), (c_d, i_d, tw_d, sv_d) = out["host"]["fit"], out["device"]["fit"]
    tw64 = torch.from_numpy(np.ascontiguousarray(tw_h.T))
    rounded = torch.equal(tw_d.cpu(), tw64.float())
    same = all(np.array_equal(a, b) for a, b in ((c_h, c_d), (i_h, i_d), (sv_h, sv_d)))
    same_blocks = out["host"]["stream"]["block_rows"] == out["device"]["stream"]["block_rows"]
    if not (rounded and same and same_blocks):
        raise AssertionError(f"{label}: the streamed device twister is not the streamed host fit "
                             f"rounded to f32 ({rounded}, outputs equal {same}, same blocks "
                             f"{same_blocks})")
    res = dict(coords=c_d, inertia=i_d, phi_dev=tw_d, sv=sv_d, tw64=tw_h,
               launches=out["device"]["launches"],
               **{f"{phi}_{k}": out[phi][k] for phi in out for k in ("stream", "wall", "phases",
                                                                     "peak", "budget")})
    if host is not None:
        ca_err = ca_errors(c_h, i_h, tw64, sv_h, host)
        bad = {k: v for k, v in ca_err.items() if not v <= CA_BOUNDS[k]}
        log("%s: streamed fit vs host fit_ca, max abs: %s; bounds %s"
            % (label, json.dumps(ca_err), json.dumps(CA_BOUNDS)))
        if bad:
            raise AssertionError(f"{label}: streamed fit off the host float64 fit: {bad}")
        res["ca_err"] = ca_err
    if sv_resident is not None:
        rel = float(np.abs(sv_h - sv_resident).max() / np.abs(sv_resident).max())
        log("%s: streamed sv vs the resident fit's: %.3g of the largest (bound %g)"
            % (label, rel, STREAM_SV_RTOL))
        if not rel <= STREAM_SV_RTOL:
            raise AssertionError(f"{label}: streamed sv {rel:.3g} off the resident fit")
        res["sv_rel"] = rel
    log("%s: the streamed device twister is the streamed host fit rounded to f32, its other "
        "outputs equal, on the same %d blocks" % (label, res["device_stream"]["n_blocks"]))
    if show_copies:
        by_kernel = device_ms_by_kernel(lambda: sharded.ca_fit_sharded(
            table, col_weights=col_w, phi="device", device=dev, hbm_bytes=out["device"]["budget"]))
        copies = {k: v for k, v in by_kernel.items() if k.startswith("Memcpy HtoD")}
        log("%s: streamed fit's copies to the card, device ms: %s; its Gram launches %.4f ms"
            % (label, json.dumps(copies), sum(v for k, v in by_kernel.items() if "gram_tile" in k)))
        if not any("Pinned" in k for k in copies):
            raise AssertionError(f"{label}: no upload of the streamed fit was pinned: {copies}")
    return res


def log_accumulate(label: str, f32_ms: dict, bf16_ms: dict) -> None:
    """The bag route's accumulate a batch (the gather and the staged ring,
    by torch.profiler) on f32 and on bf16 rows, from the same run."""
    def acc(by_kernel):
        return {regime: sum(v for k, v in by_kernel.items() if "bag_" + regime in k)
                for regime in ("gather", "accumulate")}

    log("%s: bag route's accumulate a batch, device ms: bf16 rows %s, f32 rows %s"
        % (label, json.dumps(acc(bf16_ms)), json.dumps(acc(f32_ms))))


def bf16_serving(label: str, params, batches, dmats, kernels, paths) -> dict:
    """The read sets served on ``paths`` with parameters around a bf16
    twister: the main path of serve_routes (every count set to 0 just
    before, read just after; accuracy >= ACCURACY_GATE), each route's
    distances within BF16_BOUND * max(1, |x|) of the f32 route's
    ``dmats``, and the device memory the serving takes above what was live
    below the f32 twister's bytes (no f32 copy of the twister)."""
    import torch

    if params.twister.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: the twister is {params.twister.dtype}, not bf16")
    f32_bytes = params.twister.numel() * 4
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, launches, accuracy, busy, launch_ms = serve_routes(label, params, batches, kernels, paths)
    peak = torch.cuda.max_memory_allocated() - live
    err = {}
    for path in paths:
        a, b = np.concatenate(got[path]), np.concatenate(dmats[path])
        err[path] = float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
    log("%s: bf16 twister %.1f MB (f32 %.1f MB); serving took %.1f MB above what was live; "
        "distances off the f32 route's by at most %s x max(1, |x|) (bound %g)"
        % (label, params.twister.nbytes / 1e6, f32_bytes / 1e6, peak / 1e6, json.dumps(err),
           BF16_BOUND))
    if peak >= f32_bytes:
        raise AssertionError(f"{label}: bf16 serving took {peak} B, an f32 twister's {f32_bytes}")
    if max(err.values()) > BF16_BOUND:
        raise AssertionError(f"{label}: bf16 distances off the f32 route: {err}")
    return dict(launches=launches, accuracy=accuracy, busy=busy, err=err, peak=peak,
                launch_ms=launch_ms, dmats=got)


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
    if not train_launches["kpop_ca_gram"] or train_launches["kpop_ca_gram_finish"] != 1:
        raise AssertionError("the train path's Gram pass did not launch the Gram kernel and "
                             f"one finish: {train_launches}")
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
    # the same fit streamed, its budget forced (the train_streamed path)
    streamed = streamed_fits(dev, table, col_w, "slice", host=ca, sv_resident=sv64,
                             show_copies=True)
    # the other wires on the same path, each the same CA as the host
    # reference and held to it and to its own resident fit: the table x 257
    # on the u16 wire (its column weights / 257), and the weighted table
    # itself, not exactly f32, on the f64 wire (no column weights)
    for kind, wire_table, w in (("u16", table.astype(np.uint16) * np.uint16(257), col_w / 257.0),
                                ("f64", table * col_w[None, :], None)):
        _, _, _, sv_res = sharded.ca_fit_sharded(wire_table, col_weights=w, device=dev)
        if sharded.LAST_DD_UPLOAD != kind or sharded.LAST_CA_STREAM is not None:
            raise AssertionError(f"slice {kind}: the resident fit took the "
                                 f"{sharded.LAST_DD_UPLOAD} wire, streamed {sharded.LAST_CA_STREAM}")
        streamed_fits(dev, wire_table, w, f"slice {kind}", host=ca, sv_resident=sv_res,
                      show_copies=True, kind=kind)
        del wire_table

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
    dmats, launches, accuracy, busy, launch_ms = serve_routes("slice", params, batches,
                                                              SLICE_KERNELS)
    # the same read sets as int8 codes encoded on the host
    codes_twin = twin_serving("slice codes", params, batches, dmats, SLICE_CODES_KERNELS,
                              ("dense", "bag"))
    log("slice: device ms a batch by route, bytes wire %s, int8 wire %s"
        % (json.dumps(busy), json.dumps(codes_twin["busy"])))
    # bf16 parameters around the streamed fit's device twister, both routes
    params16 = params_around_twister(space, vocab_hex, streamed.pop("phi_dev"), streamed["inertia"],
                                     streamed["coords"], dtype=torch.bfloat16)
    bf16 = bf16_serving("slice bf16", params16, batches, dmats, SLICE_KERNELS, ("dense", "bag"))
    del params16
    log_accumulate("slice", launch_ms["bag"], bf16["launch_ms"]["bag"])

    t0 = time.perf_counter()
    metric_vec = twister.metrics_vector(Metric.of_string("powers(1,1,2)"))
    want = host_chain_distances(space, twister, ca.sample_coords, metric_vec, batches[0][1])
    host_err = {path: float(np.abs(blocks[0] - want).max()) for path, blocks in dmats.items()}
    log("slice: first batch vs host float64 chain: max abs %s (bound %g; %.1f s)"
        % (json.dumps(host_err), HOST_CHAIN_ATOL, time.perf_counter() - t0))
    if max(host_err.values()) > HOST_CHAIN_ATOL:
        raise AssertionError(f"distances off the host float64 chain: {host_err}")

    # serving rate: host staging, upload, device step and download, one
    # batch in flight, route picked as kpop-classify's default 'auto' does
    auto = pick_path(batch, width - K + 1, params.n_vocab, d)
    rates = {}
    order = ("bytes", "codes", "codes", "bytes")
    for wire in order:
        t0 = time.perf_counter()
        serve(DeviceStep(params, "auto", wire=wire), batches)
        rates.setdefault(wire, []).append(n_seqs / (time.perf_counter() - t0))
    log("slice: serving seqs/s over %d read sets per pass (route %s; host staging + upload + "
        "device step + download), in the order %s: bytes wire %s, int8 wire %s, on %s"
        % (n_seqs, auto, ", ".join(order), [round(r, 1) for r in rates["bytes"]],
           [round(r, 1) for r in rates["codes"]], card))
    return dict(launches=launches, train_launches=train_launches, accuracy=accuracy,
                host_err=host_err, seqs_per_s=rates, vocab=params.n_vocab, d=d,
                train_s=train_s, train_phases=phases, ca_err=ca_err, table=table,
                genomes=genomes, batches=batches, stream_launches=streamed["launches"],
                stream_rows=streamed["device_stream"]["block_rows"],
                bf16_launches=bf16["launches"])


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
        "kpop-classify-torch -T Classes.5 -t Classes.5 -f test.fasta --dtype bf16 "
        "-o Test_prediction_bf16.5\n"
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
            "twist", ["-i", at("Classes.5"), "-o", at("Classes.5")], GRAM_LAUNCHES)
        sh(serve, "classify and host references")
        launches["twistdb"] = run_default_cli(
            "twistdb", ["-i", "T", at("Classes.5"), "-i", "t", at("Classes.5"),
                        "-s", at("Test.5"), at("Torch.5")],
            ("kpop_pairwise_dist", "kpop_row_digest"))
        launches["countdb"] = run_default_cli(
            "countdb", ["-i", at("Classes.5"), "--distances", "~.", "~.", at("TorchD.5")],
            ("kpop_pairwise_dist",))
        lines = {}
        for name in ("Test_prediction.5", "Test_prediction_bf16.5", "Torch.5", "Host.5"):
            with open(os.path.join(td, name + ".KPopSummary.txt")) as f:
                lines[name] = f.read().splitlines()
        dmats = {
            name: KPopMatrix.of_binary(MatrixType.DMATRIX, os.path.join(td, name)).matrix
            for name in ("TorchD.5", "HostD.5")
        }
    for name, tool in (("Test_prediction.5", "kpop-classify-torch"),
                       ("Test_prediction_bf16.5", "kpop-classify-torch --dtype bf16"),
                       ("Torch.5", "kpop-twistdb-torch -s")):
        if len(lines[name]) != 100:
            raise AssertionError(f"{tool}: {len(lines[name])} summaries, not 100")
        wrong = sum(ln.split("\t")[0].split("-")[1] != ln.split("\t")[5] for ln in lines[name])
        log("cli: %s quick start: %d misclassified of %d" % (tool, wrong, len(lines[name])))
        if wrong:
            raise AssertionError(f"{tool}: {wrong} misclassified")
    worst = 0.0
    for j, (g, w) in enumerate(zip(lines["Test_prediction_bf16.5"], lines["Test_prediction.5"])):
        pg, pw = g.split("\t"), w.split("\t")
        bad = pg[0] != pw[0] or pg[5] != pw[5] or len(pg) != len(pw)
        for i in range(1, len(pg) if not bad else 1):
            if i >= 5 and (i - 5) % 3 == 0:
                continue  # a target name: near-ties may swap below the first
            a, b = float(pg[i]), float(pw[i])
            worst = max(worst, abs(a - b) / max(1.0, abs(b)))
            bad |= not abs(a - b) <= BF16_BOUND * max(1.0, abs(b))
        if bad:
            raise AssertionError(f"--dtype bf16 line {j}: {g[:300]!r}\nf32: {w[:300]!r}")
    log("cli: kpop-classify-torch --dtype bf16 within %.3g x max(1, |x|) of the f32 run (bound %g), "
        "same predicted classes" % (worst, BF16_BOUND))
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

    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu_torch.core.space import Metric
    from kpop_tpu_torch.core.twister import Twister
    from kpop_tpu_torch.ops.encode import encode_reads_host
    from kpop_tpu_torch.ops.pipeline import build_classifier_params, params_around_twister

    t0 = time.perf_counter()
    space, vocab_hex, table, _ = count_corpus(genomes, LARGE_K)
    n_classes = table.shape[1]
    log("large k: phase 4's genomes counted at k=%d: vocabulary %d (%d expected), %d classes "
        "(%.1f s)" % (LARGE_K, len(vocab_hex), LARGE_K_VOCAB, n_classes, time.perf_counter() - t0))
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    # the streamed path, the budget forced: phi on the host (float64, the
    # host chain's twister), then on the card, which must be that fit
    # rounded to f32
    t0 = time.perf_counter()
    fit = streamed_fits(dev, table, col_w, "large k")
    coords, inertia, phi_dev = fit["coords"], fit["inertia"], fit.pop("phi_dev")
    coords64, inertia64, tw64 = coords, inertia, fit["tw64"]
    train_s = fit["device_wall"]
    if not fit["launches"]["kpop_ca_gram"]:
        raise AssertionError("large k: the train path never launched the Gram kernel")
    log("large k: streamed device CA fit of [%d, %d], %.3f s (both fits %.1f s)"
        % (len(vocab_hex), n_classes, train_s, time.perf_counter() - t0))
    # its twister cast to bf16, for the bag route below (before the f32
    # twister is dropped)
    t0 = time.perf_counter()
    params16 = params_around_twister(space, vocab_hex, phi_dev, inertia, coords, dtype=torch.bfloat16)
    log("large k: bf16 parameters around the device twister, %.1f MB (%.1f s)"
        % (params16.twister.nbytes / 1e6, time.perf_counter() - t0))
    # the same parameters as kpop-classify-torch --dtype bf16 builds them,
    # from the host twister (the fit with phi on the host): its rows ordered
    # and cast on the host, so the card holds no f32 copy while they are
    # built, and the bits equal the card's cast of the device twister
    dims = ["Dim%d" % (i + 1) for i in range(tw64.shape[0])]
    twister64 = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, vocab_hex, tw64)),
        KPopMatrix(MatrixType.INERTIA, NamedMatrix(["inertia"], dims, inertia64[None, :])),
    )
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built = build_classifier_params(space, twister64, coords64, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    same = torch.equal(built.twister, params16.twister)
    f32_bytes = params16.twister.numel() * 4
    log("large k: bf16 parameters from the host twister: %.1f MB of device memory at the peak "
        "(an f32 twister %.1f MB), twister equal to the card's cast %s (%.1f s)"
        % (peak / 1e6, f32_bytes / 1e6, same, time.perf_counter() - t0))
    if peak >= f32_bytes or not same:
        raise AssertionError(f"large k: bf16 build_classifier_params took {peak} B of the card "
                             f"(f32 twister {f32_bytes} B), equal to the card's cast {same}")
    del built

    t0 = time.perf_counter()
    params = params_around_twister(space, vocab_hex, phi_dev, inertia, coords)
    del phi_dev
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if params.cuckoo is None:
        raise AssertionError("large k: the cuckoo build failed on the corpus vocabulary")
    log("large k: parameters around the device twister, cuckoo table %s (%.1f MB) and its "
        "probe layout for the kernels (%.1f MB), twister %.1f MB (%.1f s)"
        % (list(params.cuckoo.shape), params.cuckoo.nbytes / 1e6,
           params.cuckoo_probe.nbytes / 1e6, params.twister.nbytes / 1e6,
           time.perf_counter() - t0))
    dmats, launches, accuracy, busy, launch_ms = serve_routes("large k", params, batches,
                                                              LARGE_K_KERNELS)
    codes_twin = twin_serving("large k codes", params, batches, dmats, LARGE_K_CODES_KERNELS,
                              ("dense", "bag"))
    log("large k: device ms a batch by route, bytes wire %s, int8 wire %s"
        % (json.dumps(busy), json.dumps(codes_twin["busy"])))
    log("large k: on %s" % card)
    # phase 8's count: the first batch in the row ranges of 4 ranks
    codes = encode_reads_host(batches[0][1])
    codes = torch.as_tensor(np.pad(codes, ((0, 0), (0, max(0, LARGE_K - codes.shape[1]))),
                                   constant_values=-1), device=dev)
    rows_row = count_rows_check(params, codes, f"phase 7's first batch {list(codes.shape)}, "
                                f"k={LARGE_K}, V={params.n_vocab}, cuckoo", timed=True)
    # the same range on the 2-bit wire
    rows_packed_row = packed_count_row(
        params, codes, params.cuckoo, f"phase 7's first batch {list(codes.shape)}, k={LARGE_K}, "
        f"V={params.n_vocab}, cuckoo", "kpop_tpu/ops/encode.py:213 with "
        "kpop_tpu/parallel/serving.py:113",
        rows_range=(0, -(-params.n_vocab // COUNT_RANGES)))
    del params, codes
    torch.cuda.empty_cache()
    bf16 = bf16_serving("large k bf16", params16, batches, dmats,
                        ("kpop_embedding_bag_wide", "kpop_pairwise_dist", "kpop_encode_bytes"),
                        ("bag",))
    del params16
    log_accumulate("large k", launch_ms["bag"], bf16["launch_ms"]["bag"])

    t0 = time.perf_counter()
    metric_vec = twister64.metrics_vector(Metric.of_string("powers(1,1,2)"))
    want = host_chain_distances(space, twister64, coords64, metric_vec, batches[0][1])
    host_err = {path: float(np.abs(blocks[0] - want).max()) for path, blocks in dmats.items()}
    log("large k: first batch vs host float64 chain: max abs %s (bound %g; %.1f s)"
        % (json.dumps(host_err), HOST_CHAIN_ATOL, time.perf_counter() - t0))
    if max(host_err.values()) > HOST_CHAIN_ATOL:
        raise AssertionError(f"large k: distances off the host float64 chain: {host_err}")
    return dict(launches=launches, accuracy=accuracy, host_err=host_err, busy=busy,
                vocab=len(vocab_hex), train_s=train_s, bf16_launches=bf16["launches"],
                stream_launches=fit["launches"], stream_rows=fit["device_stream"]["block_rows"],
                rows_row=rows_row, table=table, vocab_hex=vocab_hex, sv=fit["sv"], want=want,
                rows_packed_row=rows_packed_row)


# ---------------- phase 8: sharded over ranks ----------------------------


def stage_ms(step, batches) -> dict:
    """A batch of k-mer-sharded serving split into its steps on this rank,
    on the bytes wire as ``step`` serves it: the rank's rows staged as raw
    bytes and uploaded, encoded on the card (``csrc/encode_bytes.cu``),
    count (``csrc/count_spectra.cu`` over the rank's rows), product,
    all-reduce and distances (``csrc/pairwise.cu``); the host clock around
    each, the card synchronized at each mark; the median over ``batches``
    in ms.  Every rank of the layout runs it, in step."""
    import torch

    from kpop_tpu_torch.core.kmers import _DNA_CODE, _PROT_CODE
    from kpop_tpu_torch.ops.encode import ByteRing, encode_bytes
    from kpop_tpu_torch.ops.pipeline import distances_to_classes
    from kpop_tpu_torch.parallel.mesh import all_reduce
    from kpop_tpu_torch.parallel.serving import count_shard, project_shard

    p, mesh = step.params, step.mesh
    ring = ByteRing(pinned=step.device.type != "cpu")
    table = torch.from_numpy(_PROT_CODE if p.base != 4 else _DNA_CODE).to(step.device)
    times: dict = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.setdefault(name, []).append((now - t0) * 1e3)
        return now

    for _truth, seqs in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = len(seqs)
        b0, b1 = mesh.rows(n + (-n) % mesh.dp, "data")
        staged = ring.reserve(seqs, b0, b1)
        ring.fill(staged)
        sent = staged.buffer.to(step.device, non_blocking=True)
        t = mark("stage_upload", t)
        codes = encode_bytes(*staged.split(sent), max(staged.longest, p.k), table)
        t = mark("encode", t)
        spectra, known = count_shard(p, codes)
        t = mark("count", t)
        part = project_shard(p, spectra, known)
        t = mark("product", t)
        all_reduce(part, mesh.kmer_group)
        t = mark("all_reduce", t)
        distances_to_classes(p, part)
        mark("distances", t)
    return {k: float(np.median(v)) for k, v in times.items()}


def sharded_rank(rank: int, world: int, port: int, workdir: str, backend: str) -> int:
    """One rank of phase 8 (``chip_smoke.py --sharded-rank``): phase 7's
    k = 16 table trained rank-sharded over ``world`` ranks on the card
    (``ca_fit_sharded(mesh=...)``), its sv held to phase 7's one-rank fit;
    then phase 4's held-out read sets served k-mer-sharded, through the
    layout choice and the serve step of ``kpop-classify-torch``, with
    ``--kmer-parallel`` and with ``KPOP_PARAMS_HBM_BYTES``, on f32 and bf16
    shards: accuracy, the first batch against the host float64 chain, each
    rank's device memory, the launches of the main path and the rate.
    Writes ``rank<r>.json`` into ``workdir``."""
    import pickle

    import torch

    from kpop_tpu_torch import _build
    from kpop_tpu_torch.cli.classify import DeviceStep, layout_kmer_parallel
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.parallel import distributed
    from kpop_tpu_torch.parallel import sharded
    from kpop_tpu_torch.parallel.mesh import make_mesh
    from kpop_tpu_torch.config import device
    from kpop_tpu_torch.parallel.serving import params_around_sharded_twister, sharded_dmat_fn

    dev = device()  # the card (KPOP_PLATFORM=cpu rehearses the phase on the CPU)
    distributed.initialize(f"tcp://localhost:{port}", world, rank, backend)
    table = np.load(os.path.join(workdir, "table.npy"), mmap_mode="r")
    names = np.load(os.path.join(workdir, "names.npy")).tolist()
    with open(os.path.join(workdir, "batches.pkl"), "rb") as f:
        batches = pickle.load(f)
    want0 = np.load(os.path.join(workdir, "want0.npy"))
    sv7 = np.load(os.path.join(workdir, "sv7.npy"))
    space = KmerSpace("DNA-ds", LARGE_K)
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    out = dict(rank=rank, world=world, backend=backend, card=torch.cuda.get_device_name(0))

    # the train path over the ranks, every count set to 0 just before, read
    # just after
    mesh = make_mesh(world, data_parallel=1)
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    coords, inertia, rows, sv = sharded.ca_fit_sharded(table, col_weights=col_w, phi="device",
                                                        device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_phases"] = dict(sharded.LAST_CA_PHASES)
    out["train_launches"] = dict(_build.LAUNCHES)
    out["train_peak"] = torch.cuda.max_memory_allocated()
    out["train_wire"], out["train_stream"] = sharded.LAST_DD_UPLOAD, sharded.LAST_CA_STREAM
    out["rows"] = list(rows.rows)
    out["sv_rel"] = float(np.abs(sv - sv7).max() / np.abs(sv7).max())
    out["sv"] = sv.tolist()
    if not out["sv_rel"] <= STREAM_SV_RTOL:
        raise AssertionError(f"rank {rank}: sharded sv {out['sv_rel']:.3g} off phase 7's fit")
    if not out["train_launches"]["kpop_ca_gram"] or out["train_launches"]["kpop_ca_gram_finish"] != 1:
        raise AssertionError(f"rank {rank}: the sharded fit's Gram launches "
                             f"{out['train_launches']}")
    V, d = len(names), len(sv)
    truth = np.concatenate([t for t, _ in batches])
    n_seqs = len(truth)
    configs = ([("f32", 1, None)] if world == 1 else
               [("f32", world, None), ("f32", 0, 600_000_000), ("bf16", world, None),
                ("bf16", 0, 600_000_000)])
    out["serving"] = []
    dmats32 = None
    for dtype_name, kp_opt, budget in configs:
        dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
        if budget:
            os.environ["KPOP_PARAMS_HBM_BYTES"] = str(budget)
        kp = layout_kmer_parallel(world, kp_opt, V * d * dtype.itemsize)
        os.environ.pop("KPOP_PARAMS_HBM_BYTES", None)
        mesh = make_mesh(world, data_parallel=world // kp)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, v = params_around_sharded_twister(space, names, rows, inertia, coords, mesh,
                                                  dtype=dtype)
        torch.cuda.synchronize()
        handoff_s = time.perf_counter() - t0
        handoff_peak = torch.cuda.max_memory_allocated() - live
        resident = torch.cuda.memory_allocated() - live
        step = DeviceStep(params, mesh=mesh, dmat=sharded_dmat_fn(mesh, v))
        serve(step, batches[:1])  # warm-up
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # the main path: every count set to 0 just before, read just after
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        blocks = serve(step, batches)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        serve_peak = torch.cuda.max_memory_allocated() - before + resident
        dmat = np.concatenate(blocks)
        if dmat.shape != (n_seqs, params.class_coords.shape[0]) or not np.isfinite(dmat).all():
            raise AssertionError(f"rank {rank}: bad distances {dmat.shape}")
        res = dict(dtype=dtype_name, option=(f"--kmer-parallel {kp_opt}" if kp_opt else
                                             f"KPOP_PARAMS_HBM_BYTES={budget}"),
                   dp=mesh.dp, kp=kp, all_reduce=torch.distributed.get_backend(mesh.kmer_group),
                   accuracy=float((dmat.argmin(axis=1) == truth).mean()), wall_s=wall,
                   seqs_per_s=n_seqs / wall, launches=launches, handoff_s=handoff_s,
                   handoff_peak=handoff_peak, resident=resident, serve_peak=serve_peak,
                   twister_bytes=V * d * dtype.itemsize,
                   shard_bytes=params.twister.shape[0] * params.twister.stride(0) * dtype.itemsize,
                   V_local=params.twister.shape[0], row0=params.row0,
                   batch_rows=-(-len(batches[0][0]) // mesh.dp))
        if res["accuracy"] < ACCURACY_GATE:
            raise AssertionError(f"rank {rank}, {res['option']} {dtype_name}: accuracy "
                                 f"{res['accuracy']} < {ACCURACY_GATE}")
        missing = [n for n in ("kpop_count_spectra_wide", "kpop_pairwise_dist", "kpop_encode_bytes")
                   if not launches[n]]
        if missing or launches["kpop_embedding_bag_wide"]:
            raise AssertionError(f"rank {rank}: the sharded main path's launches {launches}")
        if dtype_name == "f32":
            res["host_err"] = float(np.abs(blocks[0] - want0).max())
            if res["host_err"] > HOST_CHAIN_ATOL:
                raise AssertionError(f"rank {rank}: first batch {res['host_err']} off the host "
                                     "float64 chain")
            dmats32 = dmat
        else:
            res["bf16_err"] = float((np.abs(dmat - dmats32) / np.maximum(1.0, np.abs(dmats32))).max())
            if res["bf16_err"] > BF16_BOUND:
                raise AssertionError(f"rank {rank}: bf16 distances {res['bf16_err']} off f32")
        # each rank holds its shard of the twister's rows, beside the
        # replicated vocabulary and a batch's working set (its [B, V_local]
        # f32 spectrum, the spectrum's bf16 cast, the count's scratch)
        if res["V_local"] != -(-V // kp):
            raise AssertionError(f"rank {rank}: a shard of {res['V_local']} rows")
        tables = sum(t.nbytes for t in (params.cuckoo, params.cuckoo_probe, params.vocab_lut,
                                        params.vocab_limbs) if t is not None)
        res["peak_bound"] = (res["shard_bytes"] + tables
                             + 3 * res["batch_rows"] * res["V_local"] * 4 + (64 << 20))
        if res["serve_peak"] > res["peak_bound"]:
            raise AssertionError(f"rank {rank}: serving took {res['serve_peak']} B of the card, "
                                 f"above its shard, tables and a batch: {res['peak_bound']} B")
        if kp_opt:
            res["stages_ms"] = stage_ms(step, batches)
        out["serving"].append(res)
        del params, step
        torch.cuda.empty_cache()
    out["products"] = sharded_products(world, dev)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def sharded_products(world: int, dev) -> dict:
    """``project_sharded`` (B over data, K over kmer: dp = 2 at four ranks)
    and ``pairwise_sharded`` (the queries over all ranks) on the card, on
    seeded inputs the same on every rank, against numpy float64 within
    tests/test_sharded.py:50's and :68's tolerances."""
    from kpop_tpu_torch.parallel.mesh import make_mesh
    from kpop_tpu_torch.parallel.sharded import pairwise_sharded, project_sharded

    rng = np.random.default_rng(3)
    mesh = make_mesh(world)
    spectra = rng.random((BATCH, 50_000)).astype(np.float32)
    tw = rng.standard_normal((50_000, 64)).astype(np.float32)
    got = project_sharded(mesh, spectra, tw, device=dev)
    s64 = spectra.astype(np.float64)
    want = (s64 / s64.sum(axis=1, keepdims=True)) @ tw.astype(np.float64)
    project_err = float((np.abs(got - want) - 2e-5 * np.abs(want)).max())
    q, t = rng.standard_normal((1_000, 64)), rng.standard_normal((100, 64))
    m = rng.random(64)
    m /= m.sum()
    got = pairwise_sharded(mesh, q, t, m, device=dev)
    qn = q / np.sqrt((q * q * m).sum(axis=1))[:, None]
    tn = t / np.sqrt((t * t * m).sum(axis=1))[:, None]
    want = np.sqrt((((qn[:, None, :] - tn[None, :, :]) ** 2) * m).sum(axis=2))
    pairwise_err = float((np.abs(got - want) - 2e-4 * np.abs(want)).max())
    if project_err > 1e-6 or pairwise_err > 1e-5:
        raise AssertionError(f"sharded products off float64: {project_err}, {pairwise_err}")
    return dict(layout=mesh.shape, project_excess=project_err, pairwise_excess=pairwise_err)


def run_ranks(workdir: str, world: int, backend: str, timeout: float = 600.0) -> list:
    """``world`` processes of :func:`sharded_rank` on the card; each
    rank's log in ``workdir``.  Every process is stopped before it returns;
    a rank that fails fails the phase, with the tail of its log."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w"))
            # the host's cores shared out among the ranks, as torchrun
            # limits each rank's threads
            env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r), str(world),
                 str(port), workdir, backend],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=REPO, env=env))
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"phase 8 rank {r} of {world} ({backend}) failed "
                                 f"({p.returncode}):\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_sharded(lk: dict, batches, card: str) -> dict:
    """Phase 7's k = 16 table trained and served over 4 gloo ranks on the
    one card (NCCL refuses two ranks on one card), then over 1 NCCL rank
    whose all-reduce runs on the card.  The kernels were built by this
    process first; the ranks load the same library.  Returns the launches
    of the main path (every rank's, summed, of the ``--kmer-parallel 4``
    f32 serving) and what the ranks measured."""
    import pickle
    import shutil

    workdir = tempfile.mkdtemp(prefix="kpop_smoke_sharded_")
    try:
        table = lk.pop("table")
        wire = np.uint8 if table.max() < 256 else np.uint16
        np.save(os.path.join(workdir, "table.npy"), table.astype(wire))
        del table
        np.save(os.path.join(workdir, "names.npy"), np.array(lk.pop("vocab_hex")))
        np.save(os.path.join(workdir, "want0.npy"), lk.pop("want"))
        np.save(os.path.join(workdir, "sv7.npy"), lk["sv"])
        with open(os.path.join(workdir, "batches.pkl"), "wb") as f:
            pickle.dump(batches, f)
        result = {}
        for world, backend in ((4, "gloo"), (1, "nccl")):
            t0 = time.perf_counter()
            ranks = run_ranks(workdir, world, backend)
            wall = time.perf_counter() - t0
            r0 = ranks[0]
            log("sharded %s x%d: trained rank-sharded in %.3f s on rank 0 (%s), the %s wire, "
                "rows %s; sv within %.3g of phase 7's fit (bound %g), the same bits on every "
                "rank: %s; peak device memory of the fit by rank %s B; launches on rank 0 %s"
                % (backend, world, r0["train_s"],
                   ", ".join("%s %.4f s" % kv for kv in r0["train_phases"].items()),
                   r0["train_wire"], [r["rows"] for r in ranks], r0["sv_rel"], STREAM_SV_RTOL,
                   all(r["sv"] == r0["sv"] for r in ranks), [r["train_peak"] for r in ranks],
                   json.dumps(r0["train_launches"])))
            if not all(r["sv"] == r0["sv"] for r in ranks):
                raise AssertionError(f"{backend} x{world}: the ranks' sv differ")
            for i, res in enumerate(r0["serving"]):
                peaks = [r["serving"][i]["serve_peak"] for r in ranks]
                log("sharded %s x%d, %s %s: layout dp=%d kp=%d (all-reduce over %s%s); accuracy "
                    "%.4f; %s; %.1f read sets/s on rank 0 (host staging, upload, the step and "
                    "the gather of distances through the host); hand-off %.2f s, peak %d B; "
                    "shard %d B of a %d B twister; serving peak by rank %s B (%.3f of the "
                    "twister's bytes; bound: the shard, the vocabulary tables and a batch, %d "
                    "B); main path launches summed over the ranks %s; on %s"
                    % (backend, world, res["option"], res["dtype"], res["dp"], res["kp"],
                       res["all_reduce"], ", through the host" if res["all_reduce"] == "gloo"
                       else ", on the card", res["accuracy"],
                       ("first batch vs host float64 chain max abs %.3g (bound %g)"
                        % (res["host_err"], HOST_CHAIN_ATOL)) if "host_err" in res else
                       ("off the f32 distances by %.3g x max(1, |x|) (bound %g)"
                        % (res["bf16_err"], BF16_BOUND)),
                       res["seqs_per_s"], res["handoff_s"], res["handoff_peak"],
                       res["shard_bytes"], res["twister_bytes"], peaks,
                       max(peaks) / res["twister_bytes"], res["peak_bound"],
                       json.dumps(summed_launches(r["serving"][i]["launches"] for r in ranks)),
                       card))
                if "stages_ms" in res:
                    log("sharded %s x%d, %s %s: a batch of %d on rank 0, ms by step (median; the "
                        "all-reduce %s): %s"
                        % (backend, world, res["option"], res["dtype"], res["batch_rows"],
                           "gloo through the host" if res["all_reduce"] == "gloo" else "NCCL",
                           json.dumps(res["stages_ms"])))
            log("sharded %s x%d: project_sharded and pairwise_sharded on the card, layout %s, "
                "within tests/test_sharded.py's tolerances of numpy float64 (largest excess "
                "over rtol: %.3g and %.3g)" % (backend, world, r0["products"]["layout"],
                                               r0["products"]["project_excess"],
                                               r0["products"]["pairwise_excess"]))
            log("sharded %s x%d: %.1f s with the ranks' start" % (backend, world, wall))
            result[backend] = ranks
        main = result["gloo"]
        return dict(launches=summed_launches(r["serving"][0]["launches"] for r in main),
                    ranks=result)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def summed_launches(per_rank) -> dict:
    out: dict = {}
    for launches in per_rank:
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


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
        _build.BUILD_SECONDS, " ".join(_build.nvcc_flags())))
    # 3. kernels
    rows = phase_kernels(dev, B=BATCH, L=30208, V=367_987, d=511, C=N_CLASSES, big=4096)
    # 3b. the bag at the benchmark's lineage cell at k = 12
    t0 = time.perf_counter()
    rows["embedding_bag_lineage_k12"], lineage_launches = lineage_bag_row(dev)
    log("lineage bag at k = 12: %.1f s" % (time.perf_counter() - t0))
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
    phase7_batches = sl.pop("batches")
    lk = phase_large_k(dev, sl.pop("genomes"), phase7_batches, card)
    log("large k: %.1f s (device CA fit %.3f s)" % (time.perf_counter() - t0, lk["train_s"]))
    rows["count_spectra_rows"] = lk.pop("rows_row")
    rows["count_spectra_rows_packed"] = lk.pop("rows_packed_row")
    # 8. sharded
    t0 = time.perf_counter()
    sh = phase_sharded(lk, phase7_batches, card)
    log("sharded: %.1f s" % (time.perf_counter() - t0))
    blocked = rows["ca_gram_streamed"]
    ran = (sl["stream_rows"], lk["stream_rows"])
    if ran != (blocked["block_rows"], blocked["wide_block_rows"]):
        raise AssertionError(f"the streamed fits ran blocks of {ran} rows; phase 3 checked the "
                             f"blocked Gram at {blocked['block_rows']} and "
                             f"{blocked['wide_block_rows']}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kpop_tpu"))
    if loaded:
        raise AssertionError("JAX or the JAX package was imported: %s" % loaded[:10])

    launches = {"slice": sl["launches"], "train": sl["train_launches"], **rel["launches"],
                "large_k": lk["launches"], "train_streamed": sl["stream_launches"],
                "slice_bf16": sl["bf16_launches"], "large_k_bf16": lk["bf16_launches"],
                "sharded": sh["launches"], "lineage_k12": lineage_launches}
    def entry_launches(r) -> dict:
        names = (r["launch"],) if isinstance(r["launch"], str) else r["launch"]
        return {n: launches[r["path"]][n] for n in names}

    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=sum(entry_launches(r).values()), max_abs_err=r["err"],
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
             path=r["path"],
             **({"launches_by_entry": entry_launches(r)} if len(entry_launches(r)) > 1 else {}),
             **{k: r[k] for k in ("device_ms", "err_f64", "plain_err_f64", "addmm_ms", "regime",
                                  "alone_ms", "int8_ms", "int8_alone_ms", "sorted_limbs")
                if k in r})
        for name, r in rows.items()
        if r["path"] is not None
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernel rows whose main path never launched them: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                              sys.argv[6]))
    sys.exit(main())
