#!/usr/bin/env python3
"""Smoke run of kpop_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); without a card it exits 2 and
prints no result.  It imports no JAX.  Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` builds ``kpop_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``kpop_tpu_torch/_build/`` (on first use);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with the median time of both;
4. slice: the headline serving workload of ``bench.py`` (k=10, 512 classes
   x 4 tips of a 30 kb genome, seed 0, 1,024 held-out read sets of 150 bp
   pairs at 1x coverage; vocabulary ~368k, d=511), trained with the host
   float64 CA and classified through the dense and the bag route:
   top-1 accuracy >= 0.95 on each, every kernel launched, distances within
   1e-4 of the host float64 chain, and the serving rate;
5. cli: the README quick start through ``bin/kpop-classify-torch``,
   0 misclassified of 100.

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
PAIR_RTOL, PAIR_ATOL = 2e-4, 1e-5  # tests/test_pallas.py:32


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


def phase_kernels(dev, B: int, L: int, V: int, d: int, C: int, big: int):
    import torch

    from kpop_tpu_torch.ops import pairwise as pw
    from kpop_tpu_torch.ops import pipeline as pl

    rng = np.random.default_rng(1)
    params = random_params(rng, dev, V, d, C)
    codes = torch.as_tensor(read_like_codes(rng, B, L), device=dev)
    rows = {}

    got = pl.count_spectra(params, codes)
    want = pl.count_spectra_ref(params, codes)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            "count_spectra differs from its plain version at %d cells"
            % int((got != want).sum())
        )
    if float(got[1].max()) < L - 300 - K:
        raise AssertionError("a repeated k-mer was not counted every time")
    rows["count_spectra"] = dict(
        err=float((got - want).abs().max()),
        ms=time_ms(lambda: pl.count_spectra(params, codes)),
        plain_ms=time_ms(lambda: pl.count_spectra_ref(params, codes), reps=5),
        shape=f"[{B}, {L}] int8 codes, k={K}, V={V}", tol=COUNT_TOL,
        source="kpop_tpu_torch/csrc/count_spectra.cu",
        replaces="kpop_tpu/ops/pipeline.py:179",
        launch="kpop_count_spectra",
    )
    del got, want

    got = pl.project_reads(params, codes)
    want = pl.project_reads_ref(params, codes)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=BAG_RTOL, atol=BAG_ATOL):
        raise AssertionError(
            "embedding bag differs from its plain version: max abs %.3g"
            % float((got - want).abs().max())
        )
    rows["embedding_bag"] = dict(
        err=float((got - want).abs().max()),
        ms=time_ms(lambda: pl.project_reads(params, codes), reps=5),
        plain_ms=time_ms(lambda: pl.project_reads_ref(params, codes), reps=3),
        shape=f"[{B}, {L}] int8 codes, k={K}, twister [{V}, {d}]",
        tol=f"rtol {BAG_RTOL}, atol {BAG_ATOL}",
        source="kpop_tpu_torch/csrc/embedding_bag.cu",
        replaces="kpop_tpu/ops/pipeline.py:200",
        launch="kpop_embedding_bag",
    )

    # the slice's shape: [B, d] twisted reads against [C, d] classes, with
    # the class norms of the parameters, as distances_to_classes calls it
    twisted = got
    m = params.metric
    args = (twisted, params.class_coords, m, pw.row_norms(twisted, m), params.class_norms)
    got = pw.distance_tile(*args)
    want = pw.distance_tile_ref(*args)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
        raise AssertionError(
            "distance tile differs from its plain version: max abs %.3g"
            % float((got - want).abs().max())
        )
    rows["pairwise_dist"] = dict(
        err=float((got - want).abs().max()),
        ms=time_ms(lambda: pw.distance_tile(*args)),
        plain_ms=time_ms(lambda: pw.distance_tile_ref(*args)),
        shape=f"[{B}, {d}] x [{C}, {d}]",
        tol=f"rtol {PAIR_RTOL}, atol {PAIR_ATOL}",
        source="kpop_tpu_torch/csrc/pairwise.cu",
        replaces="kpop_tpu/ops/pallas_pairwise.py:43",
        launch="kpop_pairwise_dist",
    )
    # the relatedness shape the Pallas kernel was tuned at
    a = torch.as_tensor(rng.standard_normal((big, 512), dtype=np.float32), device=dev)
    b = torch.as_tensor(rng.standard_normal((big, 512), dtype=np.float32), device=dev)
    mb = torch.as_tensor(rng.random(512, dtype=np.float32), device=dev)
    got = pw.pairwise_distances(a, b, mb)
    want = pw.pairwise_distances_ref(a, b, mb)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
        raise AssertionError(
            "pairwise distances differ from the plain version at %d^2 x 512: "
            "max abs %.3g" % (big, float((got - want).abs().max()))
        )
    rows["pairwise_dist"]["big"] = dict(
        shape=f"[{big}, 512] x [{big}, 512]",
        err=float((got - want).abs().max()),
        ms=time_ms(lambda: pw.pairwise_distances(a, b, mb)),
        plain_ms=time_ms(lambda: pw.pairwise_distances_ref(a, b, mb)),
    )
    for name, r in rows.items():
        log(
            "kernel %-14s %s: max abs err %.3g (%s); kernel %.4f ms, plain "
            "%.4f ms" % (name, r["shape"], r["err"], r["tol"], r["ms"], r["plain_ms"])
        )
    big_row = rows["pairwise_dist"]["big"]
    log(
        "kernel pairwise_dist  %s: max abs err %.3g; kernel %.4f ms, plain "
        "%.4f ms" % (big_row["shape"], big_row["err"], big_row["ms"], big_row["plain_ms"])
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


def build_corpus(rng, n_classes: int, genome_len: int, tips_per_class=4,
                 between=0.08, within=0.15, rate=0.01):
    """The covid-shaped corpus of bench.py (``_build_corpus``): sibling
    clades of a random tree, the first half of each clade's tips summed as
    the class's training counts, the rest held out.  Returns (space,
    vocabulary hex labels, [K, C] int32 table, held-out (class, codes))."""
    from kpop_tpu.core.count import spectrum_of_sequences
    from kpop_tpu.core.kmers import KmerSpace

    phylo = load_phylo()
    space = KmerSpace("DNA-ds", K)
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


def host_chain_distances(space, twister, coords, metric_vec, seqs):
    """Host float64 golden chain: Twister.project_entries, then
    distance_rowwise against the classes."""
    from kpop_tpu.core.count import spectrum_of_sequences
    from kpop_tpu.core.kmers import hex_labels_vectorized
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import Distance, distance_rowwise

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


def phase_slice(dev, n_classes: int, genome_len: int, batch: int, card: str):
    import torch

    from kpop_tpu.core.ca import fit_ca
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu.core.space import Metric
    from kpop_tpu.core.twister import Twister
    from kpop_tpu_torch import _build
    from kpop_tpu_torch.cli.classify import DeviceStep, pick_path
    from kpop_tpu_torch.ops.pipeline import build_classifier_params

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    space, vocab_hex, table, held_out = build_corpus(rng, n_classes, genome_len)
    log("slice: corpus of %d classes, vocabulary %d, %d held-out tips (%.1f s)"
        % (n_classes, table.shape[0], len(held_out), time.perf_counter() - t0))
    t0 = time.perf_counter()
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    ca = fit_ca(table * col_w[None, :])
    del table
    d = ca.n_dims
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(ca.dim_names, vocab_hex, ca.twister)),
        KPopMatrix(
            MatrixType.INERTIA,
            NamedMatrix(["inertia"], ca.dim_names, ca.inertia[None, :]),
        ),
    )
    log("slice: host float64 CA fit, twister [%d, %d] (%.1f s)"
        % (len(vocab_hex), d, time.perf_counter() - t0))
    t0 = time.perf_counter()
    params = build_classifier_params(space, twister, ca.sample_coords, device=dev)
    torch.cuda.synchronize()
    log("slice: classifier parameters on %s, twister %.1f MB (%.1f s)"
        % (dev, params.twister.numel() * 4 / 1e6, time.perf_counter() - t0))
    batches = read_set_batches(rng, held_out, batch)
    n_seqs = sum(len(t) for t, _ in batches)
    truth = np.concatenate([t for t, _ in batches])
    width = max(len(s) for _, seqs in batches for s in seqs)

    # the main path: every count set to 0 just before, read just after
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    dmats = {path: serve(DeviceStep(params, path), batches) for path in ("dense", "bag")}
    launches = dict(_build.LAUNCHES)
    log("slice: kernel launches on the main path: %s" % json.dumps(launches))
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError("kernels never launched on the main path: %s" % missing)

    accuracy = {}
    for path, blocks in dmats.items():
        dmat = np.concatenate(blocks)
        if dmat.shape != (n_seqs, n_classes) or not np.isfinite(dmat).all():
            raise AssertionError(f"{path}: bad distances {dmat.shape}")
        accuracy[path] = float((dmat.argmin(axis=1) == truth).mean())
        log("slice: %s route top-1 accuracy %.4f over %d read sets"
            % (path, accuracy[path], n_seqs))
        if accuracy[path] < ACCURACY_GATE:
            raise AssertionError(f"{path}: accuracy {accuracy[path]} < {ACCURACY_GATE}")

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
    return dict(launches=launches, accuracy=accuracy, host_err=host_err,
                seqs_per_s=rates, vocab=params.n_vocab, d=d)


# ---------------- phase 5: the quick start through the CLI ---------------


def phase_cli() -> int:
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = REPO
    env.pop("KPOP_PLATFORM", None)  # the port's default: the card
    script = (
        "set -eo pipefail\n"
        f"{sys.executable} {REPO}/tests/data/make_clusters.py clusters-small.fasta\n"
        "for CLASS in C1 C2 C3 C4 C5 C6 C7 C8 C9 C10; do cat clusters-small.fasta |\n"
        "  awk -v CLASS=$CLASS '{nr=(NR-1)%4; ok=(nr==0?$0~(\"-\"CLASS\"$\"):nr==1&&ok); if (ok) print}' |\n"
        "  kpop-count -k 5 -L -f /dev/stdin |\n"
        "  kpop-countdb -k /dev/stdin -R '~.' -A $CLASS -L $CLASS -N -D -t /dev/stdout\n"
        "done | kpop-countdb -k /dev/stdin -o Classes.5\n"
        "kpop-twist -i Classes.5 -o Classes.5\n"
        "cat clusters-small.fasta |\n"
        "  awk '{nr=(NR-1)%4; if (nr==2) split($0,s,\"[>-]\"); if (nr==3) print \">\"s[2]\"-\"s[3]\"\\n\"$0}' > test.fasta\n"
        "kpop-classify-torch -T Classes.5 -t Classes.5 -f test.fasta -o Test_prediction.5\n"
    )
    with tempfile.TemporaryDirectory() as td:
        res = subprocess.run(["bash", "-c", script], cwd=td, env=env,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError("quick start failed:\n" + res.stderr[-4000:])
        with open(os.path.join(td, "Test_prediction.5.KPopSummary.txt")) as f:
            lines = f.read().splitlines()
    if len(lines) != 100:
        raise AssertionError(f"quick start: {len(lines)} summaries, not 100")
    wrong = sum(ln.split("\t")[0].split("-")[1] != ln.split("\t")[5] for ln in lines)
    log("cli: kpop-classify-torch quick start: %d misclassified of %d" % (wrong, len(lines)))
    if wrong:
        raise AssertionError(f"quick start: {wrong} misclassified")
    return wrong


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
    log("slice: %.1f s" % (time.perf_counter() - t0))
    # 5. cli
    phase_cli()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=sl["launches"][r["launch"]], max_abs_err=r["err"],
             ms=r["ms"], plain_ms=r["plain_ms"])
        for name, r in rows.items()
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
