"""K-mer-sharded serving of the port (kpop_tpu_torch/parallel/serving.py)
and its sharded products (parallel/sharded.py), against the JAX package on
the suite's 8-device CPU mesh (tests/conftest.py).

The port's ranks are gloo processes on the CPU; the worker is this file run
as a script, importing nothing of JAX: it reads the inputs that the parent
wrote, serves them k-mer-sharded over ``kp`` ranks (dp = 1) and writes the
distances, with ``project_sharded`` and ``pairwise_sharded`` over the
default layout.  The parent holds them to

- ``kpop_tpu.parallel.serving.sharded_dmat_fn`` at data=2, kmer=4, within
  tests/test_serving_sharded.py:98's rtol=1e-5, atol=1e-6, at k = 5 (the
  dense LUT) and k = 18 (the cuckoo hash), f32 and bf16, for kp = 2 and 4;
- ``project_sharded`` and ``pairwise_sharded`` of the JAX package at
  tests/test_sharded.py:50's and :68's tolerances.

Also here: the count's row range against the whole count, the layout
choice of ``choose_kmer_parallel`` on tests/test_serving_sharded.py:105-112's
table, and ``kpop-classify-torch`` on two gloo ranks against one."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_classify_cli import BIN, REPO, sh, summaries, trained  # noqa: F401
from test_torch_distributed import run_job

SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6  # tests/test_serving_sharded.py:98
PROJECT_RTOL, PROJECT_ATOL = 2e-5, 1e-6  # tests/test_sharded.py:50
PAIRWISE_RTOL, PAIRWISE_ATOL = 2e-4, 1e-5  # tests/test_sharded.py:68
CASES = [(5, "f32"), (5, "bf16"), (18, "f32"), (18, "bf16")]
PARAM_ARRAYS = ("vocab_lut", "twister", "metric", "class_coords", "class_norms",
                "vocab_hi", "vocab_lo", "cuckoo")


# ---------------- the worker (no JAX) ----------------


def _load_params(path: str):
    """ClassifierParams on the CPU from the arrays the parent wrote (a bf16
    twister as its 16 bits)."""
    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    z = np.load(path)
    arrays = {n: torch.from_numpy(z[n]) if n in z else None for n in PARAM_ARRAYS
              if n != "twister"}
    tw = torch.from_numpy(z["twister"])
    if z["bf16"]:
        tw = tw.view(torch.bfloat16)
    return ClassifierParams(twister=tw, **arrays, k=int(z["k"]), canonical=True,
                            cuckoo_seeds=tuple(int(s) for s in z["seeds"]))


def worker(rank: int, world: int, port: int, workdir: str) -> int:
    os.environ["KPOP_PLATFORM"] = "cpu"
    sys.path.insert(0, REPO)
    from kpop_tpu_torch.parallel import distributed
    from kpop_tpu_torch.parallel.mesh import make_mesh
    from kpop_tpu_torch.parallel.serving import shard_classifier_params, sharded_dmat_fn
    from kpop_tpu_torch.parallel.sharded import pairwise_sharded, project_sharded

    distributed.initialize(address=f"tcp://localhost:{port}", world_size=world, rank=rank,
                           backend="gloo")
    mesh = make_mesh(data_parallel=1)
    out = {}
    for k, dtype in CASES:
        params, V = shard_classifier_params(_load_params(f"{workdir}/params_{k}_{dtype}.npz"),
                                            mesh)
        codes = torch.from_numpy(np.load(f"{workdir}/codes_{k}.npy"))
        out[f"dmat_{k}_{dtype}"] = sharded_dmat_fn(mesh, V)(params, codes).numpy()
    z = np.load(f"{workdir}/products.npz")
    default = make_mesh()
    out["project"] = project_sharded(default, z["spectra"], z["twister_t"], device="cpu")
    out["pairwise"] = pairwise_sharded(default, z["queries"], z["targets"], z["metric"],
                                       device="cpu")
    assert "jax" not in sys.modules and "kpop_tpu" not in sys.modules
    np.savez(f"{workdir}/out{rank}.npz", **out)
    distributed.shutdown()
    return 0


# ---------------- the parent (pytest) ----------------


def _random_seqs(rng, n, L):
    return ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(n)]


def _train_db(rng, space, n_classes=6, seqs_per_class=3, L=200):
    """tests/test_serving_sharded.py's training database, and its
    sequences."""
    from kpop_tpu.core.count import spectrum_of_sequences
    from kpop_tpu.core.counter_db import CounterDB

    db, train = CounterDB(), []
    for c in range(n_classes):
        seqs = _random_seqs(rng, seqs_per_class, L)
        train.extend(seqs)
        codes, counts = spectrum_of_sequences(space, seqs)
        db.add_spectra_stream(io.StringIO("\tC%d\n" % c + "".join(
            "%s\t%d\n" % (space.code_to_hex(int(cd)), ct) for cd, ct in zip(codes, counts))))
    return db, train


def _queries(rng, train, n=5, L=150):
    """Read sets that hit the vocabulary at any k: halves of two training
    sequences of different classes, with a base in 15 changed.  (A read
    set of one class's sequence lies at a distance near 0 from it, where
    the f32 expansion |a|^2 + |b|^2 - 2 a.b under the square root leaves
    both packages about sqrt(2^-23) of rounding, apart by as much.)"""
    out = []
    for i in range(n):
        a, b = train[(7 * i) % len(train)], train[(7 * i + 4) % len(train)]
        s = np.array(list(a[: L // 2] + b[L // 2 : L]))
        at = rng.choice(L, size=L // 15, replace=False)
        s[at] = rng.choice(list("ACGT"), size=len(at))
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The JAX package's sharded distances on (data=2, kmer=4) for each
    case, with the parameters and the codes written for the workers, and
    the JAX sharded products on the inputs written for them."""
    from kpop_tpu.config import jax_setup

    jax_setup()
    import jax.numpy as jnp

    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.core.twister import twist_counter_db
    from kpop_tpu.ops.encode import encode_reads_host
    from kpop_tpu.ops.pipeline import build_classifier_params
    from kpop_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from kpop_tpu.parallel.serving import shard_classifier_params, sharded_dmat_fn
    from kpop_tpu.parallel.sharded import pairwise_sharded, project_sharded

    td = tmp_path_factory.mktemp("serving_sharded")
    mesh = make_mesh(8, data_parallel=2)
    want = {}
    for k in (5, 18):
        rng = np.random.default_rng(7 + k)
        space = KmerSpace("DNA-ds", k)
        db, train = _train_db(rng, space)
        twister, twisted, _ = twist_counter_db(db)
        seqs = _queries(rng, train)
        batch = encode_reads_host(seqs)
        batch = np.concatenate([batch, np.full((1, batch.shape[1]), -1, np.int8)])  # empty
        np.save(td / f"codes_{k}.npy", batch)
        for dtype in ("f32", "bf16"):
            params = build_classifier_params(
                space, twister, np.asarray(twisted.matrix.data),
                dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
            arrays = {n: np.asarray(getattr(params, n)) for n in PARAM_ARRAYS
                      if getattr(params, n) is not None}
            if dtype == "bf16":
                arrays["twister"] = arrays["twister"].view(np.uint16)
            np.savez(td / f"params_{k}_{dtype}.npz", **arrays, k=k, bf16=dtype == "bf16",
                     seeds=np.asarray(params.cuckoo_seeds or (), dtype=np.int64))
            sharded, v = shard_classifier_params(params, mesh)
            pad = (-batch.shape[0]) % mesh.shape[DATA_AXIS]
            bpad = np.concatenate([batch, np.full((pad, batch.shape[1]), -1, np.int8)])
            want[f"dmat_{k}_{dtype}"] = np.asarray(
                sharded_dmat_fn(mesh, v)(sharded, jnp.asarray(bpad)))[: batch.shape[0]]
    rng = np.random.default_rng(1)
    spectra = rng.random((13, 50)).astype(np.float32)
    tw = rng.standard_normal((50, 6)).astype(np.float32)
    queries, targets = rng.standard_normal((21, 9)), rng.standard_normal((5, 9))
    metric = rng.random(9)
    metric /= metric.sum()
    np.savez(td / "products.npz", spectra=spectra, twister_t=tw, queries=queries,
             targets=targets, metric=metric)
    full = make_mesh(8)
    want["project"] = np.asarray(project_sharded(full, spectra, tw))
    want["pairwise"] = np.asarray(pairwise_sharded(full, queries, targets, metric))
    return td, want


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_serving_matches_jax(jax_served, world):
    td, want = jax_served
    for f in td.glob("out*.npz"):
        f.unlink()
    run_job(str(td), world, script=__file__)
    outs = [dict(np.load(td / f"out{r}.npz")) for r in range(world)]
    for k, dtype in CASES:
        key = f"dmat_{k}_{dtype}"
        for o in outs:  # every rank of the kmer group holds the batch's distances
            np.testing.assert_allclose(o[key], want[key], rtol=SERVE_RTOL, atol=SERVE_ATOL,
                                       err_msg=f"{key}, kp={world}")
        assert np.isfinite(outs[0][key][-1]).all()  # the read set of no known window
    for o in outs:
        np.testing.assert_allclose(o["project"], want["project"], rtol=PROJECT_RTOL,
                                   atol=PROJECT_ATOL)
        np.testing.assert_allclose(o["pairwise"], want["pairwise"], rtol=PAIRWISE_RTOL,
                                   atol=PAIRWISE_ATOL)


@pytest.mark.parametrize("k", [5, 18])
def test_count_row_range_is_columns_of_the_whole(jax_served, k):
    """count_spectra_ref with a row range equals those columns of the whole
    count; every range returns the read set's known windows, all of them."""
    from kpop_tpu_torch.ops import pipeline as tp
    from kpop_tpu_torch.parallel.mesh import split_rows

    td, _ = jax_served
    params = _load_params(str(td / f"params_{k}_f32.npz"))
    codes = torch.from_numpy(np.load(td / f"codes_{k}.npy"))
    whole = tp.count_spectra_ref(params, codes)
    V = params.n_vocab
    assert whole.sum() > 0
    for kp in (2, 3, 4):
        parts = []
        for j in range(kp):
            lo, hi = split_rows(V, kp, j)
            V_local = -(-V // kp)
            got, known = tp.count_spectra(params, codes, row0=j * V_local, rows=V_local,
                                          known=True)
            assert got.shape == (codes.shape[0], V_local)
            assert torch.equal(got[:, : hi - lo], whole[:, lo:hi])
            assert not got[:, hi - lo:].any()  # the zero-padded rows past V
            assert torch.equal(known, whole.sum(dim=1).to(torch.int32))
            parts.append(got[:, : hi - lo])
        assert torch.equal(torch.cat(parts, dim=1), whole)


def test_one_device_ops_refuse_a_shard(jax_served):
    """A rank's shard (twister rows from row0 of the whole vocabulary) is
    projected only by parallel/serving.py: the one-device projections and
    the serve step raise on it, and still serve the whole parameters."""
    from kpop_tpu_torch.cli.classify import dmat_step
    from kpop_tpu_torch.ops import pipeline as tp
    from kpop_tpu_torch.parallel.mesh import Layout
    from kpop_tpu_torch.parallel.serving import shard_classifier_params

    td, _ = jax_served
    whole = _load_params(str(td / "params_5_f32.npz"))
    codes = torch.from_numpy(np.load(td / "codes_5.npy"))
    for r in range(2):
        shard, _V = shard_classifier_params(whole, Layout(dp=1, kp=2, rank=r), "cpu")
        spectra = tp.count_spectra(shard, codes, row0=shard.row0, rows=shard.twister.shape[0])
        for call in (lambda: tp.project(shard, spectra),
                     lambda: tp.project_reads(shard, codes),
                     lambda: tp.project_reads_ref(shard, codes),
                     lambda: dmat_step(shard, codes, "dense"),
                     lambda: dmat_step(shard, codes, "bag")):
            with pytest.raises(ValueError, match="a shard of k-mer-sharded serving"):
                call()
    for path in ("dense", "bag"):
        assert dmat_step(whole, codes, path).shape == (codes.shape[0], whole.class_coords.shape[0])


def test_choose_kmer_parallel():
    """tests/test_serving_sharded.py:105-112's table."""
    from kpop_tpu_torch.parallel.serving import choose_kmer_parallel

    GB = 1 << 30
    assert choose_kmer_parallel(1 * GB, 8, 8 * GB) == 1
    assert choose_kmer_parallel(9 * GB, 8, 8 * GB) == 2
    assert choose_kmer_parallel(30 * GB, 8, 8 * GB) == 4
    assert choose_kmer_parallel(100 * GB, 8, 8 * GB) == 8
    assert choose_kmer_parallel(1000 * GB, 8, 8 * GB) == 8


def test_make_mesh_places_ranks_as_the_jax_mesh():
    """Rank r sits at (r // kp, r % kp), as jax's reshape(dp, n // dp)
    places device r, and the ranks' rows tile each axis."""
    from kpop_tpu_torch.parallel.mesh import Layout, split_rows

    for dp, kp in ((1, 4), (2, 2), (4, 2)):
        spots = [(Layout(dp=dp, kp=kp, rank=r).data_index, Layout(dp=dp, kp=kp, rank=r).kmer_index)
                 for r in range(dp * kp)]
        assert spots == [tuple(x) for x in np.indices((dp, kp)).reshape(2, -1).T]
        for n in (0, 1, 7, 101):
            for over, parts, index in (("all", dp * kp, lambda r: r),
                                       ("kmer", kp, lambda r: r % kp),
                                       ("data", dp, lambda r: r // kp)):
                for r in range(dp * kp):
                    assert Layout(dp=dp, kp=kp, rank=r).rows(n, over) == split_rows(n, parts,
                                                                                    index(r))
                tiles = [split_rows(n, parts, i) for i in range(parts)]
                assert tiles[0][0] == 0 and tiles[-1][1] == n
                assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))


# ---------------- kpop-classify-torch on two ranks ----------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(args: str, world: int, cwd, env_extra=None, tool="kpop-classify-torch") -> list:
    """``tool args`` as ``world`` gloo ranks on the CPU, in the environment
    torchrun gives each rank; ``cwd`` is one directory, or one a rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, KPOP_PLATFORM="cpu", LOCAL_WORLD_SIZE=str(world),
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(BIN, tool), *args.split()],
            cwd=str(cwd[r] if isinstance(cwd, list) else cwd), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _assert_close_lines(got, ref):
    assert len(got) == len(ref) == 100
    for lg, lr in zip(got, ref):
        pg, pr = lg.split("\t"), lr.split("\t")
        assert pg[0] == pr[0] and pg[5] == pr[5], (pg[:6], pr[:6])
        for a, b in zip(pg[1:5], pr[1:5]):  # tests/test_serving_sharded.py:132
            assert abs(float(a) - float(b)) < 1e-4 * max(1.0, abs(float(b)))


@pytest.mark.parametrize("layout", ["kmer_parallel_2", "budget", "data_parallel"])
def test_classify_on_two_ranks_matches_one(trained, layout):
    """kpop-classify-torch on two gloo ranks, k-mer-sharded by
    ``--kmer-parallel 2`` and by a KPOP_PARAMS_HBM_BYTES below the
    twister's bytes, and data-parallel with ``--kmer-parallel 1``: rank 0
    alone writes the summaries, within 1e-4 of the one-rank run's."""
    args = "-T Classes -t Classes -f test_seqs.fasta --batch 31 -v"
    out = f"Two_{layout}"
    if not (trained / "One.KPopSummary.txt").exists():
        sh(f"kpop-classify-torch {args} -o One", trained)
    option, env, kp = {"kmer_parallel_2": ("--kmer-parallel 2", None, 2),
                       "budget": ("", {"KPOP_PARAMS_HBM_BYTES": "1024"}, 2),
                       "data_parallel": ("--kmer-parallel 1", None, 1)}[layout]
    res = _ranks(f"{args} {option} -o {out}_rank$R".replace("$R", "0"), 2, trained, env)
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    assert f"(kmer-parallel {kp})" in res[0][2]
    assert "has no effect" not in res[0][2]
    assert not (trained / f"{out}_rank1.KPopSummary.txt").exists()
    _assert_close_lines(summaries(trained / f"{out}_rank0.KPopSummary.txt"),
                        summaries(trained / "One.KPopSummary.txt"))


def test_classify_kmer_parallel_must_divide_the_ranks(trained, monkeypatch):
    """``--kmer-parallel 3`` on two ranks: a ParseError (a SystemExit whose
    message the tool prints), on every rank, before any output."""
    from kpop_tpu_torch.cli import classify as cli
    from kpop_tpu_torch.utils.cli import ParseError

    res = _ranks("-T Classes -t Classes -f test_seqs.fasta --kmer-parallel 3 -o Bad", 2, trained)
    for rc, _, err in res:
        assert rc == 1 and "--kmer-parallel 3 does not divide the rank count 2" in err
    assert not (trained / "Bad.KPopSummary.txt").exists()
    with pytest.raises(ParseError, match="does not divide the rank count 2"):
        cli.layout_kmer_parallel(2, 3, 1 << 30)
    monkeypatch.setenv("KPOP_PARAMS_HBM_BYTES", "600000000")
    assert cli.layout_kmer_parallel(4, 0, 2_068_384_920) == 4  # chip_smoke.py phase 8's
    assert cli.layout_kmer_parallel(4, 0, 1_034_192_460) == 2


def test_twist_on_two_ranks_matches_one(trained, tmp_path):
    """kpop-twist-torch on two gloo ranks fits the CA over them (each rank
    its rows' Gram, the float64 Grams summed in rank order): rank 0 alone
    writes, within tests/test_dd.py:81-84's bounds of the one-rank fit.
    Each rank runs in its own directory, so a write by rank 1 would show."""
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType
    from kpop_tpu_torch.core.twister import Twister

    db = trained / "Classes"
    sh(f"kpop-twist-torch -i {db} -o {tmp_path}/One", trained)
    dirs = [tmp_path / "rank0", tmp_path / "rank1"]
    for d in dirs:
        d.mkdir()
    res = _ranks(f"-i {db} -o Two", 2, dirs, tool="kpop-twist-torch")
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    assert sorted(os.listdir(dirs[0])) == ["Two.KPopTwisted", "Two.KPopTwister"]
    assert os.listdir(dirs[1]) == []
    one, two = Twister.of_binary(str(tmp_path / "One")), Twister.of_binary(str(dirs[0] / "Two"))
    assert two.kmer_names == one.kmer_names and two.dim_names == one.dim_names
    np.testing.assert_allclose(two.inertia.matrix.data, one.inertia.matrix.data, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(two.twister.matrix.data, one.twister.matrix.data, rtol=0,
                               atol=1e-5)
    coords = [KPopMatrix.of_binary(MatrixType.TWISTED, str(p)).matrix.data
              for p in (tmp_path / "One", dirs[0] / "Two")]
    np.testing.assert_allclose(coords[1], coords[0], rtol=0, atol=1e-6)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
