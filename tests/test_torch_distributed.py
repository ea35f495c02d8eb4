"""The port's parallel/ over torch.distributed, in 2 and 4 gloo processes on
the CPU: the counterpart of tests/test_distributed.py.

The worker is this file run as a script (``python test_torch_distributed.py
<rank> <world> <port> <workdir>``); it imports nothing of JAX and checks,
inside each rank:

1. input: ``shard_files_for_process`` splits the files round-robin, each
   rank encodes its own, and ``global_batch`` places its rows at their
   global offset; the gathered batch equals a host pass over all files;
2. the rank-sharded CA (``ca_fit_sharded`` over the layout; resident, and
   streamed on each rank by a small budget) within tests/test_dd.py:81-84's
   bounds of ``fit_ca`` (sv and inertia 1e-8, coords 1e-6, twister 1e-5),
   and ``precision="fast"`` over the ranks within tests/test_ca_streamed.py's
   bounds; the parent holds every rank's outputs to be bit-identical;
3. ``save_sharded`` and ``load_sharded``: this job's rows, a replicated
   array, a load onto another layout (the kmer axis of dp = 2, kp = 2 at
   four ranks) and a checkpoint that the JAX ``save_sharded`` wrote; the
   parent loads the port's checkpoint with the JAX ``load_sharded``;
4. k-mer-sharded serving within 1e-4 of the host float64 chain, from
   parameters sharded by ``shard_classifier_params`` and from a rank-sharded
   CA twister re-laid by ``params_around_sharded_twister``, at k = 5 (the
   dense LUT) and k = 18 (the cuckoo hash, rows in sorted-code order);
5. at four ranks the same with dp = 2, kp = 2, where the CA's row split
   (over all four ranks) and serving's (over the kmer axis) differ.

Each process has its own timeout."""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PROC_TIMEOUT = 120
CA_BOUNDS = dict(sv=1e-8, inertia=1e-8, coords=1e-6, twister=1e-5)  # tests/test_dd.py:81-84
HOST_CHAIN_ATOL = 1e-4
CKPT_ROWS = 16


# ---------------- the worker (no JAX) ----------------


def _ca_errors(fit, want) -> dict:
    coords, inertia, tw, sv = fit
    return dict(sv=float(np.abs(sv - want.sv).max()),
                inertia=float(np.abs(inertia - want.inertia).max()),
                coords=float(np.abs(coords - want.sample_coords).max()),
                twister=float(np.abs(tw - want.twister).max()))


def _reads(rng, n, L, vocab_seqs=()):
    """Random reads, some built from the vocabulary's own k-mers so that
    they hit it, one of them empty of valid windows."""
    seqs = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(n)]
    for i, s in enumerate(vocab_seqs[: n // 2]):
        seqs[i] = s + seqs[i][len(s):]
    seqs[-1] = "N" * L
    return seqs


def _host_chain(space, twister64, inertia, coords, seqs):
    """Host float64: each read's spectrum through Twister.project_entries,
    then distance_rowwise to the classes (the port's own host copies)."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.kmers import hex_labels_vectorized
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu_torch.core.space import Distance, Metric, distance_rowwise
    from kpop_tpu_torch.core.twister import Twister

    kmer_names, tw = twister64
    dims = ["Dim%d" % (i + 1) for i in range(tw.shape[0])]
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, kmer_names, tw)),
        KPopMatrix(MatrixType.INERTIA, NamedMatrix(["inertia"], dims, inertia[None, :])),
    )
    entries = []
    for s in seqs:
        codes, counts = spectrum_of_sequences(space, [s])
        labels = hex_labels_vectorized(codes, space.hex_width)
        entries.append(list(zip(labels, counts.astype(np.float64))))
    projected = twister.project_entries(entries)
    metric = twister.metrics_vector(Metric.of_string("powers(1,1,2)"))
    tmat = NamedMatrix(["c%d" % i for i in range(len(coords))], dims, coords)
    qmat = NamedMatrix(["q%d" % i for i in range(len(seqs))], dims, projected)
    return distance_rowwise(Distance.of_string("euclidean"), metric, tmat, qmat).data


def _serve(mesh, params, v_global, seqs):
    """The sharded step of kpop-classify-torch: pad the batch to the data
    axis, serve this data group's rows, gather every group's rows."""
    import torch

    from kpop_tpu_torch.ops.encode import encode_reads_host
    from kpop_tpu_torch.parallel.mesh import all_gather_rows
    from kpop_tpu_torch.parallel.serving import sharded_dmat_fn

    codes = encode_reads_host(seqs)
    n = codes.shape[0]
    codes = np.pad(codes, ((0, (-n) % mesh.dp), (0, 0)), constant_values=-1)
    b0, b1 = mesh.rows(codes.shape[0], "data")
    dmat = sharded_dmat_fn(mesh, v_global)(params, torch.from_numpy(codes[b0:b1].copy()))
    return torch.cat(all_gather_rows(dmat, mesh.data_host)).numpy()[:n].astype(np.float64)


def _trained_case(rng, k: int, V: int, C: int, seqs_hint: int = 40):
    """A count table [V, C] over V k-mers of the DNA-ds space (k-mers of a
    few random genomes, so that reads drawn from them hit it)."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.kmers import KmerSpace

    space = KmerSpace("DNA-ds", k)
    genomes = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(C)]
    codes, _ = spectrum_of_sequences(space, genomes)
    codes = rng.permutation(codes)[:V]
    table = rng.integers(0, 20, size=(len(codes), C)).astype(np.float64)
    table[:, 0] += 1.0
    names = [space.code_to_hex(int(c)) for c in codes]
    reads = [g[i: i + 120] for g in genomes for i in (0, 200)][:seqs_hint]
    return space, names, table, reads


def _serve_trained(out, tag, mesh, space, names, table, seqs):
    """A rank-sharded CA fit served k-mer-sharded, through
    params_around_sharded_twister, against the host float64 chain and the
    one-rank serving of the gathered twister."""
    import torch

    from kpop_tpu_torch.ops.pipeline import (
        count_spectra, distances_to_classes, params_around_twister, project,
    )
    from kpop_tpu_torch.ops.encode import encode_reads_host
    from kpop_tpu_torch.parallel.serving import params_around_sharded_twister
    from kpop_tpu_torch.parallel.sharded import ca_fit_sharded

    coords, inertia, rows, sv = ca_fit_sharded(table, phi="device", mesh=mesh, device="cpu")
    assert rows.rows == mesh.rows(len(names)), (rows.rows, mesh.rows(len(names)))
    _, _, tw64, _ = ca_fit_sharded(table, mesh=mesh, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        params, v = params_around_sharded_twister(space, names, rows, inertia, coords, mesh,
                                                  dtype=dtype)
        V_local = -(-len(names) // mesh.kp)
        assert v == len(names) and params.twister.shape[0] == V_local
        assert params.row0 == mesh.kmer_index * V_local and params.twister.dtype == dtype
        got = _serve(mesh, params, v, seqs)
        full = torch.from_numpy(np.ascontiguousarray(tw64.T)).float()
        one = params_around_twister(space, names, full, inertia, coords, dtype=dtype)
        codes = torch.from_numpy(encode_reads_host(seqs))
        want = distances_to_classes(one, project(one, count_spectra(one, codes))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{tag} {dtype}")
        out[f"{tag}_{str(dtype)[6:]}"] = got
    host = _host_chain(space, (names, tw64), inertia, coords, seqs)
    np.testing.assert_allclose(out[f"{tag}_float32"], host, rtol=0, atol=HOST_CHAIN_ATOL)


def worker(rank: int, world: int, port: int, workdir: str) -> int:
    os.environ["KPOP_PLATFORM"] = "cpu"
    sys.path.insert(0, REPO)
    import torch

    from kpop_tpu_torch.core.ca import fit_ca
    from kpop_tpu_torch.parallel import distributed
    from kpop_tpu_torch.parallel.checkpoint import load_sharded, save_sharded
    from kpop_tpu_torch.parallel.input import (
        encode_fasta_batches, global_batch, shard_files_for_process,
    )
    from kpop_tpu_torch.parallel.mesh import ShardedRows, make_mesh
    from kpop_tpu_torch.parallel.serving import shard_classifier_params
    from kpop_tpu_torch.parallel import sharded
    from kpop_tpu_torch.parallel.sharded import ca_fit_sharded

    assert distributed.initialize(address=f"tcp://localhost:{port}", world_size=world, rank=rank,
                                  backend="gloo")
    assert distributed.world_size() == world and distributed.rank() == rank
    assert distributed.is_primary() == (rank == 0)
    mesh = make_mesh()
    assert (mesh.dp, mesh.kp) == (2, world // 2)  # the JAX make_mesh split
    mesh = make_mesh(data_parallel=1)
    assert (mesh.world, mesh.rank, mesh.kmer_index) == (world, rank, rank)
    out = {}

    # 1. input shards, then the global batch
    files = [os.path.join(workdir, f"in{i}.fasta") for i in range(4)]
    mine = shard_files_for_process(files)
    assert mine == files[rank::world], mine
    local = 16 // world
    batches = list(encode_fasta_batches(mine, batch=local, max_len=16))
    assert len(batches) == 1 and batches[0][0].shape == (local, 16)
    gb = global_batch(mesh, batches[0][0])
    assert (gb.row0, gb.total) == (rank * local, 16)
    # the ranks' batches stacked in rank order: each rank's files in turn
    whole = gb.gather(mesh.world_host).numpy()
    stacked = np.concatenate([c for r in range(world) for c, _ in
                              encode_fasta_batches(files[r::world], batch=local, max_len=16)])
    np.testing.assert_array_equal(whole, stacked)

    # 2. the rank-sharded CA: the f64 wire and the u8 wire, resident and
    # streamed on each rank
    rng = np.random.default_rng(42)  # the same tables on every rank
    for name, table in (("f64", rng.random((101, 7)) * 10.0),
                        ("u8", rng.integers(0, 30, size=(3001, 7)).astype(np.float64))):
        want = fit_ca(table)
        for phi in ("host", "device"):
            fit = list(ca_fit_sharded(table, phi=phi, mesh=mesh, device="cpu"))
            assert sharded.LAST_DD_UPLOAD == name and sharded.LAST_CA_STREAM is None
            if phi == "device":
                assert isinstance(fit[2], ShardedRows) and fit[2].rows == mesh.rows(len(table))
                fit[2] = fit[2].gather(mesh.world_host).numpy().astype(np.float64).T
            err = _ca_errors(fit, want)
            assert all(err[kk] <= CA_BOUNDS[kk] for kk in err), (name, phi, err)
            for i, a in enumerate(fit):
                out[f"ca_{name}_{phi}_{i}"] = np.asarray(a)
        if name == "f64":
            continue
        # the u8 table streamed on each rank, in its own blocks
        streamed = ca_fit_sharded(table, mesh=mesh, device="cpu", hbm_bytes=32 << 10)
        assert sharded.LAST_CA_STREAM is not None and sharded.LAST_CA_STREAM["n_blocks"] >= 2
        err = _ca_errors(streamed, want)
        assert all(err[kk] <= CA_BOUNDS[kk] for kk in err), (name, "streamed", err)
        rel = np.abs(streamed[3] - out[f"ca_{name}_host_3"]).max() / want.sv.max()
        assert rel <= 1e-10, rel
        out[f"ca_{name}_streamed_sv"] = streamed[3]

    # the fast path over the ranks (f32: each rank's rows, the total, the
    # column sums and the Gram all-reduced) within tests/test_ca_streamed.py:
    # 23-37's bounds of fit_ca: eigenvalues rtol 1e-5, the eigenvector
    # outputs rtol 1e-3, atol 1e-5, each column up to its sign
    table = np.random.default_rng(43).random((101, 7)) * 10.0
    want = fit_ca(table)
    for phi in ("host", "device"):
        fit = list(ca_fit_sharded(table, precision="fast", phi=phi, mesh=mesh, device="cpu"))
        if phi == "device":
            assert isinstance(fit[2], ShardedRows) and fit[2].rows == mesh.rows(len(table))
            fit[2] = fit[2].gather(mesh.world_host).numpy().T
        coords, inertia, tw, sv = (np.asarray(a, dtype=np.float64) for a in fit)
        np.testing.assert_allclose(sv, want.sv, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(inertia, want.inertia, rtol=1e-3, atol=1e-7)
        for j in range(len(sv)):
            sign = 1.0 if np.dot(coords[:, j], want.sample_coords[:, j]) >= 0 else -1.0
            np.testing.assert_allclose(coords[:, j], sign * want.sample_coords[:, j],
                                       rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(tw[j], sign * want.twister[j], rtol=1e-3, atol=1e-5)
        for i, a in enumerate(fit):
            out[f"ca_fast_{phi}_{i}"] = np.asarray(a)

    # 3. sharded checkpoints: this job's rows, a replicated array, onto
    # another layout, and the JAX package's own
    arr = np.arange(CKPT_ROWS * 5, dtype=np.float32).reshape(CKPT_ROWS, 5) * 0.5
    lo, hi = mesh.rows(CKPT_ROWS)
    ck = os.path.join(workdir, "ckpt")
    save_sharded(ck, ShardedRows(torch.from_numpy(arr[lo:hi]), lo, CKPT_ROWS))
    assert os.path.exists(ck + f".shard{rank}.kpopckpt") and os.path.exists(ck + ".kpopckpt")
    back = load_sharded(ck, mesh)
    assert back.rows == (lo, hi)
    np.testing.assert_array_equal(back.local.numpy(), arr[lo:hi])
    np.testing.assert_array_equal(load_sharded(ck).numpy(), arr)
    if world == 4:
        other = make_mesh(data_parallel=2)
        moved = load_sharded(ck, other, "kmer")
        assert moved.rows == other.rows(CKPT_ROWS, "kmer") != (lo, hi)
        np.testing.assert_array_equal(moved.local.numpy(), arr[slice(*moved.rows)])
    rep = os.path.join(workdir, "replicated")
    save_sharded(rep, torch.arange(6, dtype=torch.int64))
    np.testing.assert_array_equal(load_sharded(rep).numpy(), np.arange(6))
    jax_arr = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    from_jax = load_sharded(os.path.join(workdir, "jaxckpt"), mesh)
    np.testing.assert_array_equal(from_jax.local.numpy(), jax_arr[slice(*from_jax.rows)])

    # 4. k-mer-sharded serving: random parameters (as
    # tests/distributed_worker.py builds them), sharded from the whole
    # parameters, against the host float64 chain
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.ops.pipeline import ClassifierParams

    space = KmerSpace("DNA-ds", 5)
    rngs = np.random.default_rng(7)
    V, d, C, B, L = 96, 8, 5, 8, 64
    vocab_codes = np.sort(rngs.choice(space.n_kmers, size=V, replace=False))
    lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
    lut[vocab_codes.astype(np.int64)] = np.arange(V, dtype=np.int32)
    tw = rngs.standard_normal((V, d)).astype(np.float32)
    ccoords = rngs.standard_normal((C, d)).astype(np.float32)
    metric = np.full(d, 1.0 / d, dtype=np.float32)
    cn = np.sqrt((ccoords.astype(np.float64) ** 2 * metric).sum(axis=1))
    cn = np.where(cn == 0.0, 1.0, cn)
    full = ClassifierParams(*(torch.from_numpy(a) for a in (
        lut, tw, metric, ccoords, cn.astype(np.float32))), 5, True)
    params, vg = shard_classifier_params(full, mesh, "cpu")
    assert vg == V and params.twister.shape[0] == -(-V // world)
    codes = rngs.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[-1] = -1  # no known window: divides by 1
    seqs = ["".join("ACGT"[c] if c >= 0 else "N" for c in row) for row in codes]
    got = _serve(mesh, params, vg, seqs)
    code_to_col = {int(c): i for i, c in enumerate(vocab_codes)}
    want = np.zeros((B, C))
    for b in range(B):
        spec = np.zeros(V)
        for c in space.window_codes(codes[b]):
            col = code_to_col.get(int(c))
            if col is not None:
                spec[col] += 1.0
        tv = (spec / (spec.sum() or 1.0)) @ tw.astype(np.float64)
        na = float(np.sqrt((tv**2 * metric).sum())) or 1.0
        want[b] = np.sqrt(np.maximum((((tv / na)[None, :] - ccoords / cn[:, None]) ** 2
                                      * metric[None, :]).sum(axis=1), 0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=HOST_CHAIN_ATOL)
    out["serve_random"] = got

    # a rank-sharded fit served, at k = 5 and k = 18, on dp = 1 and, at
    # four ranks, dp = 2, kp = 2
    meshes = [("dp1", mesh)] + ([("dp2", make_mesh(data_parallel=2))] if world == 4 else [])
    for k, V in ((5, 150), (18, 300)):
        case = _trained_case(np.random.default_rng(100 + k), k, V, C=6)
        seqs = _reads(np.random.default_rng(k), 9, 120, case[3])
        for label, m in meshes:
            _serve_trained(out, f"trained_k{k}_{label}", m, *case[:3], seqs)

    assert "jax" not in sys.modules and "kpop_tpu" not in sys.modules
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    open(os.path.join(workdir, f"ok.{rank}"), "w").close()
    distributed.shutdown()
    return 0


# ---------------- the parent (pytest) ----------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_inputs(td: str) -> None:
    rng = np.random.default_rng(9)
    for i in range(4):
        with open(os.path.join(td, f"in{i}.fasta"), "w") as f:
            for j in range(4):
                seq = "".join(rng.choice(list("ACGT"), size=12))
                f.write(f">f{i}r{j}\n{seq}\n")
    # a checkpoint written by the JAX package, from the 8 host devices
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kpop_tpu.config import jax_setup
    from kpop_tpu.parallel.checkpoint import save_sharded
    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS, make_mesh

    jax = jax_setup()
    arr = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    mesh = make_mesh(8)
    save_sharded(os.path.join(td, "jaxckpt"),
                 jax.device_put(arr, NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))))


def run_job(td: str, world: int, script: str = __file__, args=()) -> list[str]:
    """``script`` as ``world`` gloo ranks on the CPU, each with its own
    timeout; returns their outputs, failing on any rank's exit code."""
    port = _free_port()
    env = dict(os.environ, KPOP_PLATFORM="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world), str(port), td, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    return outs


def _job(tmp_path, world: int):
    td = str(tmp_path)
    _write_inputs(td)
    run_job(td, world)
    for r in range(world):
        assert os.path.exists(os.path.join(td, f"ok.{r}"))
    outs = [dict(np.load(os.path.join(td, f"out{r}.npz"))) for r in range(world)]
    # every rank got the same bits of the fit and of the served distances
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for key in outs[0]:
            assert np.array_equal(o[key], outs[0][key]), key
    # the port's checkpoint, loaded by the JAX package onto 8 devices
    from jax.sharding import PartitionSpec as P

    from kpop_tpu.parallel.checkpoint import load_sharded
    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS, make_mesh

    back = load_sharded(os.path.join(td, "ckpt"), make_mesh(8), P((DATA_AXIS, KMER_AXIS), None))
    want = np.arange(CKPT_ROWS * 5, dtype=np.float32).reshape(CKPT_ROWS, 5) * 0.5
    np.testing.assert_array_equal(np.asarray(back), want)
    return outs


def test_two_rank_distributed(tmp_path):
    outs = _job(tmp_path, 2)
    assert "trained_k18_dp1_bfloat16" in outs[0]


def test_four_rank_distributed(tmp_path):
    """Four ranks: also dp = 2, kp = 2, and a checkpoint loaded onto the
    kmer axis of that layout."""
    outs = _job(tmp_path, 4)
    assert {"trained_k5_dp2_float32", "trained_k18_dp2_bfloat16"} <= outs[0].keys()


def test_one_process_needs_no_process_group(monkeypatch):
    """Without coordinates or the torchrun environment, ``initialize``
    joins nothing and the layout is one rank; coordinates without a rank
    raise."""
    import pytest

    from kpop_tpu_torch.parallel import distributed
    from kpop_tpu_torch.parallel.mesh import make_mesh

    for v in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    assert distributed.initialize() is False
    assert (distributed.world_size(), distributed.rank(), distributed.is_primary()) == (1, 0, True)
    mesh = make_mesh()
    assert (mesh.dp, mesh.kp, mesh.kmer_group) == (1, 1, None)
    assert mesh.rows(10) == mesh.rows(10, "kmer") == mesh.rows(10, "data") == (0, 10)
    with pytest.raises(ValueError, match="world_size and rank"):
        distributed.initialize(address="tcp://localhost:1", world_size=2)
    with pytest.raises(ValueError, match="ranks asked"):
        make_mesh(2)
    # the default backend: gloo on the CPU and for ranks that share a card
    import torch

    monkeypatch.setenv("KPOP_PLATFORM", "cpu")
    assert distributed.default_backend() == "gloo"
    monkeypatch.delenv("KPOP_PLATFORM")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for local, want in (("4", "gloo"), ("2", "nccl"), (None, "nccl")):
        if local is None:
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
        assert distributed.default_backend() == want, local


def test_checkpoints_cross_between_the_packages(tmp_path):
    """In one process: a checkpoint the JAX package wrote from a 2-D
    sharding (P(data, kmer): frames split on both axes) loads whole and by
    rows in the port, and one the port wrote loads in the JAX package onto
    another sharding."""
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kpop_tpu.config import jax_setup
    from kpop_tpu.parallel import checkpoint as jck
    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS, make_mesh as jax_mesh
    from kpop_tpu_torch.parallel import checkpoint as tck
    from kpop_tpu_torch.parallel.mesh import Layout, ShardedRows

    jax = jax_setup()
    mesh = jax_mesh(8)
    arr = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) - 7.5
    jck.save_sharded(str(tmp_path / "j2d"),
                     jax.device_put(arr, NamedSharding(mesh, P(DATA_AXIS, KMER_AXIS))))
    np.testing.assert_array_equal(tck.load_sharded(str(tmp_path / "j2d")).numpy(), arr)
    for r in range(4):
        rows = tck.load_sharded(str(tmp_path / "j2d"), Layout(dp=2, kp=2, rank=r), "kmer")
        np.testing.assert_array_equal(rows.local.numpy(), arr[slice(*rows.rows)])
    tck.save_sharded(str(tmp_path / "t"), ShardedRows(torch.from_numpy(arr), 0, 8))
    back = jck.load_sharded(str(tmp_path / "t"), mesh, P(KMER_AXIS, None))
    np.testing.assert_array_equal(np.asarray(back), arr)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
