"""kpop_tpu_torch.parallel.sharded.ca_fit_sharded on the CPU against
kpop_tpu.parallel.sharded.ca_fit_sharded on a one-device CPU mesh and the
host float64 fit_ca, and the residual Gram of kpop_tpu_torch.ops.gram
against numpy float64.

Bounds: the port's dd path is float64 throughout, so it is held to the
bounds of tests/test_dd.py:81-84 (sv and inertia 1e-8, sample coordinates
1e-6, twister 1e-5, absolute), columns compared up to sign as in
tests/test_ca_streamed.py:32-37; the twister left on the device (f32) to
tests/test_dd.py:140-142 (1e-6).  The fast path (f32 on the device) is
held to the JAX fast path and the host by tests/test_ca_streamed.py's
eigenvalue bound (rtol 1e-5) on inertia and sv, and its 1e-3 / 1e-5 on
the eigenvector-derived outputs."""

import numpy as np
import pytest
import torch

from kpop_tpu.core.ca import fit_ca
from kpop_tpu_torch.ops import gram
from kpop_tpu_torch.parallel import sharded as port

SV_ATOL = INERTIA_ATOL = 1e-8  # tests/test_dd.py:81-82
COORDS_ATOL = 1e-6  # tests/test_dd.py:83
TWISTER_ATOL = 1e-5  # tests/test_dd.py:84
DEVICE_TWISTER_ATOL = 1e-6  # tests/test_dd.py:140-142
GRAM_RTOL = 1e-12  # of the largest |G| entry; float64 sums in another order


@pytest.fixture(scope="module")
def mesh():
    from kpop_tpu.parallel.mesh import make_mesh

    return make_mesh(1)


def make_table(case: str):
    """(table, col_weights, n_dims, port wire, JAX wire) of a seeded case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    w, n_dims = None, None
    if case == "u8":
        table, wires = rng.integers(0, 200, size=(130, 6)).astype(np.int32), ("u8", "u8")
    elif case == "u16":
        table, wires = rng.integers(0, 3000, size=(514, 9)).astype(np.float64), ("u16", "u16")
    elif case == "f32":
        table, wires = (rng.random((130, 6)) * 5).astype(np.float32), ("f32", "f32")
    elif case == "f64_inexact":
        table, wires = rng.random((130, 6)) * 5, ("f64", "limbs")
    elif case == "signed":
        table, wires = rng.integers(-3, 30, size=(200, 7)).astype(np.float64), ("f64", "limbs")
    elif case == "col_weights":
        table = rng.integers(0, 40000, size=(301, 7)).astype(np.int64)
        w, wires = 1.0 / table.sum(axis=0), ("u16", "u16")
    elif case == "n_dims":
        table, n_dims, wires = rng.integers(0, 50, size=(400, 12)).astype(np.int32), 4, ("u8", "u8")
    elif case == "zero_rows_cols":
        table = rng.integers(0, 9, size=(150, 8)).astype(np.int32)
        table[::7] = 0
        table[:, 3] = 0
        wires = ("u8", "u8")
    else:
        raise ValueError(case)
    return table, w, n_dims, wires


CASES = ["u8", "u16", "f32", "f64_inexact", "signed", "col_weights", "n_dims", "zero_rows_cols"]


def host_fit(table, w, n_dims):
    t = np.asarray(table, dtype=np.float64)
    return fit_ca(t if w is None else t * w[None, :], n_dims=n_dims)


def assert_ca_close(got, want, coords_atol=COORDS_ATOL, twister_atol=TWISTER_ATOL,
                    sv_atol=SV_ATOL, rtol=0.0):
    """(coords, inertia, twister [d, K], sv) against another fit, columns up
    to sign (tests/test_ca_streamed.py:32-37)."""
    coords, inertia, twister, sv = (np.asarray(a, dtype=np.float64) for a in got)
    w_coords, w_inertia, w_twister, w_sv = (np.asarray(a, dtype=np.float64) for a in want)
    np.testing.assert_allclose(sv, w_sv, rtol=rtol, atol=sv_atol)
    np.testing.assert_allclose(inertia, w_inertia, rtol=rtol, atol=sv_atol)
    assert coords.shape == w_coords.shape and twister.shape == w_twister.shape
    for j in range(len(w_sv)):
        a, b = coords[:, j], w_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=rtol, atol=coords_atol)
        np.testing.assert_allclose(twister[j], sign * w_twister[j], rtol=rtol, atol=twister_atol)


def as_tuple(res):
    return res.sample_coords, res.inertia, res.twister, res.sv


@pytest.mark.parametrize("case", CASES)
def test_dd_fit_matches_host_and_jax(mesh, case):
    from kpop_tpu.parallel import sharded as jax_sharded

    table, w, n_dims, (port_wire, jax_wire) = make_table(case)
    want = host_fit(table, w, n_dims)
    got = port.ca_fit_sharded(table, n_dims=n_dims, col_weights=w, device="cpu")
    assert port.LAST_DD_UPLOAD == port_wire
    assert isinstance(got[2], np.ndarray) and got[2].dtype == np.float64
    assert_ca_close(got, as_tuple(want))
    ref = jax_sharded.ca_fit_sharded(mesh, table, n_dims=n_dims, col_weights=w)
    assert jax_sharded.LAST_DD_UPLOAD == jax_wire
    assert_ca_close(got, ref)
    assert set(port.LAST_CA_PHASES) == {"masses", "upload", "gram", "eigh", "phi"}


@pytest.mark.parametrize("case", ["u8", "col_weights", "signed"])
def test_device_phi_matches_host_phi(case):
    table, w, n_dims, _ = make_table(case)
    _c, _i, tw_host, _s = port.ca_fit_sharded(table, col_weights=w, device="cpu")
    c, i, tw_dev, s = port.ca_fit_sharded(table, col_weights=w, phi="device", device="cpu")
    assert isinstance(tw_dev, torch.Tensor) and tw_dev.dtype == torch.float32
    assert tw_dev.shape == (table.shape[0], len(s))
    np.testing.assert_allclose(tw_dev.double().numpy().T, tw_host, rtol=0, atol=DEVICE_TWISTER_ATOL)
    assert_ca_close((c, i, tw_dev.double().numpy().T, s), as_tuple(host_fit(table, w, n_dims)),
                    twister_atol=TWISTER_ATOL)


@pytest.mark.parametrize("phi", ["host", "device"])
@pytest.mark.parametrize("case", ["u8", "col_weights", "n_dims"])
def test_fast_fit_matches_jax_fast_and_host(mesh, case, phi):
    from kpop_tpu.parallel import sharded as jax_sharded

    table, w, n_dims, _ = make_table(case)
    got = list(port.ca_fit_sharded(table, n_dims=n_dims, col_weights=w, precision="fast",
                                   phi=phi, device="cpu"))
    ref = list(jax_sharded.ca_fit_sharded(mesh, table, n_dims=n_dims, col_weights=w,
                                          precision="fast", phi=phi))
    if phi == "device":
        assert isinstance(got[2], torch.Tensor) and got[2].shape == (table.shape[0], len(got[3]))
        got[2], ref[2] = got[2].double().numpy().T, np.asarray(ref[2], dtype=np.float64).T
    # tests/test_ca_streamed.py:23-37: eigenvalues rtol 1e-5, eigenvector
    # outputs rtol 1e-3 / atol 1e-5
    for want in (ref, as_tuple(host_fit(table, w, n_dims))):
        assert_ca_close(got, want, coords_atol=1e-5, twister_atol=1e-5, sv_atol=1e-7, rtol=1e-3)
        np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["host", "jax"])
def test_twist_counter_db_matches_jax(mesh, backend):
    """The copied training entry: host CA equal to the JAX one's; the device
    dispatch within the dd bounds of the JAX device CA."""
    from kpop_tpu.core.counter_db import CounterDB as WantDB
    from kpop_tpu.core.twister import twist_counter_db as want_twist
    from kpop_tpu_torch.core.counter_db import CounterDB as GotDB
    from kpop_tpu_torch.core.twister import twist_counter_db as got_twist
    import io

    rng = np.random.default_rng(8)
    text = "".join(
        "\tS%d\n" % s + "".join("%04x\t%d\n" % (k, rng.integers(1, 40)) for k in sorted(
            rng.choice(300, size=120, replace=False)))
        for s in range(7)
    )
    dbs = []
    for cls in (WantDB, GotDB):
        db = cls()
        db.add_spectra_stream(io.StringIO(text))
        dbs.append(db)
    want = want_twist(dbs[0], backend=backend)
    got = got_twist(dbs[1], backend=backend)
    pairs = [(got[0].twister, want[0].twister), (got[0].inertia, want[0].inertia),
             (got[1], want[1]), (got[2], want[2])]
    for g, w in pairs:
        assert g.matrix.row_names == w.matrix.row_names
        assert g.matrix.col_names == w.matrix.col_names
    gt, wt = got[0].twister.matrix.data, want[0].twister.matrix.data
    if backend == "host":
        for g, w in pairs:
            np.testing.assert_array_equal(g.matrix.data, w.matrix.data)
    else:
        coords = (got[1].matrix.data, want[1].matrix.data)
        inertia = (got[0].inertia.matrix.data[0], want[0].inertia.matrix.data[0])
        assert_ca_close((coords[0], inertia[0], gt, inertia[0]),
                        (coords[1], inertia[1], wt, inertia[1]))


@pytest.mark.parametrize("wire", [torch.uint8, torch.uint16, torch.float32, torch.float64])
def test_residual_gram_matches_numpy_float64(wire):
    rng = np.random.default_rng(21)
    K, ns = 1000, 37
    x = rng.poisson(3.0, size=(K, ns)).astype(np.float64)
    if wire == torch.float64:
        x = x + rng.random((K, ns))
    alpha, u = rng.random(K) + 0.5, rng.random(K) * 1e-2
    beta, v = (rng.random(ns) + 0.5) * 1e-3, rng.random(ns)
    S = x * alpha[:, None] * beta[None, :] - np.outer(u, v)
    want = S.T @ S
    t = [torch.as_tensor(a) for a in (alpha, u, beta, v)]
    xt = torch.as_tensor(x).to(wire)
    for got in (gram.residual_gram_ref(xt, *t, block_bytes=37 * 8 * 64),
                gram.residual_gram(xt, *t)):
        assert got.dtype == torch.float64 and got.shape == (ns, ns)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAM_RTOL * np.abs(want).max())


def emulate_kernel(x, alpha, u, beta, v, n_sm):
    """The kernel's arithmetic and plan in plain torch: S factored as
    beta alpha T with T = x - rho gamma (gram.factors); per slice, each upper
    64 x 64 tile as beta_i beta_j sum_k (alpha^2 T)_i T_j (alpha T on both
    sides on a diagonal tile), written to its place and mirrored; then the
    slices summed in order.  Returns (G, rows covered per k-mer row, writes
    per entry of one slice)."""
    K, ns = x.shape
    rho, gamma = gram.factors(alpha, u, beta, v)
    slices, rows = gram.split_plan(K, ns, n_sm)
    covered = torch.zeros(K, dtype=torch.int64)
    writes = torch.zeros((ns, ns), dtype=torch.int64)
    ws = torch.empty((slices, ns, ns), dtype=torch.float64)
    for s in range(slices):
        k0, k1 = s * rows, min(K, (s + 1) * rows)
        assert k0 < k1, "an empty slice"
        covered[k0:k1] += 1
        a = alpha[k0:k1, None]
        T = x[k0:k1].double() - rho[k0:k1, None] * gamma[None, :]
        for bi, bj in gram.tile_pairs(ns):
            I = slice(bi * gram.TILE, min(ns, (bi + 1) * gram.TILE))
            J = slice(bj * gram.TILE, min(ns, (bj + 1) * gram.TILE))
            if bi == bj:
                A = B = a * T[:, I]
            else:
                A, B = a * a * T[:, I], T[:, J]
            tile = (A.T @ B) * (beta[I, None] * beta[None, J])
            ws[s, I, J] = tile
            if s == 0:
                writes[I, J] += 1
            if bi != bj:
                ws[s, J, I] = tile.T
                if s == 0:
                    writes[J, I] += 1
    G = ws[0].clone()
    for s in range(1, slices):
        G += ws[s]
    return G, covered, writes


PLANS = [(1, 1, 132), (33, 7, 132), (1000, 65, 132), (4097, 200, 132), (70001, 130, 132),
         (5000, 129, 8)]


# a one-cell table's CA residual is 0 up to rounding: no CA case for it
@pytest.mark.parametrize("K,ns,n_sm,vectors", [p + ("random",) for p in PLANS]
                         + [p + ("ca",) for p in PLANS[1:]])
def test_split_plan_covers_every_row_once(K, ns, n_sm, vectors):
    """Every row in exactly one slice, every entry written once per slice,
    and the kernel's factored arithmetic equal to the plain Gram: on random
    vectors, and on a CA's (zero rows: alpha = u = 0)."""
    rng = np.random.default_rng(K + ns)
    table = rng.integers(0, 256, size=(K, ns)).astype(np.uint8)
    if vectors == "ca":
        table[1::5] = 0
        a, uu, b, vv, r, _ = port.residual_vectors(table, None)
        alpha, u, beta, v = (torch.as_tensor(t) for t in (a * (r > 0), uu, b, vv))
    else:
        alpha, u = torch.as_tensor(rng.random(K)), torch.as_tensor(rng.random(K) * 1e-2)
        beta, v = torch.as_tensor(rng.random(ns) * 1e-3), torch.as_tensor(rng.random(ns))
    x = torch.as_tensor(table)
    slices, rows = gram.split_plan(K, ns, n_sm)
    assert rows % gram.CHUNK == 0 and (slices - 1) * rows < K <= slices * rows
    G, covered, writes = emulate_kernel(x, alpha, u, beta, v, n_sm)
    assert torch.equal(covered, torch.ones(K, dtype=torch.int64))
    assert torch.equal(writes, torch.ones((ns, ns), dtype=torch.int64))
    want = gram.residual_gram_ref(x, alpha, u, beta, v)
    assert torch.allclose(G, want, rtol=0, atol=GRAM_RTOL * float(want.abs().max()))


def test_split_plan_fills_the_card():
    slices, rows = gram.split_plan(367_987, 512)
    assert len(gram.tile_pairs(512)) == 36
    assert 36 * slices >= gram.WAVES * gram.RESIDENT_PER_SM * gram.H100_SMS


@pytest.mark.parametrize("waves,want", [(2, 15), (3, 22), (4, 30), (5, 37), (6, 44), (8, 59)])
def test_split_plan_sizes_the_grid_in_waves(waves, want):
    """The headline Gram's slices for the waves that
    tools/probe_ca_gram.py times: whole waves of resident blocks over the
    36 upper tiles, every row in one slice."""
    K = 367_987
    slices, rows = gram.split_plan(K, 512, waves=waves)
    assert slices == want
    assert 36 * slices >= waves * gram.RESIDENT_PER_SM * gram.H100_SMS
    assert rows % gram.CHUNK == 0 and (slices - 1) * rows < K <= slices * rows


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_over_budget_raises_naming_the_streamed_path(monkeypatch, how):
    """Over the budget, by argument or by KPOP_CA_HBM_BYTES, the fit
    streams (it raised before the streamed path was ported) and gives the
    resident fit; KPOP_CA_HBM_BYTES=0 disables the budget and the fit stays
    resident."""
    table = np.random.default_rng(2).integers(0, 200, size=(4096, 9)).astype(np.int32)
    kwargs = {"device": "cpu"}
    if how == "argument":
        kwargs["hbm_bytes"] = 32 << 10
    else:
        monkeypatch.setenv("KPOP_CA_HBM_BYTES", str(32 << 10))
    got = port.ca_fit_sharded(table, **kwargs)
    assert port.LAST_CA_STREAM is not None and port.LAST_CA_STREAM["n_blocks"] > 1
    assert port.LAST_CA_STREAM["budget_bytes_per_device"] == 32 << 10
    monkeypatch.setenv("KPOP_CA_HBM_BYTES", "0")  # 0 disables the budget
    want = port.ca_fit_sharded(table, device="cpu")
    assert port.LAST_CA_STREAM is None
    np.testing.assert_allclose(got[3], want[3], rtol=1e-10, atol=0)
    assert_ca_close(got, want)


def test_factors_are_nan_where_s_has_none():
    alpha = torch.tensor([0.0, 2.0, 0.0], dtype=torch.float64)
    u = torch.tensor([0.0, 1.0, 3.0], dtype=torch.float64)
    rho, gamma = gram.factors(alpha, u, alpha * 3, u)
    assert rho[:2].tolist() == [0.0, 0.5] and torch.isnan(rho[2])
    assert gamma[:2].tolist() == [0.0, 1.0 / 6.0] and torch.isnan(gamma[2])


def test_residual_gram_rejects_bad_input():
    x = torch.zeros((4, 3), dtype=torch.uint8)
    k, n = torch.zeros(4, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        gram.residual_gram(x, k, k, k, n)
    with pytest.raises(TypeError):
        gram.residual_gram(x.to(torch.int32), k, k, n, n)


def test_unknown_options_raise():
    table = np.ones((5, 3), dtype=np.int32)
    with pytest.raises(ValueError):
        port.ca_fit_sharded(table, precision="quad", device="cpu")
    with pytest.raises(ValueError):
        port.ca_fit_sharded(table, phi="disk", device="cpu")
