"""The streamed CA fit of kpop_tpu_torch (ca_fit_sharded above its device
budget) on the CPU, the counterpart of tests/test_ca_streamed.py: against
kpop_tpu's streamed ca_fit_sharded on a one-device CPU mesh at the same
budget, the host float64 fit_ca and the port's own resident fit.

Bounds: against JAX and fit_ca, tests/test_ca_streamed.py's
_assert_ca_equal (eigenvalues rtol 1e-5, atol 1e-7; eigenvector-derived
outputs rtol 1e-3, atol 1e-5, columns up to sign).  The port's streamed
fit is float64 throughout, so it is also held to tests/test_dd.py:81-84's
bounds of fit_ca (through tests/test_torch_ca.py's assert_ca_close; the
twister left on the device, f32, to 1e-6) and its sv to 1e-10 relative of
the resident fit: only the order of the Gram's float64 sums differs."""

import gc

import numpy as np
import pytest
import torch

from kpop_tpu.core.ca import fit_ca
from kpop_tpu_torch.ops import gram
from kpop_tpu_torch.parallel import sharded as port

from test_torch_ca import (DEVICE_TWISTER_ATOL, GRAM_RTOL, TWISTER_ATOL, as_tuple,
                           assert_ca_close)

BUDGET = 32 << 10  # far below each table's resident footprint
SV_RTOL_RESIDENT = 1e-10
STREAM_KEYS = {"wire", "block_rows", "n_blocks", "budget_bytes_per_device",
               "block_bytes_per_device", "max_live_blocks"}


@pytest.fixture(scope="module")
def mesh():
    from kpop_tpu.parallel.mesh import make_mesh

    return make_mesh(1)


def assert_ca_equal(got, want, rtol=1e-5, atol=1e-7):
    """tests/test_ca_streamed.py:23-37: (coords, inertia, twister [d, K],
    sv) against a CAResult."""
    coords, inertia, twister, sv = got
    np.testing.assert_allclose(inertia, want.inertia, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sv, want.sv, rtol=rtol, atol=atol)
    for j in range(want.n_dims):
        a, b = coords[:, j], want.sample_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(twister[j], sign * want.twister[j], rtol=1e-3, atol=1e-5)


def host_twister(tw) -> np.ndarray:
    """The [d, K] float64 twister of either phi placement."""
    return tw.double().numpy().T if isinstance(tw, torch.Tensor) else tw


def table_of(wire: str, rows: int = 2048, ns: int = 9, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if wire == "u8":
        return rng.integers(0, 200, size=(rows, ns)).astype(np.int32)
    if wire == "u16":
        return rng.integers(0, 60000, size=(rows, ns)).astype(np.int32)
    if wire == "f32":  # exactly f32, not integer
        return (rng.random((rows, ns)) + 0.1).astype(np.float32)
    return rng.random((rows, ns)) + 0.1  # f32-inexact: the f64 wire


def accumulated(x, alpha, u, beta, v, rows: int) -> torch.Tensor:
    """The Gram of ``x`` through a GramAccumulator in blocks of ``rows``."""
    acc = gram.GramAccumulator(beta, v, rows)
    for i in range(0, x.shape[0], rows):
        acc.add(x[i : i + rows], alpha[i : i + rows], u[i : i + rows])
    return acc.finish()


@pytest.mark.parametrize("rows", [1000, 300, 64, 999])
@pytest.mark.parametrize("wire", [torch.uint8, torch.uint16, torch.float32, torch.float64])
def test_gram_accumulator_plain_order(wire, rows):
    """The streamed Gram's order in plain PyTorch (the accumulator on the
    CPU): each block's rows over the slices that the pass's full block
    fixes, into per-slice partials, the slices added once at the end.  In
    one block, in blocks with a short last one (300, 64, 999 rows of
    1,000), on every wire, at ns = 37 (not a multiple of 16): within
    GRAM_RTOL of max |G| of numpy float64 and of the one-launch plain
    version, the same bits on a second run, and every row of each block in
    exactly one slice."""
    rng = np.random.default_rng(21)
    K, ns = 1000, 37
    x = rng.poisson(3.0, size=(K, ns)).astype(np.float64)
    if wire == torch.float32:
        x = (x + rng.random((K, ns))).astype(np.float32).astype(np.float64)
    if wire == torch.float64:
        x = x + rng.random((K, ns))
    alpha, u = rng.random(K) + 0.5, rng.random(K) * 1e-2
    beta, v = (rng.random(ns) + 0.5) * 1e-3, rng.random(ns)
    S = x * alpha[:, None] * beta[None, :] - np.outer(u, v)
    want = S.T @ S
    t = [torch.as_tensor(a) for a in (alpha, u, beta, v)]
    xt = torch.as_tensor(x).to(wire)
    got = accumulated(xt, *t, rows)
    assert got.dtype == torch.float64 and got.shape == (ns, ns)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAM_RTOL * scale)
    np.testing.assert_allclose(got.numpy(), gram.residual_gram_ref(xt, *t).numpy(), rtol=0,
                               atol=GRAM_RTOL * scale)
    assert torch.equal(got, accumulated(xt, *t, rows))
    slices = gram.split_plan(rows, ns)[0]
    for i in range(0, K, rows):
        n = min(K, i + rows) - i
        R = gram.slice_rows(n, slices)
        assert R % gram.CHUNK == 0 and slices * R >= n


@pytest.mark.parametrize("budget", [96 << 10, 256 << 10])
@pytest.mark.parametrize("wire", ["u8", "u16", "f32", "f64"])
def test_streamed_blocks_of_several_sizes(mesh, wire, budget):
    """Streamed fits whose blocks hold several split-K slices and end on a
    short block, at ns = 21, on every wire: within tests/test_dd.py's
    bounds of fit_ca and of the JAX package's resident and streamed fits,
    and the same bits on a second fit."""
    from kpop_tpu.parallel import sharded as jax_sharded

    table = table_of(wire, rows=1500, ns=21, seed=8)
    got = port.ca_fit_sharded(table, hbm_bytes=budget, device="cpu")
    st = port.LAST_CA_STREAM
    assert st is not None and st["wire"] == wire and 1500 % st["block_rows"]
    assert gram.split_plan(st["block_rows"], 21)[0] > 1
    assert_ca_close(got, as_tuple(fit_ca(table.astype(np.float64))))
    again = port.ca_fit_sharded(table, hbm_bytes=budget, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, again))
    for kwargs in ({}, {"hbm_bytes": BUDGET}):
        ref = jax_sharded.ca_fit_sharded(mesh, table, **kwargs)
        assert (jax_sharded.LAST_CA_STREAM is not None) == bool(kwargs)
        assert_ca_close(got, ref)


@pytest.mark.parametrize("phi", ["host", "device"])
@pytest.mark.parametrize("wire", ["u8", "u16", "f64"])
def test_streamed_matches_jax_host_and_resident(mesh, wire, phi):
    from kpop_tpu.parallel import sharded as jax_sharded

    table = table_of(wire)
    got = port.ca_fit_sharded(table, hbm_bytes=BUDGET, phi=phi, device="cpu")
    stats = port.LAST_CA_STREAM
    assert stats is not None and stats["wire"] == wire and stats["n_blocks"] > 1
    assert port.LAST_DD_UPLOAD == wire
    assert set(port.LAST_CA_PHASES) == {"masses", "gram", "eigh", "phi"}
    if phi == "device":
        assert isinstance(got[2], torch.Tensor) and got[2].dtype == torch.float32
        assert got[2].shape == (table.shape[0], len(got[3]))
    got = (got[0], got[1], host_twister(got[2]), got[3])
    want = fit_ca(table.astype(np.float64))
    assert_ca_equal(got, want)
    assert_ca_close(got, as_tuple(want),
                    twister_atol=DEVICE_TWISTER_ATOL if phi == "device" else TWISTER_ATOL)
    ref = jax_sharded.ca_fit_sharded(mesh, table, hbm_bytes=BUDGET, phi=phi)
    assert jax_sharded.LAST_CA_STREAM is not None and jax_sharded.LAST_CA_STREAM["n_blocks"] > 1
    ref_tw = np.asarray(ref[2], dtype=np.float64).T if phi == "device" else ref[2]
    for j in range(len(got[3])):  # columns up to sign
        sign = 1.0 if np.dot(got[0][:, j], ref[0][:, j]) >= 0 else -1.0
        np.testing.assert_allclose(got[0][:, j], sign * ref[0][:, j], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got[2][j], sign * ref_tw[j], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-7)
    res = port.ca_fit_sharded(table, hbm_bytes=0, phi=phi, device="cpu")
    assert port.LAST_CA_STREAM is None
    np.testing.assert_allclose(got[3], res[3], rtol=SV_RTOL_RESIDENT, atol=0)
    assert_ca_close(got, (res[0], res[1], host_twister(res[2]), res[3]),
                    twister_atol=DEVICE_TWISTER_ATOL if phi == "device" else TWISTER_ATOL)


@pytest.mark.parametrize("phi", ["host", "device"])
def test_streamed_with_col_weights(phi):
    rng = np.random.default_rng(4)
    table = rng.integers(0, 50, size=(2048, 6)).astype(np.int32)
    w = 1.0 / np.maximum(table.sum(axis=0), 1.0)
    got = port.ca_fit_sharded(table, col_weights=w, hbm_bytes=BUDGET, phi=phi, device="cpu")
    assert port.LAST_CA_STREAM is not None and port.LAST_CA_STREAM["wire"] == "u8"
    want = fit_ca(table.astype(np.float64) * w[None, :])
    got = (got[0], got[1], host_twister(got[2]), got[3])
    assert_ca_equal(got, want)
    assert_ca_close(got, as_tuple(want),
                    twister_atol=DEVICE_TWISTER_ATOL if phi == "device" else TWISTER_ATOL)


def test_streamed_truncated_dims():
    """n_dims truncation through the streamed path with the twister on the
    device: the leading dims of the full fit, inertia each dim's share of
    the whole spectrum."""
    rng = np.random.default_rng(7)
    table = rng.integers(0, 150, size=(3072, 9)).astype(np.int32)
    c, i, tw, s = port.ca_fit_sharded(table, n_dims=3, hbm_bytes=BUDGET, phi="device", device="cpu")
    assert port.LAST_CA_STREAM is not None
    assert tuple(tw.shape) == (3072, 3) and i.shape == (3,) and s.shape == (3,)
    full = fit_ca(table.astype(np.float64))
    np.testing.assert_allclose(i, full.inertia[:3], rtol=1e-5, atol=1e-7)
    assert_ca_equal((c, i, host_twister(tw), s), fit_ca(table.astype(np.float64), n_dims=3))


def test_last_ca_stream_keys_and_geometry():
    """The JAX package's keys, blocks that cover the table, and blocks
    sized so that the fit's device footprint stays within the budget."""
    table = table_of("u16", rows=3000, ns=7)
    port.ca_fit_sharded(table, hbm_bytes=BUDGET, device="cpu")
    st = port.LAST_CA_STREAM
    assert STREAM_KEYS <= set(st)
    assert st["wire"] == "u16" and st["max_live_blocks"] == 2
    assert st["budget_bytes_per_device"] == BUDGET
    assert (st["n_blocks"] - 1) * st["block_rows"] < 3000 <= st["n_blocks"] * st["block_rows"]
    assert st["block_bytes_per_device"] == st["block_rows"] * 7 * 2
    assert st["footprint_bytes"] <= BUDGET
    # one more row a block would not fit (phi's sub-blocks: at most 64 MB
    # of float64 S, the default block_bytes)
    assert st["sub_block_rows"] == st["block_rows"]
    assert port._stream_footprint(st["block_rows"] + 1, 7, 6, 2, (64 << 20) // (7 * 8),
                                  port.gram.H100_SMS) > BUDGET


def test_device_twister_comes_out_of_the_budget(capsys):
    """With phi="device" the f32 twister is part of the footprint when it
    fits in the budget: the blocks get what is left.  When it does not, a
    warning names phi="host" and the blocks get the whole budget."""
    table = table_of("u8", rows=4096, ns=9)
    twister_bytes = 4096 * 8 * 4
    blocks = 32 << 10  # below the wire table's 36,864 bytes: the fit streams
    port.ca_fit_sharded(table, hbm_bytes=twister_bytes + blocks, phi="device", device="cpu")
    st = port.LAST_CA_STREAM
    assert st["n_blocks"] > 1 and st["footprint_bytes"] <= twister_bytes + blocks
    assert "phi='host'" not in capsys.readouterr().err
    port.ca_fit_sharded(table, hbm_bytes=blocks, phi="device", device="cpu")
    st = port.LAST_CA_STREAM
    assert st["n_blocks"] > 1 and st["footprint_bytes"] - twister_bytes <= blocks
    assert "phi='host'" in capsys.readouterr().err


def live_tensor_bytes(dtype: torch.dtype) -> int:
    """Bytes of the distinct storages of live tensors of ``dtype``."""
    storages = {}
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor) and o.dtype == dtype:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def test_streamed_residency_is_bounded():
    """At every retired block, the live wire blocks (u8 tensors) hold at
    most two blocks' bytes, never the table; the probe runs once a block
    in each pass."""
    table = table_of("u8", rows=4096, ns=8, seed=6)
    live, calls = [], [0]

    def probe():
        calls[0] += 1
        live.append(live_tensor_bytes(torch.uint8))

    before = live_tensor_bytes(torch.uint8)
    got = port.ca_fit_sharded(table, hbm_bytes=BUDGET, device="cpu", _stream_probe=probe)
    st = port.LAST_CA_STREAM
    assert st["n_blocks"] >= 4 and calls[0] == 2 * st["n_blocks"]
    assert max(live) - before <= st["max_live_blocks"] * st["block_bytes_per_device"]
    assert max(live) - before < table.size
    assert_ca_equal(got, fit_ca(table.astype(np.float64)))


def test_streamed_device_twister_serves():
    """A full-vocabulary k = 6 table stream-fitted with truncated dims and
    phi="device", its device twister wired into params_around_twister, and
    read sets classified on both routes: the predictions of the host
    float64 chain through fit_ca."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.core.space import Metric
    from kpop_tpu_torch.ops import pipeline as tp

    k, D = 6, 3
    space = KmerSpace("DNA-ds", k)
    NK = space.n_kmers
    rng = np.random.default_rng(11)
    blk = rng.integers(0, 256, size=(NK, 8), dtype=np.uint8)
    table = np.where(blk < 64, blk, 0).astype(np.uint8)
    coords, inertia, tw_dev, _sv = port.ca_fit_sharded(
        table, n_dims=D, hbm_bytes=BUDGET, phi="device", device="cpu")
    assert port.LAST_CA_STREAM is not None and tuple(tw_dev.shape) == (NK, D)
    labels = [space.code_to_hex(c) for c in range(NK)]
    params = tp.params_around_twister(space, labels, tw_dev, inertia, coords)
    assert params.twister.data_ptr() == tw_dev.data_ptr()  # no copy
    B, L = 6, 600
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    c = torch.from_numpy(codes)
    got = {
        "dense": tp.distances_to_classes(params, tp.project(params, tp.count_spectra(params, c))),
        "bag": tp.distances_to_classes(params, tp.project_reads(params, c)),
    }
    full = fit_ca(table.astype(np.float64), n_dims=D)
    metric = Metric.of_string("powers(1,1,2)").compute(full.inertia)
    tw = np.zeros((B, D))
    for b in range(B):
        cs, vs = spectrum_of_sequences(space, ["".join("ACGT"[x] for x in codes[b])])
        tw[b] = (vs / vs.sum()) @ full.twister.T[np.asarray(cs, dtype=np.int64)]
    nc = np.sqrt((full.sample_coords**2 * metric).sum(axis=1))
    nq = np.sqrt((tw**2 * metric).sum(axis=1))
    d2 = (((full.sample_coords / nc[:, None])[None] - (tw / nq[:, None])[:, None]) ** 2
          * metric).sum(axis=2)
    want = np.argmin(d2, axis=1)
    for route, dmat in got.items():
        assert dmat.argmin(dim=1).tolist() == want.tolist(), route
        np.testing.assert_allclose(dmat.numpy(), np.sqrt(d2), rtol=1e-4, atol=1e-5)
