"""kpop_tpu_torch.ops.summaries, the relatedness engine of the port, against
kpop_tpu.ops.summaries (its Pallas route in interpret mode on the CPU) and
the host float64 summarize_rowwise / distance_rowwise.

Bounds: summary lines have identical names and targets, and numbers within
2e-4 * max(1, |x|) (tests/test_device_summaries.py, float32 distances);
distance matrices rtol 2e-5, atol 2e-6 (the same file).  The row digest on
identical rows: median, MAD and top values equal, indices equal in (value,
column) order, mean and std within 1e-6 relative (float32 sums taken in
another order).

The digest kernel (csrc/digest.cu) runs only on the card; its selection is
emulated here in plain torch (order keys, radix ranks in digits of at most
8 bits below the leading bits that a row's extreme keys share, index-order
tie compaction) and held against torch.sort on adversarial rows."""

import io

import numpy as np
import pytest
import torch

import kpop_tpu.ops.summaries as jax_summaries
import kpop_tpu_torch.ops.summaries as ts
from kpop_tpu.core.matrix import NamedMatrix
from kpop_tpu.core.space import Distance, distance_rowwise, summarize_rowwise

BOUND = 2e-4


def make_case(rng, N=20, B=37, D=9):
    targets = NamedMatrix(
        [f"t{i}" for i in range(N)], [f"d{j}" for j in range(D)],
        rng.standard_normal((N, D)),
    )
    queries = NamedMatrix(
        [f"q{i}" for i in range(B)], [f"d{j}" for j in range(D)],
        rng.standard_normal((B, D)),
    )
    metric = rng.random(D)
    metric /= metric.sum()
    return targets, queries, metric


def assert_lines_match(got, want, same_targets=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        pg, pw = g.split("\t"), w.split("\t")
        assert len(pg) == len(pw), (g, w)
        assert pg[0] == pw[0]
        if same_targets:
            assert pg[5::3] == pw[5::3], (g, w)
        for a, b in zip(pg[1:], pw[1:]):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                continue
            assert abs(fa - fb) < BOUND * max(1.0, abs(fb)), (g, w)


def port_summaries(dist, metric, targets, queries, keep, **kw):
    buf = io.StringIO()
    n = ts.summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=keep, normalize=True,
        out=buf, **kw,
    )
    lines = buf.getvalue().splitlines()
    assert n == len(lines) == queries.n_rows
    return lines


def test_constants_equal_jax():
    assert ts.TOPK_SLACK == jax_summaries.TOPK_SLACK
    assert ts.MINK_BUDGET_ELEMS == jax_summaries.MINK_BUDGET_ELEMS


# ---------------- the row digest against _digest_batch ----------------


def digest_rows(N: int) -> np.ndarray:
    """Distance-like rows of length N: continuous values, heavy ties,
    zeros, and zeros of both signs among ties."""
    rng = np.random.default_rng(N)
    signed_zeros = rng.integers(0, 3, N).astype(np.float32)
    signed_zeros[::2] = np.where(signed_zeros[::2] == 0, -0.0, signed_zeros[::2])
    return np.stack([
        np.abs(rng.standard_normal(N)).astype(np.float32),
        rng.integers(0, 3, N).astype(np.float32),
        np.zeros(N, np.float32),
        np.full(N, -0.0, np.float32),
        signed_zeros,
        np.sort(np.abs(rng.standard_normal(N))).astype(np.float32)[::-1].copy(),
    ])


def jax_digest(monkeypatch, rows: np.ndarray, k: int):
    """kpop_tpu's _digest_batch on the given distance rows: its distance
    block is replaced by the rows, so both packages digest the same f32."""
    import jax.numpy as jnp

    B, N = rows.shape
    monkeypatch.setattr(
        jax_summaries, "_distance_block", lambda *args: jnp.asarray(rows)
    )
    jax_summaries._digest_batch.clear_cache()
    try:
        out = jax_summaries._digest_batch(
            np.zeros((N, 1), np.float32), np.zeros((B, 1), np.float32),
            np.ones(1, np.float32), np.ones(N, np.float32),
            kind="euclidean", power=2.0, normalize=False, k_cap=k,
        )
        return [np.asarray(x) for x in out]
    finally:
        jax_summaries._digest_batch.clear_cache()


def value_column_order(top, idx):
    """Each row's (value, column) pairs in (value, column) order."""
    order = np.lexsort((idx, top), axis=1)
    return np.take_along_axis(top, order, 1), np.take_along_axis(idx, order, 1)


def assert_same_top(rows, top_a, idx_a, top_b, idx_b):
    """Equal top values; equal columns in (value, column) order for the
    values below the k-th.  Ties at the k-th value may be other columns of
    that value (either pick is sound: the drain sends a tie group that
    straddles the slack to the host)."""
    np.testing.assert_array_equal(top_a, top_b)
    (ta, ia), (tb, ib) = value_column_order(top_a, idx_a), value_column_order(top_b, idx_b)
    below = ta < ta[:, -1:]
    np.testing.assert_array_equal(np.where(below, ia, -1), np.where(below, ib, -1))
    for idx in (ia, ib):
        np.testing.assert_array_equal(np.take_along_axis(rows, idx, 1), ta)
        assert all(len(set(r)) == len(r) for r in idx.tolist())


@pytest.mark.parametrize("k_kind", ["1", "k_cap", "N"])
@pytest.mark.parametrize("N", [1, 2, 3, 16, 17, 100, 101])
def test_digest_batch_ref_matches_jax(monkeypatch, N, k_kind):
    k = {"1": 1, "k_cap": min(N, 2 + ts.TOPK_SLACK), "N": N}[k_kind]
    rows = digest_rows(N)
    stats_j, top_j, idx_j = jax_digest(monkeypatch, rows, k)
    stats, top, idx = (x.numpy() for x in ts.digest_batch(torch.from_numpy(rows), k))
    assert stats.shape == (len(rows), 4) and top.shape == idx.shape == (len(rows), k)
    np.testing.assert_array_equal(stats[:, 2:], stats_j[:, 2:])  # median, MAD
    np.testing.assert_allclose(stats[:, :2], stats_j[:, :2], rtol=1e-6, atol=0)
    assert_same_top(rows, top, idx, top_j, idx_j.astype(np.int64))
    # the port returns its k smallest in (value, column) order
    np.testing.assert_array_equal((top, idx), value_column_order(top, idx))
    # zeros come out as +0.0, as the host path prints them
    assert not np.signbit(stats[:, 2:][stats[:, 2:] == 0]).any()
    assert not np.signbit(top[top == 0]).any()


def test_digest_batch_checks_its_arguments():
    dmat = torch.rand(3, 5)
    for k in (0, 6):
        with pytest.raises(ValueError):
            ts.digest_batch(dmat, k)
    with pytest.raises(ValueError):
        ts.digest_batch(torch.rand(5), 1)
    # a tensor off the CPU never takes the plain version: it launches the
    # kernel, or raises where it cannot
    with pytest.raises(ValueError, match="CUDA"):
        ts.digest_batch(torch.empty((3, 5), device="meta"), 2)


# ---------------- emulation of csrc/digest.cu's selection ----------------

THREADS = ts.DIGEST_THREADS
U32 = 0xFFFFFFFF
SIGN = 0x80000000


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order_key: f32 -> u32 (held in int64)."""
    u = x.view(torch.int32).to(torch.int64) & U32
    u = torch.where(u == SIGN, 0, u)  # -0.0 is +0.0
    key = torch.where((u & SIGN) != 0, ~u & U32, u | SIGN)
    return torch.where(torch.isnan(x), U32, key)


def key_value(key: torch.Tensor) -> torch.Tensor:
    u = torch.where((key & SIGN) != 0, key & 0x7FFFFFFF, ~key & U32)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def radix_select(keys: torch.Tensor, rank: int, lo: int, hi: int):
    """The kernel's radix_select: (key of rank `rank`, keys below it).
    Every key lies in [lo, hi]; the leading bits the two share are skipped
    and the bits below them taken in digits of at most 8, from the top."""
    assert lo <= int(keys.min()) and int(keys.max()) <= hi
    low = (lo ^ hi).bit_length()
    mask = U32 & ~((1 << low) - 1)
    prefix = lo & mask
    r = rank
    while low > 0:
        bits = min(8, low)
        low -= bits
        digit = (1 << bits) - 1
        cand = keys[(keys & mask) == prefix]
        hist = torch.bincount((cand >> low) & digit, minlength=256)
        cum = torch.cumsum(hist, 0)
        below = cum - hist
        hits = ((below <= r) & (r < cum)).nonzero().flatten()
        assert len(hits) == 1
        b = int(hits[0])
        prefix |= b << low
        mask |= digit << low
        r -= int(below[b])
    return prefix, rank - r


def emulate_digest(row: torch.Tensor, k: int):
    """Median, MAD, and the k smallest (value, column) lists of one row,
    selected as csrc/digest.cu selects them, then stably sorted by value."""
    N = row.shape[0]
    keys = order_key(row)
    lo, hi = int(keys.min()), int(keys.max())
    median = key_value(torch.tensor(radix_select(keys, N // 2, lo, hi)[0]))
    extremes = key_value(torch.tensor([lo, hi]))
    mad_hi = int(order_key((extremes - median).abs()).max())
    mad_key, _ = radix_select(order_key((row - median).abs()), N // 2, SIGN, mad_hi)
    kth, below = radix_select(keys, k - 1, lo, hi)
    ties = k - below
    top = torch.empty(k, dtype=torch.float32)
    idx = torch.full((k,), -1, dtype=torch.int64)
    n_lt = n_eq = 0
    for i0 in range(0, N, THREADS):
        if not (n_lt < below or n_eq < ties):
            break
        kk = keys[i0 : i0 + THREADS]
        lt, eq = kk < kth, kk == kth
        pos_lt = torch.cumsum(lt.long(), 0) - lt.long()
        pos_eq = torch.cumsum(eq.long(), 0) - eq.long()
        for j in range(len(kk)):
            slot = -1
            if lt[j]:
                slot = n_lt + int(pos_lt[j])
            elif eq[j] and n_eq + int(pos_eq[j]) < ties:
                slot = below + n_eq + int(pos_eq[j])
            if slot >= 0:
                assert idx[slot] == -1
                top[slot] = key_value(kk[j])
                idx[slot] = i0 + j
        n_lt += int(lt.sum())
        n_eq += int(eq.sum())
    assert (idx >= 0).all()
    top, order = torch.sort(top, stable=True)
    return median, key_value(torch.tensor(mad_key)), top, idx[order]


def adversarial_rows():
    rng = np.random.default_rng(11)
    dup = rng.integers(0, 4, 1200).astype(np.float32)
    signed = np.where(rng.random(1100) < 0.5, 0.0, -0.0).astype(np.float32)
    signed[::7] = 1.5
    mixed = rng.standard_normal(1500).astype(np.float32)  # negative keys too
    mixed[::50] = np.inf
    return {
        "one": np.array([3.25], np.float32),
        "one_negzero": np.array([-0.0], np.float32),
        "all_equal": np.full(1030, 7.0, np.float32),
        "plus_minus_zero": signed,
        "duplicates": dup,
        "mixed_sign_inf": mixed,
        "ascending": np.arange(600, dtype=np.float32),
    }


@pytest.mark.parametrize("name", sorted(adversarial_rows()))
def test_emulated_kernel_selection_matches_sort(name):
    row = torch.from_numpy(adversarial_rows()[name])
    N = row.shape[0]
    srt, order = torch.sort(row + 0.0, stable=True)
    stats_ref, top_ref, idx_ref = ts.digest_batch_ref(row[None, :], N)
    for k in sorted({1, min(N, 16), (N + 1) // 2, N}):
        median, mad, top, idx = emulate_digest(row, k)
        assert torch.equal(median, srt[N // 2])
        assert torch.equal(mad, stats_ref[0, 3])
        assert torch.equal(top, srt[:k]) and torch.equal(idx, order[:k])
        assert not torch.signbit(top[top == 0]).any()
    assert torch.equal(top_ref[0], srt) and torch.equal(idx_ref[0], order)


def test_order_key_is_monotone_and_inverts():
    vals = torch.tensor(
        [-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-45, 1e-30, 2.0, np.inf], dtype=torch.float32
    )
    keys = order_key(vals)
    assert (keys[1:] >= keys[:-1]).all()
    assert keys[3] == keys[4]  # -0.0 and +0.0
    back = key_value(keys)
    assert torch.equal(back, vals) and not torch.signbit(back[3])
    assert int(order_key(torch.tensor([float("nan")]))[0]) == U32


# ---------------- the engine against kpop_tpu and the host ----------------


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("keep", [2, 5, None])
@pytest.mark.parametrize("spec", ["euclidean", "cosine", "minkowski(3)"])
def test_summaries_match_jax_and_host(spec, keep, backend):
    rng = np.random.default_rng(0)
    targets, queries, metric = make_case(rng, N=20, B=23, D=9)
    dist = Distance.of_string(spec)
    host = summarize_rowwise(dist, metric, targets, queries, keep_at_most=keep)
    buf = io.StringIO()
    jax_summaries.summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=keep, normalize=True,
        out=buf, batch=8, backend=backend,
    )
    jax_lines = buf.getvalue().splitlines()
    got = port_summaries(dist, metric, targets, queries, keep, batch=8, backend=backend)
    assert_lines_match(got, host)
    assert_lines_match(got, jax_lines)


def test_summaries_unnormalized_match_host():
    rng = np.random.default_rng(6)
    targets, queries, metric = make_case(rng, N=12, B=10, D=5)
    dist = Distance.of_string("euclidean")
    host = summarize_rowwise(dist, metric, targets, queries, 3, normalize=False)
    for backend in ("jax", "pallas"):
        buf = io.StringIO()
        ts.summarize_rowwise_device(
            dist, metric, targets, queries, keep_at_most=3, normalize=False,
            out=buf, batch=4, backend=backend,
        )
        assert_lines_match(buf.getvalue().splitlines(), host)


def test_summaries_self_distances_print_as_host():
    """Queries that are the targets themselves (kpop-twistdb -s on one set),
    in exact binary arithmetic, give exact zero distances: the lines must
    print them as the host does ("0", never "-0")."""
    rng = np.random.default_rng(7)
    data = rng.integers(-2, 3, (9, 4)).astype(np.float64)
    data[3] = 0.0  # a zero row: every distance to it is its partner's norm
    targets = NamedMatrix([f"t{i}" for i in range(9)], [f"d{j}" for j in range(4)], data)
    metric = np.full(4, 0.25)
    dist = Distance.of_string("euclidean")
    host = summarize_rowwise(dist, metric, targets, targets, 2, normalize=False)
    for backend in ("jax", "pallas"):
        buf = io.StringIO()
        ts.summarize_rowwise_device(
            dist, metric, targets, targets, keep_at_most=2, normalize=False,
            out=buf, batch=4, backend=backend,
        )
        got = buf.getvalue().splitlines()
        assert_lines_match(got, host)
        for g, h in zip(got, host):
            assert g.split("\t")[6] == h.split("\t")[6] == "0"


def test_tie_group_fallback():
    """A tie group larger than the slack is written from the host float64
    row, exactly as the host path lists it."""
    rng = np.random.default_rng(1)
    D = 4
    base = rng.standard_normal((1, D))
    data = np.concatenate([np.repeat(base, 17, axis=0), rng.standard_normal((3, D))])
    targets = NamedMatrix([f"t{i}" for i in range(20)], [f"d{j}" for j in range(D)], data)
    # the 17 equal targets are the nearest: a tie group beyond 2 + slack
    queries = NamedMatrix(["q0"], [f"d{j}" for j in range(D)], base + 0.01)
    metric = np.full(D, 0.25)
    dist = Distance.of_string("euclidean")
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=2)
    got = port_summaries(dist, metric, targets, queries, 2)
    assert_lines_match(got, want)
    assert len(got[0].split("\t")) == len(want[0].split("\t")) == 5 + 3 * 17


@pytest.mark.parametrize("native_fmt", [True, False])
def test_fallback_interleave_with_vertical_tab_names(monkeypatch, native_fmt):
    """Fallback rows interleave with formatted rows in order, even when
    names hold characters that str.splitlines takes as line ends."""
    if native_fmt and not ts._native_formatter():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(ts, "_native_formatter", lambda: native_fmt)
    rng = np.random.default_rng(9)
    D = 4
    base = rng.standard_normal((1, D))
    data = np.concatenate([np.repeat(base, 17, axis=0), rng.standard_normal((3, D))])
    targets = NamedMatrix(["t\x0b%d" % i for i in range(20)], [f"d{j}" for j in range(D)], data)
    qdata = np.concatenate([base + 0.01, rng.standard_normal((2, D)), base + 0.01])
    queries = NamedMatrix(["q\x0b%d" % i for i in range(4)], [f"d{j}" for j in range(D)], qdata)
    metric = np.full(D, 0.25)
    dist = Distance.of_string("euclidean")
    buf = io.StringIO()
    n = ts.summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=2, normalize=True, out=buf, batch=4,
    )
    lines = buf.getvalue().split("\n")[:-1]
    assert n == len(lines) == 4
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=2)
    for i, (g, w) in enumerate(zip(lines, want)):
        assert g.split("\t")[0] == "q\x0b%d" % i
        assert g.split("\t")[5::3] == w.split("\t")[5::3]


def test_native_formatter_byte_identical(monkeypatch):
    """The C formatter and the Python %-formatting write the same bytes,
    with tie groups, zero-variance rows (nan/inf z) and non-ASCII names."""
    if not ts._native_formatter():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    D = 6
    data = rng.standard_normal((30, D))
    data[10:15] = data[10]
    targets = NamedMatrix(["té%d" % i for i in range(30)], [f"d{j}" for j in range(D)], data)
    qdata = np.concatenate([rng.standard_normal((6, D)), data[10:11]])
    queries = NamedMatrix(["qø%d" % i for i in range(7)], [f"d{j}" for j in range(D)], qdata)
    flat = NamedMatrix(["t0", "t1"], [f"d{j}" for j in range(D)], np.zeros((2, D)))
    one = NamedMatrix(["q0"], [f"d{j}" for j in range(D)], np.ones((1, D)))
    metric = np.full(D, 1.0 / D)
    dist = Distance.of_string("euclidean")

    def run(t, q):
        buf = io.StringIO()
        ts.summarize_rowwise_device(
            dist, metric, t, q, keep_at_most=3, normalize=True, out=buf, batch=4,
        )
        return buf.getvalue()

    native_out = (run(targets, queries), run(flat, one))
    monkeypatch.setattr(ts, "_native_formatter", lambda: False)
    assert (run(targets, queries), run(flat, one)) == native_out


def test_minkowski_blocked_broadcast_matches(monkeypatch):
    """A tiny element budget (several chunks and a ragged tail) changes no
    output line."""
    rng = np.random.default_rng(3)
    targets, queries, metric = make_case(rng, N=23, B=9, D=7)
    dist = Distance.of_string("minkowski(3)")
    full = port_summaries(dist, metric, targets, queries, 3, batch=16)
    # 9 queries x 7 dims -> 256 // 63 = 4 targets per chunk (6 chunks)
    monkeypatch.setattr(ts, "MINK_BUDGET_ELEMS", 256)
    assert port_summaries(dist, metric, targets, queries, 3, batch=16) == full
    want = summarize_rowwise(dist, metric, targets, queries, 3)
    assert_lines_match(full, want)


@pytest.mark.parametrize("spec", ["euclidean", "cosine"])
@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("normalize", [True, False])
def test_distance_rowwise_matches_jax_and_host(spec, backend, normalize):
    rng = np.random.default_rng(4)
    targets, queries, metric = make_case(rng, N=13, B=29, D=6)
    dist = Distance.of_string(spec)
    want = distance_rowwise(dist, metric, targets, queries, normalize=normalize)
    jax_got = jax_summaries.distance_rowwise_device(
        dist, metric, targets, queries, normalize=normalize, backend=backend, batch=11,
    )
    got = ts.distance_rowwise_device(
        dist, metric, targets, queries, normalize=normalize, backend=backend, batch=11,
    )
    assert got.row_names == want.row_names and got.col_names == want.col_names
    assert got.data.dtype == np.float64
    np.testing.assert_allclose(got.data, want.data, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got.data, np.asarray(jax_got.data), rtol=2e-5, atol=2e-6)


def test_distance_rowwise_minkowski_chunks(monkeypatch):
    rng = np.random.default_rng(8)
    targets, queries, metric = make_case(rng, N=19, B=5, D=4)
    dist = Distance.of_string("minkowski(1.5)")
    full = ts.distance_rowwise_device(dist, metric, targets, queries, batch=3).data
    monkeypatch.setattr(ts, "MINK_BUDGET_ELEMS", 40)  # 3 x 4 -> 3 targets per chunk
    np.testing.assert_array_equal(
        ts.distance_rowwise_device(dist, metric, targets, queries, batch=3).data, full
    )
    want = distance_rowwise(dist, metric, targets, queries).data
    np.testing.assert_allclose(full, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("order", ["C", "F"])
def test_batches_are_copied_contiguous(order):
    """Each block goes to the device in a C-ordered buffer of its own, so
    the distance tile gets contiguous rows that start aligned whatever the
    width, also from a transposed matrix (kpop-countdb's spectra)."""
    rows = np.asarray(np.arange(3 * 511, dtype=np.float64).reshape(3, 511), order=order)
    t = ts._to_device(rows[1:], torch.device("cpu"))
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert t.data_ptr() % 16 == 0
    assert np.array_equal(t.numpy(), rows[1:].astype(np.float32))
