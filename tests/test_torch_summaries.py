"""kpop_tpu_torch.ops.summaries, the relatedness engine of the port, against
kpop_tpu.ops.summaries (its Pallas route in interpret mode on the CPU) and
the host float64 summarize_rowwise / distance_rowwise.

Bounds: summary lines have identical names and targets, and numbers within
2e-4 * max(1, |x|) (tests/test_device_summaries.py, float32 distances);
distance matrices rtol 2e-5, atol 2e-6 (the same file).  The row digest on
identical rows: median, MAD and top values equal, indices equal in (value,
column) order, mean and std within 1e-6 relative (float32 sums taken in
another order).

The digest kernel (csrc/digest.cu) runs only on the card; its plan is
emulated here in plain torch: the row staged in shared memory (head, bulk
body, tail) and turned into order keys, radix ranks in digits of at most 8
bits below the leading bits that a row's extreme keys share (histogram
copies summed and scanned by one warp, 8 bins a lane), and the k smallest
listed by warp chunks, then ordered by (value, column) in the kernel for
k <= DIGEST_K_MAX or by a stable sort above it.  The emulation is held
against torch.sort on adversarial rows and against the JAX _digest_batch
on rows with ties, zeros of both signs and NaN."""

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


# ---------------- emulation of csrc/digest.cu ----------------

# threads of a staged-row block and of a streamed-row block, and the
# histogram copies a selection (csrc/digest.cu's THREADS, WIDE_THREADS,
# COPIES)
STAGED_THREADS, THREADS, COPIES = 256, ts.DIGEST_THREADS, 1
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


def stage_row(row: torch.Tensor, offset: int) -> torch.Tensor:
    """The staged kernel's copy of a row that starts ``offset`` floats past
    a 16-byte boundary: the head entries up to the boundary and the tail
    by plain loads, the 16-byte body by one bulk copy into keys + head,
    which lies on 16 bytes; then the keys made in place."""
    N = row.shape[0]
    head = min(N, (4 - offset) % 4)
    body = (N - head) & ~3
    pad = (4 - head) % 4
    smem = torch.full((N + 3,), -1, dtype=torch.int64)
    keys = smem[pad:]
    assert (pad + head) % 4 == 0  # keys + head on 16 bytes
    bits = row.view(torch.int32).to(torch.int64) & U32
    keys[head : head + body] = bits[head : head + body]  # the bulk copy
    for t in range(N - body):  # the threads below N - body
        i = t if t < head else body + t
        keys[i] = bits[i]
    return order_key(keys[:N].to(torch.int32).view(torch.float32))


def radix_select(keys: torch.Tensor, rank: int, lo: int, hi: int, nt: int = STAGED_THREADS):
    """The kernel's radix_select: (key of rank `rank`, keys below it).
    Every key lies in [lo, hi]; the leading bits the two share are skipped
    and the bits below them taken in digits of at most 8, from the top.
    Entries are counted into COPIES copies by the lane that reads them (here
    lane i % 32 of thread i % nt); one warp sums the copies and scans the
    bins, 8 a lane."""
    assert lo <= int(keys.min()) and int(keys.max()) <= hi
    copy = torch.arange(len(keys)) % nt % 32 % COPIES
    low = (lo ^ hi).bit_length()
    mask = U32 & ~((1 << low) - 1)
    prefix = lo & mask
    r = rank
    while low > 0:
        bits = min(8, low)
        low -= bits
        digit = (1 << bits) - 1
        cand = (keys & mask) == prefix
        hist = torch.zeros((COPIES, 256), dtype=torch.int64)
        hist.index_put_((copy[cand], (keys[cand] >> low) & digit), torch.ones(int(cand.sum()), dtype=torch.int64), accumulate=True)
        lanes = hist.sum(dim=0).view(32, 8)  # lane l holds bins 8l..8l+7
        t = lanes.sum(dim=1)
        below = torch.cumsum(t, 0) - t
        lane = ((below <= r) & (r < below + t)).nonzero().flatten()
        assert len(lane) == 1
        acc = int(below[lane[0]])
        for j in range(8):
            if r < acc + int(lanes[lane[0], j]):
                b = int(lane[0]) * 8 + j
                break
            acc += int(lanes[lane[0], j])
        prefix |= b << low
        mask |= digit << low
        r -= acc
    return prefix, rank - r


def compact(keys: torch.Tensor, kth: int, n_under: int, k: int, nt: int):
    """The kernel's compaction: each warp a contiguous chunk, ballot counts,
    the warp offsets, then a ballot pass handing out slots.  Returns the
    slot -> (key, column) list of k entries."""
    N = keys.shape[0]
    warps = nt // 32
    ties = k - n_under
    chunk = ((N + warps - 1) // warps + 31) & ~31
    lt, eq = keys < kth, keys == kth
    bounds = [(w * chunk, min(N, w * chunk + chunk)) for w in range(warps)]
    warp_lt = [int(lt[a:b].sum()) if a < b else 0 for a, b in bounds]
    warp_eq = [int(eq[a:b].sum()) if a < b else 0 for a, b in bounds]
    slot_key = torch.full((k,), -1, dtype=torch.int64)
    slot_col = torch.full((k,), -1, dtype=torch.int64)
    for w, (a, b) in enumerate(bounds):
        n_lt, n_eq = sum(warp_lt[:w]), sum(warp_eq[:w])
        for base in range(a, b, 32):
            if not (n_lt < n_under or n_eq < ties):
                break
            sl = slice(base, min(b, base + 32))
            m_lt, m_eq = lt[sl], eq[sl]
            pos_lt = torch.cumsum(m_lt.long(), 0) - m_lt.long()
            pos_eq = torch.cumsum(m_eq.long(), 0) - m_eq.long()
            for j in range(sl.stop - sl.start):
                slot = -1
                if m_lt[j]:
                    slot = n_lt + int(pos_lt[j])
                elif m_eq[j] and n_eq + int(pos_eq[j]) < ties:
                    slot = n_under + n_eq + int(pos_eq[j])
                if slot >= 0:
                    assert slot_col[slot] == -1
                    slot_key[slot], slot_col[slot] = keys[base + j], base + j
            n_lt += int(m_lt.sum())
            n_eq += int(m_eq.sum())
    assert (slot_col >= 0).all()
    return slot_key, slot_col


def compact_small(keys: torch.Tensor, kth: int, n_under: int, k: int, nt: int, head: int,
                  seed: int = 0):
    """The kernel's one-pass compaction for k <= DIGEST_K_MAX: the entries
    below kth take slots from a shared counter (in any order: shuffled
    here); each warp keeps the first ties of its columns (a run of quads
    of 4 entries from ``head`` on, warp 0 also the head entries before
    them, the last warp also the tail after them), and the lowest columns
    of those fill the slots from n_under on."""
    N = keys.shape[0]
    warps = nt // 32
    ties = k - n_under
    quads = (N - head) // 4
    per_warp = ((quads + warps - 1) // warps + 31) & ~31
    lt = torch.nonzero(keys < kth).flatten()
    assert len(lt) == n_under
    lt = lt[torch.randperm(len(lt), generator=torch.Generator().manual_seed(seed))]
    eq = []
    for w in range(warps):
        lo = head + 4 * min(quads, w * per_warp)
        hi = head + 4 * min(quads, (w + 1) * per_warp)
        cols = list(range(lo, hi))
        if w == 0:
            cols = list(range(head)) + cols
        if w == warps - 1:
            cols += list(range(head + 4 * quads, N))
        cols = torch.tensor(cols, dtype=torch.int64)
        eq.extend(cols[keys[cols] == kth][:ties].tolist())
    assert eq == sorted(eq)
    slot_col = torch.cat([lt, torch.tensor(eq[:ties], dtype=torch.int64)])
    return keys[slot_col], slot_col


def emulate_digest(row: torch.Tensor, k: int, nt: int = STAGED_THREADS, offset: int = 0):
    """Median, MAD, and the k smallest (value, column) lists of one row, as
    csrc/digest.cu computes them: for k <= DIGEST_K_MAX one warp ranks the
    list by (key, column); above it the wrapper's stable sort by value."""
    N = row.shape[0]
    keys = stage_row(row, offset) if nt == STAGED_THREADS else order_key(row)
    assert torch.equal(keys, order_key(row))
    lo, hi = int(keys.min()), int(keys.max())
    (med_key, _), (kth, below) = (radix_select(keys, r, lo, hi, nt) for r in (N // 2, k - 1))
    median = key_value(torch.tensor(med_key))
    dev_key = lambda v: int(order_key((v - median).abs()))  # noqa: E731
    spread = max(dev_key(key_value(torch.tensor(hi))), dev_key(key_value(torch.tensor(lo))))
    mad_key, _ = radix_select(order_key((key_value(keys) - median).abs()), N // 2, SIGN, spread, nt)
    mad = key_value(torch.tensor(U32 if hi == U32 else mad_key))  # a NaN in the row: NaN
    if k <= ts.DIGEST_K_MAX:
        head = min(N, (4 - offset) % 4) if nt == STAGED_THREADS else 0
        slot_key, slot_col = compact_small(keys, kth, below, k, nt, head, seed=k)
        rank = torch.tensor([
            int(((slot_key < slot_key[i]) | ((slot_key == slot_key[i]) & (slot_col < slot_col[i]))).sum())
            for i in range(k)
        ], dtype=torch.int64)
        assert sorted(rank.tolist()) == list(range(k))
        top_key = torch.empty(k, dtype=torch.int64)
        idx = torch.empty(k, dtype=torch.int64)
        top_key[rank], idx[rank] = slot_key, slot_col
        top = key_value(top_key)
    else:
        slot_key, slot_col = compact(keys, kth, below, k, nt)
        top, order = torch.sort(key_value(slot_key), stable=True)
        idx = slot_col[order]
    return median, mad, top, idx


def adversarial_rows():
    rng = np.random.default_rng(11)
    dup = rng.integers(0, 4, 1200).astype(np.float32)
    signed = np.where(rng.random(1100) < 0.5, 0.0, -0.0).astype(np.float32)
    signed[::7] = 1.5
    mixed = rng.standard_normal(1500).astype(np.float32)  # negative keys too
    mixed[::50] = np.inf
    nan = np.abs(rng.standard_normal(700)).astype(np.float32)
    nan[::9] = np.nan
    nan[::13] = 0.0
    return {
        "one": np.array([3.25], np.float32),
        "one_negzero": np.array([-0.0], np.float32),
        "all_equal": np.full(1030, 7.0, np.float32),
        "plus_minus_zero": signed,
        "duplicates": dup,
        "mixed_sign_inf": mixed,
        "ascending": np.arange(600, dtype=np.float32),
        "nan": nan,
    }


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN equal to NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("name", sorted(adversarial_rows()))
def test_emulated_kernel_selection_matches_sort(name):
    row = torch.from_numpy(adversarial_rows()[name])
    N = row.shape[0]
    srt, order = torch.sort(row + 0.0, stable=True)
    stats_ref, top_ref, idx_ref = ts.digest_batch_ref(row[None, :], N)
    ks = {1, min(N, 16), min(N, ts.DIGEST_K_MAX), min(N, ts.DIGEST_K_MAX + 1), (N + 1) // 2, N}
    for k in sorted(ks):
        for nt, offset in ((STAGED_THREADS, k % 4), (THREADS, 0)):
            median, mad, top, idx = emulate_digest(row, k, nt, offset)
            assert same(median, srt[N // 2]) and same(mad, stats_ref[0, 3])
            assert same(top, srt[:k]) and torch.equal(idx, order[:k])
            assert not torch.signbit(top[top == 0]).any()
    assert same(top_ref[0], srt) and torch.equal(idx_ref[0], order)


def jax_rows(N: int) -> np.ndarray:
    """Rows for the JAX comparison: digest_rows plus a row with NaN."""
    rows = digest_rows(N)
    nan = np.abs(np.random.default_rng(N + 1).standard_normal(N)).astype(np.float32)
    nan[1::5] = np.nan
    return np.concatenate([rows, nan[None, :]])


@pytest.mark.parametrize("k_kind", ["1", "16", "K_MAX", "K_MAX+1", "N"])
def test_emulated_kernel_matches_jax(monkeypatch, k_kind):
    """The emulated kernel against kpop_tpu's _digest_batch on rows with
    ties, zeros of both signs and NaN, on both sides of DIGEST_K_MAX."""
    N = 97
    k = {"1": 1, "16": 16, "K_MAX": ts.DIGEST_K_MAX, "K_MAX+1": ts.DIGEST_K_MAX + 1, "N": N}[k_kind]
    rows = jax_rows(N)
    stats_j, top_j, idx_j = jax_digest(monkeypatch, rows, k)
    tops, idxs = [], []
    for j, row in enumerate(torch.from_numpy(rows)):
        median, mad, top, idx = emulate_digest(row, k, offset=j % 4)
        np.testing.assert_array_equal(np.array([median, mad]), stats_j[j, 2:])
        tops.append(top.numpy())
        idxs.append(idx.numpy())
    top, idx = np.stack(tops), np.stack(idxs)
    assert_same_top(rows, top, idx, top_j, idx_j.astype(np.int64))
    np.testing.assert_array_equal((top, idx), value_column_order(top, idx))
    assert not np.signbit(top[top == 0]).any()


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
