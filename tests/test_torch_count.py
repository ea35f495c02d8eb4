"""The k-mer count kernel of kpop_tpu_torch (csrc/count_spectra.cu),
emulated on the CPU step by step, against the plain version
count_spectra_ref and the JAX package's count_spectra.

The kernel runs only on the card.  Its plans are emulated here: each
thread looks up COUNT_RUN consecutive windows with a rolling forward and
reverse-complement code, and each block appends its kept windows' indices
to the read set's row of the scratch, blocks in any order.  In the
bucketed plan the kept indices are then counted by slice (a histogram over
tiles), scanned into each read set's bucket offsets, and scattered tile by
tile, each tile sorted by slice and each slice's run placed at an offset
claimed in any order, into a second row; every kept index must land in
exactly one bucket, of its own slice.  Then one wave of blocks takes the
(vocabulary slice, read set) tasks from a queue in count_tasks' order (the
large buckets first, each group in any order), reads the task's bucket (or
the whole kept row in the read-all plan) by 16-byte loads, merges each
thread's runs of equal indices, adds each run to u16 (two a 32-bit word)
or u32 counters as count_plan chooses by the windows a read set, and
writes the slice whole by counter quads.  The emulation checks that a
bucketed task reads only its bucket, that no u16 cell carries into its
neighbour and that every output cell is written exactly once.  Both plans
are emulated on every input, whichever count_plan picks.

Tolerance: none.  Counts are integers, so the spectra are held equal
(np.array_equal) to the plain version and to JAX."""

import numpy as np
import pytest
import torch

from kpop_tpu.ops import pipeline as jp
from kpop_tpu_torch.ops import pipeline as tp

MISS = 0xFFFFFFFF


def make_params(seed, k, V, base=4, canonical=True, d=3):
    """Torch and JAX parameters of a random vocabulary of V k-mers; the
    all-zero k-mer maps to row V - 1."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = base**k
    perm = rng.permutation(n)
    perm = np.concatenate([perm[perm != 0][: V - 1], [0]])
    lut = np.full(n + 1, V, dtype=np.int32)
    lut[perm] = np.arange(V, dtype=np.int32)
    arrays = dict(
        vocab_lut=lut,
        twister=rng.standard_normal((V, d)).astype(np.float32),
        metric=np.full(d, 1.0 / d, dtype=np.float32),
        class_coords=rng.standard_normal((2, d)).astype(np.float32),
        class_norms=np.ones(2, dtype=np.float32),
    )
    tparams = tp.ClassifierParams(
        *(torch.from_numpy(a) for a in arrays.values()), k=k, canonical=canonical, base=base
    )
    jparams = jp.ClassifierParams(
        **{name: jnp.asarray(a) for name, a in arrays.items()}, k=k, canonical=canonical,
        base=base,
    )
    return tparams, jparams


def emulate_lookup(params, codes: np.ndarray, seed: int = 0, row0: int = 0, n_rows=None):
    """count_lookup: each thread's COUNT_RUN windows from one rolling code
    (numpy, all threads at once); each block of 256 threads appends the
    indices of its known windows in the row range ``[row0, row0 + n_rows)``
    (the whole vocabulary by default), less row0, in window order, at a
    place its one atomic on the read set's count claims, so blocks land in
    any order (``seed`` shuffles them), and adds its known windows, in the
    range or not, to the read set's known count.  Returns the ``[B, Wp]``
    u32 scratch, whose entries past each read set's count are left as they
    were (garbage here), the counts and the known counts."""
    rng = np.random.default_rng(seed)
    k, base, canonical = params.k, params.base, params.canonical
    lut = params.vocab_lut.numpy().astype(np.int64)
    V = params.n_vocab
    n_rows = V - row0 if n_rows is None else n_rows
    B, L = codes.shape
    W = L - k + 1
    Wp = -(-W // tp.COUNT_RUN) * tp.COUNT_RUN
    w0 = np.arange(0, Wp, tp.COUNT_RUN)
    top = base ** (k - 1)
    fwd = np.zeros((B, len(w0)), np.int64)
    rc = np.zeros_like(fwd)
    last_bad = np.broadcast_to(w0 - 1, fwd.shape).copy()
    rows = np.full((B, Wp), MISS, dtype=np.uint32)

    def push(j):
        nonlocal fwd, rc
        c = np.where(j < L, codes[:, np.minimum(j, L - 1)].astype(np.int64), -1)
        bad = (c < 0) | (c >= base)
        last_bad[...] = np.where(bad, j, last_bad)
        c = np.where(bad, 0, c)
        fwd = (fwd % top) * base + c
        rc = (rc >> 2) + (3 - c) * top

    for j in range(k - 1):
        push(w0 + j)
    for r in range(tp.COUNT_RUN):
        w = w0 + r
        push(w + k - 1)
        valid = (w < W) & (last_bad < w)
        code = np.minimum(fwd, rc) if canonical else fwd
        x = lut[np.where(valid, code, 0)]
        rows[:, w] = np.where(valid & (x >= 0) & (x < V), x, MISS).astype(np.uint32)
    block = 256 * tp.COUNT_RUN  # windows a block looks up
    out = rng.integers(0, 2**32, size=(B, Wp), dtype=np.uint64).astype(np.uint32)
    n = np.zeros(B, dtype=np.int64)
    n_known = np.zeros(B, dtype=np.int64)
    for b in range(B):
        parts = [p[p != MISS] for p in np.split(rows[b], range(block, Wp, block))]
        n_known[b] = sum(len(p) for p in parts)
        # the range test as the kernel makes it: (u32)(x - row0) < rows
        parts = [(p.astype(np.int64) - row0)[((p.astype(np.int64) - row0) & 0xFFFFFFFF) < n_rows]
                 for p in parts]
        kept = np.concatenate([parts[i] for i in rng.permutation(len(parts))])
        n[b] = len(kept)
        out[b, : n[b]] = kept.astype(np.uint32)
    return out, n, n_known


#: kept indices a histogram block and a scatter block of the bucketed plan
#: take (csrc/count_spectra.cu's HIST_TILE and SCATTER_TILE)
HIST_TILE, SCATTER_TILE = 16 * 512 * tp.COUNT_RUN, 512 * 16


def emulate_bucket(idx: np.ndarray, n_idx: np.ndarray, cells: int, S: int, seed: int = 0,
                   hist_tile: int = HIST_TILE, tile: int = SCATTER_TILE):
    """The bucketed plan's histogram, scan and scatter: each read set's kept
    indices counted by slice tile by tile, its buckets' offsets by an
    exclusive scan, then each tile (in any order: ``seed``) sorted by slice,
    each slice's run in any order, placed at the bucket's next free place.
    Returns the bucketed ``[B, Wp]`` rows (garbage past each read set's
    count) and each bucket's ``[B, S]`` start and end."""
    rng = np.random.default_rng(seed)
    B, Wp = idx.shape
    counts = np.zeros((B, S), dtype=np.int64)
    for b in range(B):
        for t0 in range(0, n_idx[b], hist_tile):
            counts[b] += np.bincount(idx[b, t0: min(n_idx[b], t0 + hist_tile)] // cells,
                                     minlength=S)
    start = np.cumsum(counts, axis=1) - counts
    end = start.copy()
    bkt = rng.integers(0, 2**32, size=(B, Wp), dtype=np.uint64).astype(np.uint32)
    for b in range(B):
        for t0 in rng.permutation(np.arange(0, n_idx[b], tile)):
            vals = idx[b, t0: min(n_idx[b], t0 + tile)]
            for s in np.unique(vals // cells):
                run = rng.permutation(vals[vals // cells == s])
                bkt[b, end[b, s]: end[b, s] + len(run)] = run
                end[b, s] += len(run)
    assert np.array_equal(end, start + counts)
    for b in range(B):
        assert start[b, 0] == 0 and end[b, -1] == n_idx[b]
        assert np.array_equal(start[b, 1:], end[b, :-1])
        kept = bkt[b, : n_idx[b]]
        # every kept index in exactly one bucket, of its own slice
        assert np.array_equal(np.sort(kept), np.sort(idx[b, : n_idx[b]]))
        assert np.array_equal(kept // cells, np.repeat(np.arange(S), counts[b]))
    return bkt, start, end


def queue_order(B: int, S: int, sizes, seed: int) -> list[int]:
    """count_tasks' order with each of its groups (large buckets, the rest)
    shuffled, as the scan's atomics queue them."""
    order = tp.count_tasks(B, S, sizes)
    if sizes is None:
        return order
    rng = np.random.default_rng(seed)
    n = np.asarray(sizes).sum(axis=1)
    big = sum(sizes[t % B][t // B] * S > 2 * n[t % B] for t in order)
    return list(rng.permutation(order[:big])) + list(rng.permutation(order[big:]))


def emulate_slices(idx: np.ndarray, n_idx: np.ndarray, V: int, W: int, bucket: bool,
                   seed: int = 0):
    """count_slices in either plan: the ``[B, V]`` f32 spectra, and the most
    atomics one counter of each read set took.  The (slice, read set)
    tasks are taken in the queue's order; a task reads its indices (the
    bucket, or the read set's first n_idx[b]) by 16-byte loads from their
    first position rounded down to 4, the rest masked, each thread merging
    equal neighbours of its COUNT_RUN before one atomic, into counters
    shifted by the slice's place within its 16-byte line of the output;
    then every counter quad is read, zeroed and stored."""
    bits, cells, S, _ = tp.count_plan(W, V)
    B, Wp = idx.shape
    if bucket:
        rows, start, end = emulate_bucket(idx, n_idx, cells, S, seed)
        order = queue_order(B, S, (end - start).tolist(), seed)
    else:
        rows, start, end = idx, np.zeros((B, S), np.int64), np.repeat(n_idx[:, None], S, axis=1)
        order = queue_order(B, S, None, seed)
    assert sorted(order) == list(range(S * B)), "the queue hands out every task once"
    out = np.full((B, V), np.nan, dtype=np.float32)
    writes = np.zeros((B, V), dtype=np.int64)
    most_atomics = np.zeros(B, dtype=np.int64)
    for task in order:
        s, b = divmod(task, B)
        a, e = int(start[b, s]), int(end[b, s])
        a0 = a & ~3
        pos = np.arange(a0, a0 + -(-(max(e, a0) - a0) // tp.COUNT_RUN) * tp.COUNT_RUN)
        # the kernel loads a quad only where it starts before e, so below Wp
        read = (pos >= a) & (pos < e)
        runs = np.where(read, rows[b, np.minimum(pos, Wp - 1)], MISS).reshape(-1, tp.COUNT_RUN)
        lo, n = s * cells, min(cells, V - s * cells)
        if bucket:  # a task reads only its bucket
            read = runs[runs != MISS]
            assert len(read) == e - a and (read // cells == s).all()
        # each thread's runs of equal neighbours: one atomic each
        starts = np.ones(runs.shape, dtype=bool)
        starts[:, 1:] = runs[:, 1:] != runs[:, :-1]
        lens = np.diff(np.append(np.flatnonzero(starts.ravel()), runs.size))
        heads = runs.ravel()[starts.ravel()]
        shift = (b * V + lo) % 4
        cell = (heads.astype(np.int64) - lo) & 0xFFFFFFFF  # u32 wrap, as the kernel
        mine = cell < n
        at = cell[mine] + shift
        if bits == 16:
            words = np.zeros(cells // 2 + 2, dtype=np.int64)
            np.add.at(words, at >> 1, lens[mine] << (16 * (at & 1)))
            assert (words >> 32 == 0).all(), "a u16 pair overflowed its word"
            counts = np.stack([words & 0xFFFF, words >> 16], axis=1).ravel()
            # no low half carried into its high half
            assert (counts == np.bincount(at, lens[mine], minlength=len(counts))).all()
        else:
            counts = np.bincount(at, lens[mine], minlength=cells + 4).astype(np.int64)
            assert (counts < 2**32).all()
        assert not counts[:shift].any() and not counts[n + shift :].any()
        if mine.any():
            most_atomics[b] = max(most_atomics[b], int(np.bincount(cell[mine]).max()))
        # counter quad q holds output cells 4 q - shift .. 4 q + 3 - shift
        for q in range((n + shift + 3) // 4):
            for i in range(4):
                c = 4 * q + i - shift
                if 0 <= c < n:
                    out[b, lo + c] = np.float32(counts[4 * q + i])
                    writes[b, lo + c] += 1
    assert (writes == 1).all(), "every cell is written once"
    return out, most_atomics


def emulate_count(params, codes: np.ndarray, seed: int = 0):
    """Both plans from one emulated lookup, equal; returns the one
    count_plan picks."""
    W = codes.shape[1] - params.k + 1
    idx, n, _ = emulate_lookup(params, codes, seed)
    got = {bucket: emulate_slices(idx, n, params.n_vocab, W, bucket, seed)
           for bucket in (False, True)}
    assert np.array_equal(got[False][0], got[True][0])
    return got[tp.count_plan(W, params.n_vocab).bucket]


def read_like(seed, B, L, base=4):
    """Random bases with -1 breaks, ragged -1 tails, a read set of one
    repeated k-mer (all zeros: row V - 1) and one with no valid window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, base, size=(B, L), dtype=np.int8)
    codes[:, 37::41] = -1
    for i in range(B):
        codes[i, L - int(rng.integers(0, L // 3)) :] = -1
    codes[1, :] = 0
    codes[2, :] = -1
    return codes


def assert_counts(tparams, jparams, codes):
    want = tp.count_spectra_ref(tparams, torch.from_numpy(codes)).numpy()
    import jax.numpy as jnp

    jax_got = np.asarray(jp.count_spectra(jparams, jnp.asarray(codes)))
    got, most = emulate_count(tparams, codes)
    assert np.array_equal(jax_got, want)
    assert np.array_equal(got, want)
    # the wrapper on a CPU tensor is the plain version
    assert np.array_equal(tp.count_spectra(tparams, torch.from_numpy(codes)).numpy(), want)
    return want, most


CASES = {
    # name: (k, V, base, canonical, B, L, slice bytes or None for the package's)
    "canonical": (5, 300, 4, True, 6, 257, None),
    "not_canonical": (5, 300, 4, False, 6, 257, None),
    "v_not_multiple_of_slice": (5, 203, 4, True, 5, 180, 96),
    "slices_u32": (4, 131, 4, True, 4, 150, 64),
    "one_row_vocab": (3, 1, 4, True, 4, 60, None),
    "v1_small_slices": (3, 1, 4, False, 3, 60, 16),
    "protein": (3, 500, 20, False, 5, 140, 200),
    "k1": (1, 4, 4, False, 3, 30, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_count_matches_plain_and_jax(monkeypatch, name):
    k, V, base, canonical, B, L, slice_bytes = CASES[name]
    if slice_bytes is not None:
        monkeypatch.setattr(tp, "COUNT_SLICE_BYTES", slice_bytes)
    tparams, jparams = make_params(len(name), k, V, base, canonical)
    codes = read_like(len(name) + 1, B, L, base)
    if name == "slices_u32":
        monkeypatch.setattr(tp, "COUNT_NARROW_MAX", 10)  # u32 counters at this W
        assert tp.count_plan(L - k + 1, V)[0] == 32
    want, most = assert_counts(tparams, jparams, codes)
    W = L - k + 1
    # the one-k-mer read set: row V - 1 counted at every window, with at
    # most one atomic a thread's run
    assert want[1, V - 1] == W
    assert most[1] <= -(-W // tp.COUNT_RUN)
    assert not want[2].any()
    assert tp.count_plan(W, V)[2] == -(-V // tp.count_plan(W, V)[1])


def test_count_plan_picks_counters_by_windows():
    assert tp.count_plan(1, 367_987) == (16, 49_152, 8, False)
    assert tp.count_plan(30_199, 367_987) == (16, 49_152, 8, False)
    assert tp.count_plan(tp.COUNT_NARROW_MAX, 5) == (16, 49_152, 1, False)
    assert tp.count_plan(tp.COUNT_NARROW_MAX + 1, 367_987) == (32, 24_576, 15, True)


@pytest.mark.parametrize("W,rows,bucket", [
    (29_903 - 9, 524_800, False),              # sars2-genomes: u16, 11 slices, rows in L2
    (tp.COUNT_NARROW_MAX, 524_800, False),     # the last u16 row
    (tp.COUNT_NARROW_MAX + 1, 524_800, True),  # the first u32 row
    (601_876, 524_800, True),                  # sars2-reads: 22 slices
    (88_818_792, 8_390_656, True),             # mtb-reads: 342 slices
    (88_818_792, 24_576, False),               # one slice: nothing to sort
    (88_818_792, 24_576 * 8192, True),         # the scatter's most bins
    (88_818_792, 24_576 * 8192 + 1, False),
])
def test_count_plan_buckets_long_rows_of_several_slices(W, rows, bucket):
    """The bucketed plan where read sets take u32 counters and the rows span
    2 to COUNT_BUCKET_SLICES slices."""
    plan = tp.count_plan(W, rows)
    assert plan.bucket is bucket
    assert plan.slices == -(-rows // plan.cells)


@pytest.mark.parametrize("W", [tp.COUNT_NARROW_MAX, tp.COUNT_NARROW_MAX + 2])
def test_windows_at_the_u16_limit(W):
    """A read set of one k-mer at the last W the u16 counters take, and
    just above it (u32): exact, and no cell carries into its neighbour."""
    k, V = 4, 40
    tparams, jparams = make_params(3, k, V, canonical=True)
    L = W + k - 1
    codes = np.zeros((2, L), dtype=np.int8)
    codes[1] = np.random.default_rng(4).integers(0, 4, L, dtype=np.int8)
    bits = tp.count_plan(W, V)[0]
    assert bits == (16 if W <= tp.COUNT_NARROW_MAX else 32)
    want, _ = assert_counts(tparams, jparams, codes)
    assert want[0, V - 1] == W and want[0].sum() == W


def test_count_spectra_checks_its_arguments():
    tparams, _ = make_params(0, 3, 10)
    with pytest.raises(TypeError):
        tp.count_spectra(tparams, torch.zeros((2, 10), dtype=torch.int32))
    with pytest.raises(ValueError):
        tp.count_spectra(tparams, torch.zeros((2, 2), dtype=torch.int8))
    # a tensor off the CPU never takes the plain version: it launches the
    # kernel, or raises where it cannot
    with pytest.raises(ValueError, match="CUDA"):
        tp.count_spectra(tparams, torch.empty((2, 10), dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("case", ["whole", "middle", "past_the_end", "one_row", "no_hits",
                                  "u32_slices"])
def test_emulated_row_range(monkeypatch, case):
    """The row range of k-mer-sharded serving: the lookup keeps only the
    known windows in [row0, row0 + rows), shifted by row0, the slices count
    ``rows`` cells (rows past the vocabulary count nothing), and the known
    count of each read set is all of its known windows.  Held to those
    columns of the whole count, to the plain version with the range and to
    the wrapper on the CPU."""
    k, V, B, L = 5, 203, 5, 180
    monkeypatch.setattr(tp, "COUNT_SLICE_BYTES", 96)  # several slices a range
    row0, n_rows = {"whole": (0, V), "middle": (61, 70), "past_the_end": (160, 80),
                    "one_row": (V - 1, 1), "no_hits": (V + 10, 30), "u32_slices": (17, 101)}[case]
    if case == "u32_slices":
        monkeypatch.setattr(tp, "COUNT_NARROW_MAX", 10)
    tparams, jparams = make_params(11, k, V)
    codes = read_like(12, B, L)
    whole, _ = assert_counts(tparams, jparams, codes)
    idx, n, n_known = emulate_lookup(tparams, codes, seed=3, row0=row0, n_rows=n_rows)
    want = np.zeros((B, n_rows), dtype=np.float32)
    cols = whole[:, row0: row0 + n_rows]
    want[:, : cols.shape[1]] = cols
    for bucket in (False, True):
        got, _ = emulate_slices(idx, n, n_rows, L - k + 1, bucket, seed=4)
        assert np.array_equal(got, want)
    assert np.array_equal(n_known, whole.sum(axis=1))
    for fn in (tp.count_spectra_ref, tp.count_spectra):
        plain, known = fn(tparams, torch.from_numpy(codes), row0, n_rows, known=True)
        assert np.array_equal(plain.numpy(), want)
        assert known.dtype == torch.int32 and np.array_equal(known.numpy(), n_known)


def test_row_range_checks_its_arguments():
    tparams, _ = make_params(0, 3, 10)
    codes = torch.zeros((2, 10), dtype=torch.int8)
    for row0, rows in ((-1, 3), (0, -2)):
        with pytest.raises(ValueError, match="row range"):
            tp.count_spectra(tparams, codes, row0, rows)
