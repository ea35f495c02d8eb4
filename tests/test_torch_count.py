"""The k-mer count kernel of kpop_tpu_torch (csrc/count_spectra.cu),
emulated on the CPU step by step, against the plain version
count_spectra_ref and the JAX package's count_spectra.

The kernel runs only on the card.  Its plan is emulated here: each thread
looks up COUNT_RUN consecutive windows with a rolling forward and reverse-
complement code, and each block appends its known windows' indices to
the read set's row of the scratch, blocks in any order; then one wave of
blocks takes the (vocabulary slice, read set) tasks as count_tasks splits
them, merges each thread's runs of equal indices, adds each run to u16
(two a 32-bit word) or u32 counters as count_plan chooses by the windows a
read set, and writes the slice whole by counter quads.  The emulation
checks that no u16 cell carries into its neighbour and that every output
cell is written exactly once.

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


def emulate_lookup(params, codes: np.ndarray, seed: int = 0):
    """count_lookup: each thread's COUNT_RUN windows from one rolling code
    (numpy, all threads at once); each block of 256 threads appends its
    known windows' indices, in window order, at a place its one atomic on
    the read set's count claims, so blocks land in any order (``seed``
    shuffles them).  Returns the ``[B, Wp]`` u32 scratch, whose entries past
    each read set's count are left as they were (garbage here), and the
    counts."""
    rng = np.random.default_rng(seed)
    k, base, canonical = params.k, params.base, params.canonical
    lut = params.vocab_lut.numpy().astype(np.int64)
    V = params.n_vocab
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
    for b in range(B):
        parts = [p[p != MISS] for p in np.split(rows[b], range(block, Wp, block))]
        known = np.concatenate([parts[i] for i in rng.permutation(len(parts))])
        n[b] = len(known)
        out[b, : n[b]] = known
    return out, n


def emulate_slices(idx: np.ndarray, n_idx: np.ndarray, V: int, W: int, blocks: int = 264):
    """count_slices: the ``[B, V]`` f32 spectra, and the most atomics one
    counter of each read set took.  The (slice, read set) tasks go to the
    blocks as count_tasks splits them; a task reads the read set's first
    n_idx[b] indices (the rest masked), each thread merging equal
    neighbours of its COUNT_RUN before one atomic, into counters shifted by
    the slice's place within its 16-byte line of the output; then every
    counter quad is read, zeroed and stored."""
    bits, cells, S = tp.count_plan(W, V)
    B, Wp = idx.shape
    out = np.full((B, V), np.nan, dtype=np.float32)
    writes = np.zeros((B, V), dtype=np.int64)
    most_atomics = np.zeros(B, dtype=np.int64)
    for tasks in tp.count_tasks(S, B, blocks):
        for task in tasks:
            s, b = divmod(task, B)
            runs = np.where(np.arange(Wp) < n_idx[b], idx[b], MISS).reshape(-1, tp.COUNT_RUN)
            # each thread's runs of equal neighbours: one atomic each
            starts = np.ones(runs.shape, dtype=bool)
            starts[:, 1:] = runs[:, 1:] != runs[:, :-1]
            lens = np.diff(np.append(np.flatnonzero(starts.ravel()), runs.size))
            heads = runs.ravel()[starts.ravel()]
            lo, n = s * cells, min(cells, V - s * cells)
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


def emulate_count(params, codes: np.ndarray):
    W = codes.shape[1] - params.k + 1
    return emulate_slices(*emulate_lookup(params, codes), params.n_vocab, W)


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
    assert tp.count_plan(1, 367_987) == (16, 49_152, 8)
    assert tp.count_plan(30_199, 367_987) == (16, 49_152, 8)
    assert tp.count_plan(tp.COUNT_NARROW_MAX, 5) == (16, 49_152, 1)
    assert tp.count_plan(tp.COUNT_NARROW_MAX + 1, 367_987) == (32, 24_576, 15)


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
