"""The large-k lookup of the count and bag kernels (csrc/wide_lookup.cuh) on
the CPU: the card's layout of the cuckoo table (ops/cuckoo.py::probe_table)
and its plain lookup against the JAX package's cuckoo_lookup and the port's
cuckoo_lookup_ref, an emulation of the kernel's batched probe (both
tables' fingerprints first, a slot only on a fingerprint match) and of its
lockstep lower bound in the sorted limbs, and the count kernel's split of
its (slice, read set) tasks.

Keys: DNA k = 16 and k = 30 and protein k = 8 vocabularies made from
seeded sequences, and raw int32 key pairs with bit 31 set; queries that
hit either table, that miss, and that land on empty slots (hi = -1).  The
kernels return V for any stored index outside [0, V), so the lookups are
compared after that clamp.  Tolerance: none, indices are held equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.kmers import KmerSpace
from kpop_tpu.ops import cuckoo as jc
from kpop_tpu_torch.ops import cuckoo as tc
from kpop_tpu_torch.ops import encode as te
from kpop_tpu_torch.ops import pipeline as tp

U32 = 0xFFFFFFFF


def clamped(x: np.ndarray, V: int) -> np.ndarray:
    x = np.asarray(x).astype(np.int64)
    return np.where((x >= 0) & (x < V), x, V)


def kmer_keys(content: str, k: int, seed: int, n_seqs: int = 12, length: int = 300):
    """The distinct k-mer codes of seeded sequences as (hi, lo) limbs, half
    of them the vocabulary and the rest absent."""
    rng = np.random.default_rng(seed)
    alphabet = list("ACDEFGHIKLMNPQRSTVWY") if content == "protein" else list("ACGT")
    space = KmerSpace(content, k)
    seqs = ["".join(rng.choice(alphabet, size=length)) for _ in range(n_seqs)]
    codes, _ = spectrum_of_sequences(space, seqs)
    codes = rng.permutation(np.unique(np.asarray(codes, dtype=np.uint64)))
    limb = np.uint64(space.base ** te.split_k(k, space.base)[1])
    hi, lo = (codes // limb).astype(np.int32), (codes % limb).astype(np.int32)
    half = len(codes) // 2
    return (hi[:half], lo[:half]), (hi[half:], lo[half:])


def raw_keys(seed: int, V: int):
    """V distinct int32 key pairs over the whole 64-bit range (bit 31 set
    in about half of each limb), and as many absent ones."""
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, 2**64 - 1, size=4 * V + 8, dtype=np.uint64))
    codes = rng.permutation(codes)
    hi = (codes >> np.uint64(32)).astype(np.int64).astype(np.int32)
    lo = (codes & np.uint64(U32)).astype(np.int64).astype(np.int32)
    return (hi[:V], lo[:V]), (hi[V : 2 * V], lo[V : 2 * V])


KEYSETS = {
    "dna-k16": lambda: kmer_keys("DNA-ds", 16, 1),
    "dna-k30": lambda: kmer_keys("DNA-ds", 30, 2),
    "protein-k8": lambda: kmer_keys("protein", 8, 3),
    "bit31": lambda: raw_keys(4, 3000),
    "one-key": lambda: raw_keys(5, 1),
}


@pytest.fixture(params=sorted(KEYSETS), ids=str)
def built(request):
    (kh, kl), (ah, al) = KEYSETS[request.param]()
    table, seeds = tc.build_cuckoo(kh, kl)
    return request.param, table, seeds, (kh, kl), (ah, al)


def queries(table, keys, absent):
    """The stored keys (both tables hold some), the absent keys, the absent
    keys whose first slot is empty, and the empty slots' own (-1, -1)."""
    (kh, kl), (ah, al) = keys, absent
    qh = np.concatenate([kh, ah, [-1]]).astype(np.int32)
    ql = np.concatenate([kl, al, [-1]]).astype(np.int32)
    return qh, ql


def test_probe_table_holds_the_cuckoo_slots(built):
    """The slots are the cuckoo table's; an empty slot's fingerprint is 0,
    a filled one's the top 16 bits of its key's other mix (0 read as 1)."""
    name, table, seeds, (kh, kl), _ = built
    S = table.shape[1]
    probe = tc.probe_table(torch.from_numpy(table), seeds).numpy()
    assert probe.dtype == np.int32 and probe.shape == (9 * S,)
    slots = probe[: 8 * S].reshape(2, S, 4)
    for t in range(2):
        np.testing.assert_array_equal(slots[t, :, :3].T, table[3 * t : 3 * t + 3])
        assert not slots[t, :, 3].any()
    fp = probe[8 * S :].view(np.uint16).reshape(2, S)
    filled = table[[0, 3]] != -1
    assert (fp[~filled] == 0).all() and (fp[filled] > 0).all()
    a1, b1, a2, b2 = seeds
    for t, (a, b) in enumerate(((a2, b2), (a1, b1))):
        x = jc._mix_np(table[3 * t][filled[t]], table[3 * t + 1][filled[t]], a, b, U32)
        np.testing.assert_array_equal(fp[t][filled[t]], np.maximum(x >> 16, 1))
    if name != "one-key":
        assert filled[0].any() and filled[1].any(), "keys in both tables"


def test_probe_lookup_equal_to_cuckoo_lookup(built):
    """On hits in either table, misses, misses on empty slots, keys with
    bit 31 set and (-1, -1): the plain lookup on the card's layout gives
    cuckoo_lookup_ref's and the JAX cuckoo_lookup's index."""
    _name, table, seeds, keys, absent = built
    V = len(keys[0])
    S = table.shape[1]
    qh, ql = queries(table, keys, absent)
    s1 = jc._mix_np(qh, ql, seeds[0], seeds[1], S - 1)
    assert (table[0, s1[V:-1]] == -1).any(), "some absent keys land on an empty slot"
    want = np.asarray(jc.cuckoo_lookup(jnp.asarray(table), seeds, V, jnp.asarray(qh), jnp.asarray(ql)))
    ref = tc.cuckoo_lookup_ref(torch.from_numpy(table), seeds, V, torch.from_numpy(qh),
                               torch.from_numpy(ql)).numpy()
    np.testing.assert_array_equal(ref, want)
    probe = tc.probe_table(torch.from_numpy(table), seeds)
    got = tc.probe_lookup_ref(probe, seeds, V, torch.from_numpy(qh), torch.from_numpy(ql))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), clamped(want, V))
    np.testing.assert_array_equal(got.numpy()[:V], np.arange(V))
    assert (got.numpy()[V:] == V).all()


def emulate_probe_rows(probe: np.ndarray, seeds, V: int, qh, ql, ok) -> np.ndarray:
    """WideFind::rows on the probe layout, as the kernel orders it: both
    fingerprints of every window, then the slot that the first match
    points at (the first table's first), then the second table's slot
    again when both fingerprints match and the first slot holds another
    key.  Counts the slot reads."""
    a1, b1, a2, b2 = seeds
    S = probe.size // 9
    slots = probe[: 8 * S].reshape(2 * S, 4)
    fp = probe[8 * S :].view(np.uint16)
    x1, x2 = jc._mix_np(qh, ql, a1, b1, U32), jc._mix_np(qh, ql, a2, b2, U32)
    s1, s2 = x1 & (S - 1), S + (x2 & (S - 1))
    want1, want2 = np.maximum(x2 >> 16, 1), np.maximum(x1 >> 16, 1)
    got1, got2 = np.where(ok, fp[s1], 0), np.where(ok, fp[s2], 0)
    m1, m2 = got1 == want1, got2 == want2
    e = np.tile(np.array([-1, -1, V, 0], dtype=np.int64), (len(qh), 1))
    first = m1 | m2
    e[first] = slots[np.where(m1, s1, s2)[first]]
    again = m1 & m2 & ~((e[:, 0] == qh) & (e[:, 1] == ql))
    e[again] = slots[s2[again]]
    x = np.where((e[:, 0] == qh) & (e[:, 1] == ql), e[:, 2], V)
    emulate_probe_rows.slot_reads = int(first.sum() + again.sum())
    return np.where(ok, clamped(x, V), V)


def test_emulated_probe_matches_plain(built):
    _name, table, seeds, keys, absent = built
    V = len(keys[0])
    qh, ql = queries(table, keys, absent)
    ok = np.ones(len(qh), dtype=bool)
    ok[::7] = False  # windows that touch a break read no fingerprint
    probe = tc.probe_table(torch.from_numpy(table), seeds).numpy()
    got = emulate_probe_rows(probe, seeds, V, qh, ql, ok)
    want = tc.probe_lookup_ref(torch.from_numpy(probe), seeds, V, torch.from_numpy(qh),
                               torch.from_numpy(ql)).numpy()
    np.testing.assert_array_equal(got, np.where(ok, want, V))
    # a miss reads a slot only on a false fingerprint match, 2^-16 a probe
    hits = int((got < V).sum())
    assert emulate_probe_rows.slot_reads - hits <= max(2, len(qh) // 1000)


def lockstep_lower_bound(vh: np.ndarray, vl: np.ndarray, qh, ql) -> np.ndarray:
    """WideFind::rows on the sorted limbs: every query's branchless lower
    bound a step at a time (``[at, at + n]`` holds the answer), then the
    last compare, then the hit test; V for a miss."""
    V = len(vh)
    key = vh.astype(np.int64) << 32 | (vl.astype(np.int64) & U32)
    q = qh.astype(np.int64) << 32 | (ql.astype(np.int64) & U32)
    at = np.zeros(len(q), dtype=np.int64)
    n, steps = V, 0
    while n > 1:
        half = n >> 1
        at = np.where(key[at + half] < q, at + half, at)
        n -= half
        steps += 1
    assert steps == int(np.ceil(np.log2(V))) if V > 1 else steps == 0
    at = at + (key[at] < q)
    safe = np.minimum(at, V - 1)
    return np.where((at < V) & (key[safe] == q), at, V)


@pytest.mark.parametrize("V", [1, 2, 3, 1000, 4096, 5003])
def test_lockstep_lower_bound_equal_to_searchsorted(V):
    rng = np.random.default_rng(V)
    codes = np.sort(np.unique(rng.integers(0, 2**60, size=2 * V + 4, dtype=np.uint64))[: V])
    limb = np.uint64(2**30)
    vh, vl = (codes // limb).astype(np.int32), (codes % limb).astype(np.int32)
    absent = rng.integers(0, 2**60, size=300, dtype=np.uint64)
    absent = absent[~np.isin(absent, codes)]
    q = np.concatenate([codes, absent, np.array([0, 2**60 - 1], dtype=np.uint64)])
    qh, ql = (q // limb).astype(np.int32), (q % limb).astype(np.int32)
    got = lockstep_lower_bound(vh, vl, qh, ql)
    want = te.searchsorted_2limb(*(torch.from_numpy(a) for a in (vh, vl, qh, ql))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:V], np.arange(V))


@pytest.mark.parametrize("content,k", [("DNA-ds", 16), ("DNA-ds", 30), ("protein", 8)])
def test_lockstep_lower_bound_on_kmer_limbs(content, k):
    (kh, kl), (ah, al) = kmer_keys(content, k, 9)
    order = np.lexsort((kl, kh))
    vh, vl = kh[order], kl[order]
    qh, ql = np.concatenate([kh, ah]), np.concatenate([kl, al])
    want = te.searchsorted_2limb(*(torch.from_numpy(a) for a in (vh, vl, qh, ql))).numpy()
    np.testing.assert_array_equal(lockstep_lower_bound(vh, vl, qh, ql), want)


# ---------------- the count's task queue -------------------------------


def run_queue(order, cost, blocks: int) -> list[list[int]]:
    """The count kernel's queue over one wave of ``blocks`` blocks: each
    block, as it finishes a task, takes the next of ``order``; ``cost[t]``
    is task t's time.  Returns each block's tasks."""
    import heapq

    G = max(1, min(len(order), blocks))
    free = [(0, g) for g in range(G)]
    taken = [[] for _ in range(G)]
    for t in order:
        at, g = heapq.heappop(free)
        taken[g].append(t)
        heapq.heappush(free, (at + cost[t], g))
    return taken


@pytest.mark.parametrize("W,V,B,blocks", [
    (30_193, 1, 128, 264),                 # V = 1: one slice, fewer tasks than blocks
    (30_193, 49_152, 128, 264),            # V a multiple of a slice
    (30_193, 3 * 49_152, 7, 264),
    (30_193, 1_011_930, 128, 264),         # phase 3 at k = 16: 21 slices
    (30_193, 367_987, 128, 264),           # the headline: 8 slices, 4 tasks a block
    (70_000, 2**31 - 1, 1, 264),           # the largest V, u32 counters
    (10, 5, 3, 1),
])
def test_count_tasks_cover_each_task_once(W, V, B, blocks):
    """The read-all queue: slice-major, every task once; with equal tasks
    one wave's blocks differ by at most one task."""
    bits, cells, slices, _ = tp.count_plan(W, V)
    assert slices == -(-V // cells) and (slices - 1) * cells < V <= slices * cells
    order = tp.count_tasks(B, slices)
    assert order == list(range(slices * B))
    taken = run_queue(order, [1] * len(order), blocks)
    assert len(taken) == min(slices * B, blocks)
    assert sorted(t for ts in taken for t in ts) == order
    sizes = [len(ts) for ts in taken]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the slices the tasks name lie inside the vocabulary
    assert order[-1] // B == slices - 1 and min(cells, V - (slices - 1) * cells) >= 1


def test_count_tasks_fill_one_wave_at_phase_3():
    """Walkers of 13 read sets a slice would put 21 x 13 = 273 blocks on
    264 resident slots at k = 16, 9 of them in a second wave; the queue
    takes one wave, at most ceil(2688 / 264) = 11 tasks a block."""
    slices = tp.count_plan(30_193, 1_011_930).slices
    assert slices == 21
    taken = run_queue(tp.count_tasks(128, slices), [1] * 2688, 2 * 132)
    assert len(taken) == 264 and max(len(ts) for ts in taken) == 11


@pytest.mark.parametrize("seed", [0, 1])
def test_count_tasks_queue_large_buckets_first(seed):
    """The bucketed queue: every task once, those larger than twice their
    read set's mean bucket first.  With a read set of one repeated k-mer
    (all its windows in one bucket) and uneven buckets of GC-rich ranges,
    the queue over one wave ends within one mean task of the balance, where
    slice-major order leaves the large bucket to the wave's tail."""
    rng = np.random.default_rng(seed)
    B, S, blocks = 16, 342, 264
    sizes = rng.poisson(rng.uniform(0.3, 3.0, S) * 250_000, size=(B, S))
    sizes[3] = 0
    sizes[3, S - 1] = 88_818_792  # one k-mer: one bucket of every window
    order = tp.count_tasks(B, S, sizes.tolist())
    assert sorted(order) == list(range(S * B))
    n = sizes.sum(axis=1)
    big = [t for t in order if sizes[t % B, t // B] * S > 2 * n[t % B]]
    assert order[: len(big)] == big and S * B + 3 - B in big
    cost = [sizes[t % B, t // B] + 24_576 for t in range(S * B)]  # reads plus the slice's stores
    ends = [sum(cost[t] for t in ts) for ts in run_queue(order, cost, blocks)]
    slice_major = [sum(cost[t] for t in ts)
                   for ts in run_queue(tp.count_tasks(B, S), cost, blocks)]
    assert max(ends) <= max(max(cost), sum(cost) / blocks + 2 * np.mean(cost))
    assert max(ends) < max(slice_major)


def test_count_scratch_holds_the_rows_and_counts():
    """The scratch as csrc/count_spectra.cu lays it out: the kept and known
    counts (the wrapper reads the known ones at 0 on the whole vocabulary,
    at B on a range), the 8-byte queue, the bucket queue's head and tail;
    bucketed, each bucket's end and start and the order of tasks; then
    from a 16-byte boundary the kept rows and, bucketed, the bucketed
    ones; count_workspace gives the plan argument and that scratch."""
    W = 30_208 - 16 + 1
    Wp = -(-W // tp.COUNT_RUN) * tp.COUNT_RUN
    assert tp.count_scratch_ints(128, 30_208, 16, 1_011_930) == 128 * Wp + 2 * 128 + 4
    assert tp.count_scratch_ints(1, 16, 16, 5) == tp.COUNT_RUN + 2 + 6
    for B, L, k, rows in ((128, 30_208, 16, 1_011_930), (1, 16, 16, 5),
                          (64, 601_885, 10, 524_800),  # sars2-reads: bucketed, 22 slices
                          (16, 88_818_803, 12, 8_390_656),  # mtb-reads: 342 slices
                          (3, 70_000, 5, 2 * 24_576 + 1)):
        W = L - k + 1
        Wp = -(-W // tp.COUNT_RUN) * tp.COUNT_RUN
        plan = tp.count_plan(W, rows)
        assert plan.bucket is (W > tp.COUNT_NARROW_MAX and plan.slices > 1)
        BS = B * plan.slices if plan.bucket else 0
        rows_at = 2 * B + 4 + 3 * BS  # the queue at 2 B ints: 8-byte aligned
        rows_at += -rows_at % 4
        want = rows_at + B * Wp * (2 if plan.bucket else 1)
        assert tp.count_scratch_ints(B, L, k, rows) == want
        # the plan argument and the scratch every caller passes, from one
        # decision; the other plan, named, lays out its own
        bucket, scratch = tp.count_workspace(B, L, k, rows, torch.device("meta"))
        assert bucket == int(plan.bucket) and scratch.numel() == want
        assert tp.count_scratch_ints(B, L, k, rows, not plan.bucket) == (
            -(-(2 * B + 4 + 3 * B * plan.slices) // 4) * 4 + 2 * B * Wp if not plan.bucket
            else -(-(2 * B + 4) // 4) * 4 + B * Wp)

