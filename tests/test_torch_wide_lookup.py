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


# ---------------- the count's task split --------------------------------


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
    bits, cells, slices = tp.count_plan(W, V)
    assert slices == -(-V // cells) and (slices - 1) * cells < V <= slices * cells
    split = tp.count_tasks(slices, B, blocks)
    assert len(split) == min(slices * B, blocks)
    assert split[0].start == 0 and split[-1].stop == slices * B
    assert all(a.stop == b.start for a, b in zip(split, split[1:]))
    sizes = [len(r) for r in split]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the slices the tasks name lie inside the vocabulary
    last = split[-1][-1]
    assert last // B == slices - 1 and min(cells, V - (slices - 1) * cells) >= 1


def test_count_tasks_fill_one_wave_at_phase_3():
    """Walkers of 13 read sets a slice would put 21 x 13 = 273 blocks on
    264 resident slots at k = 16, 9 of them in a second wave; the split
    takes one wave, at most ceil(2688 / 264) = 11 tasks a block."""
    slices = tp.count_plan(30_193, 1_011_930)[2]
    assert slices == 21
    split = tp.count_tasks(slices, 128, 2 * 132)
    assert len(split) == 264 and max(len(r) for r in split) == 11


def test_count_scratch_holds_the_rows_and_counts():
    W = 30_208 - 16 + 1
    Wp = -(-W // tp.COUNT_RUN) * tp.COUNT_RUN
    assert tp.count_scratch_ints(128, 30_208, 16) == 128 * Wp + 2 * 128
    assert tp.count_scratch_ints(1, 16, 16) == tp.COUNT_RUN + 2
