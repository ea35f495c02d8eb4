"""The large-k serving path of kpop_tpu_torch (k above the dense-LUT limit:
DNA k up to 30, protein up to 12) against kpop_tpu on the CPU, on the same
inputs made from a seed with numpy.

Covered: the two-limb window codes, the sorted-limb search, the cuckoo
hash (its copied builder and mix, and the plain lookup), the classifier
parameters on the cuckoo path and on the sorted-limb fallback (forced by
monkeypatching build_cuckoo to return None in both packages), the lookup,
the count and both projections, the round trip of the JAX parameters, a
CPU emulation of the kernels' 64-bit window codes and lookup
(csrc/count_spectra.cu, csrc/embedding_bag.cu, csrc/wide_lookup.cuh), and
the CLI chain at k=16 trained and served by the port.

Tolerances: codes, lookups, tables and counts exactly; projections rtol
2e-5, atol 1e-6 of JAX and of host Twister.project_entries
(tests/test_ops.py:284-285); CLI summaries 5e-4 * max(1, |x|) of the host
float64 chain (tests/test_cli_extras.py:348)."""

import functools
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.kmers import KmerSpace, encode_dna, encode_protein, hex_labels_vectorized
from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix
from kpop_tpu.core.twister import Twister
from kpop_tpu.ops import cuckoo as jc
from kpop_tpu.ops import encode as je
from kpop_tpu.ops import pipeline as jp
from kpop_tpu_torch.ops import cuckoo as tc
from kpop_tpu_torch.ops import encode as te
from kpop_tpu_torch.ops import pipeline as tp

from test_torch_wide_lookup import emulate_probe_rows, lockstep_lower_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
PROTEIN = list("ACDEFGHIKLMNPQRSTVWY")
PROJ_RTOL, PROJ_ATOL = 2e-5, 1e-6
CHAIN_BOUND = 5e-4


def seqs_of(content: str, rng, n: int, length: int) -> list[str]:
    if content == "protein":
        return ["".join(rng.choice(PROTEIN, size=length)) for _ in range(n)]
    return ["".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04], size=length)) for _ in range(n)]


def batch_of(content: str, seqs: list[str]) -> np.ndarray:
    """[B, L] int8 base codes padded with -1, as the JAX tests make them."""
    if content != "protein":
        return je.encode_reads_host(seqs)
    enc = [encode_protein(s) for s in seqs]
    out = np.full((len(enc), max(len(e) for e in enc)), -1, dtype=np.int8)
    for i, e in enumerate(enc):
        out[i, : len(e)] = e
    return out


# ---------------- codes, search, hash ----------------------------------


@pytest.mark.parametrize(
    "content,k",
    [("DNA-ds", 13), ("DNA-ds", 16), ("DNA-ds", 30), ("DNA-ss", 30),
     ("protein", 6), ("protein", 8), ("protein", 12)],
)
def test_window_codes_wide_equal_to_jax(content, k):
    rng = np.random.default_rng(k)
    space = KmerSpace(content, k)
    seqs = seqs_of(content, rng, 5, 90)
    batch = batch_of(content, seqs)
    want = je.window_codes_batch_wide(jnp.asarray(batch), k, space.canonical, space.base)
    got = te.window_codes_batch_wide(torch.from_numpy(batch), k, space.canonical, space.base)
    for g, w in zip(got, want):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hi, lo, ok = (t.numpy() for t in got)
    k_hi, k_lo = te.split_k(k, space.base)
    if k_hi == 0:  # DNA k = 13..15 and protein k = 6, 7: one limb
        assert not hi.any()
    # the limbs recombine to the host's uint64 codes of every valid window
    full = hi.astype(np.uint64) * np.uint64(space.base**k_lo) + lo.astype(np.uint64)
    for i, e in enumerate((encode_protein if content == "protein" else encode_dna)(s) for s in seqs):
        assert full[i][ok[i]].tolist() == space.window_codes(e).tolist()


@pytest.mark.parametrize("V", [0, 1, 1000])
def test_searchsorted_2limb_equal_to_jax(V):
    rng = np.random.default_rng(5 + V)
    codes = np.unique(rng.integers(0, 2**60, size=V * 2 + 1, dtype=np.uint64))[:V]
    limb = np.uint64(2**30)
    vh, vl = (codes // limb).astype(np.int32), (codes % limb).astype(np.int32)
    q = np.concatenate([rng.choice(codes, size=200) if V else codes,
                        rng.integers(0, 2**60, size=200, dtype=np.uint64)])
    qh, ql = (q // limb).astype(np.int32), (q % limb).astype(np.int32)
    want = np.asarray(je.searchsorted_2limb(jnp.asarray(vh), jnp.asarray(vl),
                                            jnp.asarray(qh), jnp.asarray(ql)))
    got = te.searchsorted_2limb(*(torch.from_numpy(a) for a in (vh, vl, qh, ql)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if V:
        hit = np.isin(q, codes)
        assert hit.any() and (~hit).any()
        np.testing.assert_array_equal(got.numpy()[hit], np.searchsorted(codes, q[hit]))
        assert (got.numpy()[~hit] == V).all()


@pytest.mark.parametrize("V", [1, 17, 5000, 100_000])
def test_cuckoo_build_and_lookup_equal_to_jax(V):
    """The copied builder gives the JAX table and seeds; the plain lookup
    resolves every key as the JAX lookup does and misses on absent keys."""
    rng = np.random.default_rng(7 + V)
    codes = np.unique(rng.integers(0, 2**60, size=V * 2, dtype=np.uint64))[:V]
    limb = np.uint64(2**30)
    kh, kl = (codes // limb).astype(np.int32), (codes % limb).astype(np.int32)
    table, seeds = tc.build_cuckoo(kh, kl)
    want_table, want_seeds = jc.build_cuckoo(kh, kl)
    np.testing.assert_array_equal(table, want_table)
    assert seeds == want_seeds
    absent = rng.integers(0, 2**60, size=500, dtype=np.uint64)
    absent = absent[~np.isin(absent, codes)]
    qh = np.concatenate([kh, (absent // limb).astype(np.int32)])
    ql = np.concatenate([kl, (absent % limb).astype(np.int32)])
    want = np.asarray(jc.cuckoo_lookup(jnp.asarray(table), seeds, V, jnp.asarray(qh), jnp.asarray(ql)))
    got = tc.cuckoo_lookup_ref(torch.from_numpy(table), seeds, V, torch.from_numpy(qh),
                               torch.from_numpy(ql))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:V], np.arange(V))
    assert (got.numpy()[V:] == V).all()


def test_mix_equal_to_mix_np():
    """The int64 mix wraps as the uint32 one, on keys with bit 31 set."""
    rng = np.random.default_rng(3)
    hi = rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
    lo = rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
    hi[:4] = [-1, -(2**31), 2**31 - 1, 0]
    assert (hi < 0).sum() > 1000 and (lo < 0).sum() > 1000
    for attempt in range(3):
        a1, b1, a2, b2 = jc._seeds(attempt)
        for a, b in ((a1, b1), (a2, b2)):
            for mask in (2**21 - 1, 2**32 - 1):
                got = tc.mix(torch.from_numpy(hi), torch.from_numpy(lo), a, b, mask)
                np.testing.assert_array_equal(got.numpy(), jc._mix_np(hi, lo, a, b, mask))


# ---------------- classifier parameters, lookup, count, projection ------


CASES = [("DNA-ds", 16), ("protein", 8)]


@functools.lru_cache(maxsize=None)
def wide_case(content: str, k: int, lookup: str):
    """A twister over the k-mers of half of six sequences, queries that
    hold unknown k-mers, a read of one repeated k-mer and one of no valid
    window; JAX and torch parameters built from it, with the cuckoo hash
    or, with ``lookup="sorted"``, the sorted limbs in both packages."""
    rng = np.random.default_rng(6 + k)
    space = KmerSpace(content, k)
    seqs = seqs_of(content, rng, 6, 150)
    seqs.append("A" * 100)
    seqs.append("N" * 40 if content != "protein" else "*" * 40)
    vocab_codes, _ = spectrum_of_sequences(space, seqs[:3] + seqs[6:7])
    vocab_codes = np.unique(vocab_codes)
    d = 7
    labels = hex_labels_vectorized(vocab_codes, space.hex_width)
    # labels in another order than the codes: the wide parameters sort them
    perm = rng.permutation(len(labels))
    labels = [labels[i] for i in perm]
    dims = ["Dim%d" % (i + 1) for i in range(d)]
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, labels, rng.standard_normal((d, len(labels))))),
        KPopMatrix(MatrixType.INERTIA,
                   NamedMatrix(["inertia"], dims, np.sort(rng.random(d))[::-1][None, :].copy())),
    )
    coords = rng.standard_normal((4, d))
    with pytest.MonkeyPatch.context() as mp:
        if lookup == "sorted":
            mp.setattr(jc, "build_cuckoo", lambda *a: None)
            mp.setattr(tp, "build_cuckoo", lambda *a: None)
        jparams = jp.build_classifier_params(space, twister, coords)
        tparams = tp.build_classifier_params(space, twister, coords, device="cpu")
    return space, seqs, twister, jparams, tparams


@pytest.fixture(params=[c + (lk,) for c in CASES for lk in ("cuckoo", "sorted")],
                ids=lambda p: "%s-k%d-%s" % p)
def case(request):
    return wide_case(*request.param)


def test_build_classifier_params_equal_to_jax(case):
    _space, _seqs, _tw, jparams, tparams = case
    assert jparams.vocab_lut is None and tparams.vocab_lut is None
    assert (jparams.cuckoo is None) == (tparams.cuckoo is None)
    for name in tp.PARAM_ARRAYS:
        want, got = getattr(jparams, name), getattr(tparams, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert got.numpy().dtype == np.asarray(want).dtype, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert tparams.cuckoo_seeds == tuple(jparams.cuckoo_seeds)
    assert (tparams.k, tparams.canonical, tparams.base) == (jparams.k, jparams.canonical, jparams.base)


def test_lookup_and_count_equal_to_jax(case):
    space, seqs, _tw, jparams, tparams = case
    codes = batch_of(space.content, seqs)
    want_idx = np.asarray(jp.vocab_lookup(jparams, jnp.asarray(codes)))
    got_idx = tp.vocab_lookup(tparams, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    V = tparams.n_vocab
    assert (got_idx < V).any() and (got_idx == V).any()
    want = np.asarray(jp.count_spectra(jparams, jnp.asarray(codes)))
    for fn in (tp.count_spectra, tp.count_spectra_ref):
        np.testing.assert_array_equal(fn(tparams, torch.from_numpy(codes)).numpy(), want)
    assert want[6].max() == 100 - space.k + 1  # the repeated k-mer counts every time
    assert not want[7].any()


@pytest.mark.parametrize("normalize", [True, False])
def test_projections_equal_to_jax_and_host(case, normalize):
    space, seqs, twister, jparams, tparams = case
    codes = batch_of(space.content, seqs)
    spectra = np.array(jp.count_spectra(jparams, jnp.asarray(codes)))  # writable
    want = np.asarray(jp.project(jparams, jnp.asarray(spectra), normalize=normalize))
    want_bag = np.asarray(jp.project_reads(jparams, jnp.asarray(codes), normalize=normalize, chunk=64))
    got = tp.project(tparams, torch.from_numpy(spectra), normalize=normalize).numpy()
    got_bag = tp.project_reads(tparams, torch.from_numpy(codes), normalize=normalize).numpy()
    got_ref = tp.project_reads_ref(tparams, torch.from_numpy(codes), normalize, chunk=64).numpy()
    for g in (got, got_bag, got_ref):
        np.testing.assert_allclose(g, want, rtol=PROJ_RTOL, atol=PROJ_ATOL)
        np.testing.assert_allclose(g, want_bag, rtol=PROJ_RTOL, atol=PROJ_ATOL)
    entries = []
    for s in seqs:
        cds, cts = spectrum_of_sequences(space, [s])
        entries.append([(space.code_to_hex(int(c)), float(v)) for c, v in zip(cds, cts)])
    host = twister.project_entries(entries, normalize=normalize)
    for g in (got, got_bag):
        np.testing.assert_allclose(g, host, rtol=PROJ_RTOL, atol=PROJ_ATOL)


def test_params_from_jax_round_trip(case):
    space, seqs, _tw, jparams, _ = case
    arrays = {n: None if getattr(jparams, n) is None else np.asarray(getattr(jparams, n))
              for n in tp.PARAM_ARRAYS}
    tparams = tp.params_from_jax(arrays, jparams.k, jparams.canonical, jparams.base,
                                 jparams.distance_kind, device="cpu",
                                 cuckoo_seeds=jparams.cuckoo_seeds)
    buffers = dict(tparams.named_buffers())
    assert set(buffers) == {n for n, a in arrays.items() if a is not None}
    for name, buf in buffers.items():
        np.testing.assert_array_equal(buf.numpy(), arrays[name])
    codes = batch_of(space.content, seqs)
    np.testing.assert_array_equal(tp.vocab_lookup(tparams, torch.from_numpy(codes)).numpy(),
                                  np.asarray(jp.vocab_lookup(jparams, jnp.asarray(codes))))


def test_wide_params_check_their_tables(case):
    _space, _seqs, _tw, _jp, tparams = case
    bufs = dict(tparams.named_buffers())
    args = [bufs[n] for n in ("twister", "metric", "class_coords", "class_norms")]
    with pytest.raises(ValueError):  # a dense table above the LUT limit
        tp.ClassifierParams(torch.zeros(5, dtype=torch.int32), *args, tparams.k, tparams.canonical,
                            tparams.base)
    with pytest.raises(ValueError):  # neither lookup
        tp.ClassifierParams(None, *args, tparams.k, tparams.canonical, tparams.base)
    with pytest.raises(ValueError, match="CUDA"):  # never the plain version off the CPU
        tp.count_spectra(tparams, torch.empty((2, 40), dtype=torch.int8, device="meta"))


# ---------------- the kernels' arithmetic, emulated ---------------------


def emulate_wide_lookup(params, codes: np.ndarray) -> np.ndarray:
    """count_lookup<WideFind>: each thread rolls uint64 forward and reverse-
    complement codes over COUNT_RUN windows (DNA: 2 bits a base, masked to
    2k bits; the complement shifted in at 2(k - 1); protein: base 20),
    takes the smaller full code, splits it at base^k_lo and probes the
    cuckoo table's card layout (both fingerprints, then a matching slot)
    or searches the sorted limbs in lockstep (wide_lookup.cuh::
    window_rows, which the count's lookup and the bag's histogram share).
    Returns the [B, W] rows, V for a miss, and the limbs."""
    k, base, canonical, V = params.k, params.base, params.canonical, params.n_vocab
    _k_hi, k_lo = te.split_k(k, base)
    B, L = codes.shape
    W = L - k + 1
    Wp = -(-W // tp.COUNT_RUN) * tp.COUNT_RUN
    w0 = np.arange(0, Wp, tp.COUNT_RUN)
    top = np.uint64(base ** (k - 1))
    fwd = np.zeros((B, len(w0)), np.uint64)
    rc = np.zeros_like(fwd)
    last_bad = np.broadcast_to(w0 - 1, fwd.shape).copy()
    out = np.full((B, Wp), V, dtype=np.int64)

    def push(j):
        nonlocal fwd, rc
        c = np.where(j < L, codes[:, np.minimum(j, L - 1)].astype(np.int64), -1)
        bad = (c < 0) | (c >= base)
        last_bad[...] = np.where(bad, j, last_bad)
        c = np.where(bad, 0, c).astype(np.uint64)
        fwd = ((fwd & (top - np.uint64(1))) if base == 4 else fwd % top) * np.uint64(base) + c
        if canonical:
            rc = (rc >> np.uint64(2)) + (np.uint64(3) - c) * top

    def find(code):
        limb = np.uint64(base**k_lo)
        hi, lo = (code // limb).astype(np.int32), (code % limb).astype(np.int32)
        qh, ql = hi.ravel(), lo.ravel()
        if params.cuckoo is not None:
            x = emulate_probe_rows(params.cuckoo_probe.numpy(), params.cuckoo_seeds, V, qh, ql,
                                   np.ones(len(qh), dtype=bool))
        else:
            x = lockstep_lower_bound(params.vocab_hi.numpy(), params.vocab_lo.numpy(), qh, ql)
        return x.reshape(hi.shape), hi, lo

    for j in range(k - 1):
        push(w0 + j)
    limbs = np.zeros((2, B, Wp), np.int64)
    for r in range(tp.COUNT_RUN):
        w = w0 + r
        push(w + k - 1)
        valid = (w < W) & (last_bad < w)
        code = np.where(canonical & (fwd > rc), rc, fwd)
        x, limbs[0][:, w], limbs[1][:, w] = find(code)
        out[:, w] = np.where(valid, x, V)
    return out[:, :W], limbs[:, :, :W]


@pytest.mark.parametrize(
    "content,k,lookup",
    [("DNA-ds", 16, "cuckoo"), ("DNA-ds", 16, "sorted"), ("DNA-ds", 13, "cuckoo"),
     ("DNA-ds", 30, "cuckoo"), ("DNA-ss", 30, "sorted"), ("protein", 8, "cuckoo"),
     ("protein", 12, "sorted")],
)
def test_emulated_wide_lookup_matches_plain(content, k, lookup):
    space, seqs, _tw, _jp, tparams = wide_case(content, k, lookup)
    codes = batch_of(content, seqs)
    codes[2, 5::33] = -1  # more breaks, inside a thread's run
    got, limbs = emulate_wide_lookup(tparams, codes)
    want = tp.vocab_lookup(tparams, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    hi, lo, ok = (t.numpy() for t in te.window_codes_batch_wide(
        torch.from_numpy(codes), k, space.canonical, space.base))
    np.testing.assert_array_equal(limbs[0][ok], hi[ok])
    np.testing.assert_array_equal(limbs[1][ok], lo[ok])


# ---------------- the CLI chain -----------------------------------------


def sh(cmd: str, cwd):
    env = dict(os.environ, PATH=BIN + os.pathsep + os.environ["PATH"], PYTHONPATH=REPO,
               KPOP_PLATFORM="cpu")
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(["bash", "-c", cmd], cwd=str(cwd), env=env, capture_output=True, text=True)
    assert res.returncode == 0, f"{cmd}\n{res.stderr[-3000:]}"
    return res


def test_cli_chain_k16_trained_and_served_by_the_port(tmp_path):
    """The counterpart of tests/test_cli_extras.py:293-348 with the port's
    tools only: kpop-count-torch counts the classes and the queries,
    kpop-countdb-torch and kpop-twist-torch train, and kpop-classify-torch
    at k=16 (inferred from the labels) agrees with the host float64 chain
    kpop-count-torch | kpop-twistdb-torch -k | -s --backend host."""
    rng = np.random.default_rng(17)
    k = 16
    bases = np.array(list("ACGT"))
    fams = [rng.integers(0, 4, size=600) for _ in range(4)]

    def mut(g, n):
        g = g.copy()
        pos = rng.choice(len(g), size=n, replace=False)
        g[pos] = (g[pos] + rng.integers(1, 4, size=n)) % 4
        return g

    for fi, fam in enumerate(fams):
        (tmp_path / ("fam%d.fasta" % fi)).write_text(
            "".join(">F%d_%d\n%s\n" % (fi, j, "".join(bases[mut(fam, 15)])) for j in range(3)))
    (tmp_path / "test.fasta").write_text("\n".join(
        ">T%d-F%d\n%s" % (i, i % 4, "".join(bases[mut(fams[i % 4], 15)])) for i in range(8)) + "\n")
    sh("for F in 0 1 2 3; do kpop-count-torch -k %d -l F$F -f fam$F.fasta; done | "
       "kpop-countdb-torch -k /dev/stdin -o DB" % k, tmp_path)
    sh("kpop-twist-torch -i DB -o TW", tmp_path)
    sh("kpop-count-torch -k %d -L -f test.fasta -o /dev/stdout | "
       "kpop-twistdb-torch -i T TW -k /dev/stdin -o t Q && "
       "kpop-twistdb-torch --backend host -i T TW -i t TW -s Q HostSum" % k, tmp_path)
    sh("kpop-classify-torch -T TW -t TW -f test.fasta -o DevSum", tmp_path)
    host = sorted((tmp_path / "HostSum.KPopSummary.txt").read_text().splitlines())
    dev = sorted((tmp_path / "DevSum.KPopSummary.txt").read_text().splitlines())
    assert len(host) == len(dev) == 8
    for lh, ld in zip(host, dev):
        ph, pd = lh.split("\t"), ld.split("\t")
        assert ph[0] == pd[0]
        assert ph[5] == pd[5] == ph[0].split("-")[1], f"class of {ph[0]}: {pd[5]}, host {ph[5]}"
        # mean, stddev, median, MAD and the distance to the nearest class
        for i in (1, 2, 3, 4, 6):
            a, b = float(pd[i]), float(ph[i])
            assert abs(a - b) < CHAIN_BOUND * max(1.0, abs(b)), (ph[0], i, a, b)


@pytest.mark.parametrize("args", ["-k 16 -L", "-k 5 -l all", "-k 21 -C DNA-ss -L"])
def test_count_torch_writes_the_bytes_of_kpop_count(tmp_path, args):
    rng = np.random.default_rng(len(args))
    (tmp_path / "in.fasta").write_text("".join(
        ">s%d\n%s\n" % (i, s) for i, s in enumerate(seqs_of("DNA-ds", rng, 5, 120))))
    sh(f"kpop-count {args} -f in.fasta -o Want && kpop-count-torch {args} -f in.fasta -o Got",
       tmp_path)
    want = (tmp_path / "Want.KPopSpectra.txt").read_bytes()
    assert want and (tmp_path / "Got.KPopSpectra.txt").read_bytes() == want
