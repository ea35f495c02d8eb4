"""Read sets of 2^24 windows or more in kpop_tpu_torch: the count and the
bag (ops/pipeline.py, csrc/count_spectra.cu, csrc/embedding_bag.cu) over
each read set's integer count of its known windows, and the limits of the
kernels' int32 positions.

A float32 holds every integer below 2^24 and only every second one up to
2^25, so past 2^24 windows an f32 sum of the spectrum is no longer a read
set's count of known windows.  The port divides by that count taken as an
integer, once, in float64 (``pipeline.normalized``), on both routes.

On the CPU: a read set just above 2^24 windows on a k = 5 vocabulary with
seeded random twisters, through the dense route (count, then ``project``
over the count) and the bag (their plain versions), against a plain
float64 chain: int64 counts, the float64 product, the exact count.  The
wrappers' card paths at upstream's M. tuberculosis read sets (16 of
88,818,803 bases, k = 12) are walked on meta tensors, which allocate
nothing, with the launches recorded; the refusals past the kernels' int32
positions are checked at their edges.

On a card (``python3 -m pytest tests/test_torch_long_reads.py -q -m
card``): the count kernel torch.equal to its plain version at 88.8M
windows, a cell above 2^24 rounded once, and in its bucketed plan at
sars2-reads' 64 read sets of 601,885 bases, on the whole vocabulary and
on a row range; the bag and the dense route
within the bag's tolerances of the float64 chain there; the encode of a
row past 1 GiB; the bytes wire and ``DeviceStep`` at a batch of 16 such
read sets on both routes; and ``kpop-classify-torch`` serving them.  This file imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kpop_tpu_torch import _build
from kpop_tpu_torch.ops import encode as te
from kpop_tpu_torch.ops import pipeline as tp

K = 5
#: the bag's tolerances (tests/test_torch_bag.py), against float64 here
BAG_RTOL, BAG_ATOL = 1e-5, 1e-6
#: bases of a 20x read set of M. tuberculosis H37Rv (4,411,532 bases) as
#: upstream KPop's test/clusters-tb.R:42 simulates it (ART -p -l 150 -f 20
#: -m 200 -s 10): 294,102 pairs of 150 bp reads joined by N
TB_BASES = 88_818_803
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lut_params(lut: np.ndarray, V: int, d: int, k: int, seed: int, device="cpu",
               classes: int = 3) -> tp.ClassifierParams:
    """Parameters over the dense table ``lut`` with a seeded N(0, 1) f32
    ``[V, d]`` twister and random class coordinates."""
    g = torch.Generator(device=device).manual_seed(seed)
    tw = torch.randn((V, d), generator=g, device=device)
    coords = torch.randn((classes, d), generator=g, device=device)
    return tp.ClassifierParams(torch.as_tensor(lut, device=device), tw,
                               torch.full((d,), 1.0 / d, device=device), coords,
                               coords.norm(dim=1), k=k, canonical=True)


def random_lut(rng, k: int, V: int) -> np.ndarray:
    """A dense table of ``V`` of the ``4^k`` codes, the rest unknown."""
    lut = np.full(4**k + 1, V, dtype=np.int32)
    lut[rng.permutation(4**k)[:V]] = np.arange(V, dtype=np.int32)
    return lut


def read_set(rng, L: int) -> np.ndarray:
    """``[L]`` int8 bases of joined 150 bp reads: -1 every 151st base."""
    codes = rng.integers(0, 4, size=L, dtype=np.int8)
    codes[150::151] = -1
    return codes


def float64_chain(params, codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain float64 chain, a read set at a time: int64 counts of the
    known windows, their float64 product with the twister, divided by the
    exact count.  Returns ``([B, d]`` float64, ``[B]`` int64 counts)."""
    V = params.n_vocab
    tw = params.twister.double()
    out, known = [], []
    for row in codes:
        idx = tp.vocab_lookup(params, row[None])[0]
        counts = torch.bincount(idx[idx < V].long(), minlength=V)
        n = int(counts.sum())
        out.append((counts.double() @ tw) / max(n, 1))
        known.append(n)
    return torch.stack(out), torch.tensor(known)


def check_dense_and_bag_above_2_24_windows() -> None:
    """A read set of 17.3M windows, 16.7M of them known, through the count
    (with its integer count of known windows) and ``project``, and through
    the bag, against the float64 chain."""
    rng = np.random.default_rng(2_2024_0019)
    V, d = 4**K, 24  # every k-mer known: windows that touch no break count
    params = lut_params(random_lut(rng, K, V), V, d, K, seed=19)
    L = (1 << 24) + (1 << 20)  # 17.3M windows, 16.7M of them known
    codes = torch.from_numpy(read_set(rng, L)[None])
    want, exact = float64_chain(params, codes)
    spectra, known = tp.count_spectra(params, codes, known=True)
    assert known.dtype == torch.int32 and int(known[0]) == int(exact[0]) > 1 << 24
    assert spectra.sum(dtype=torch.float64) == exact[0]  # every cell exact
    dense = tp.project(params, spectra, known=known)
    bag = tp.project_reads(params, codes)
    for got in (dense, bag):
        torch.testing.assert_close(got.double(), want, rtol=BAG_RTOL, atol=BAG_ATOL)
    # without the counts, project takes the spectrum's float64 sum: the same
    assert torch.equal(tp.project(params, spectra), dense)


def test_dense_and_bag_against_float64_above_2_24_windows():
    """:func:`check_dense_and_bag_above_2_24_windows` in a process of its
    own: its 1 GB of int64 indices would raise this process's peak resident
    memory, which tests/test_distill_streaming.py reads through the
    processes it starts."""
    env = dict(os.environ, PYTHONPATH=REPO, KPOP_PLATFORM="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "above_2_24"], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]


def test_normalized_divides_once():
    """Below 2^24 the bits of an f32 division; above, the correctly
    rounded quotient of the exact count, which an f32 count is not (2^24
    + 1 is no float32); a count of 0 divides by 1."""
    g = torch.Generator().manual_seed(5)
    out = torch.randn((4, 300), generator=g)
    small = torch.tensor([1, 3, (1 << 24) - 1, 0], dtype=torch.int32)
    assert torch.equal(tp.normalized(out, small), out / small.clamp(min=1).float()[:, None])
    big = torch.tensor([(1 << 24) + 1, (1 << 24) + 3, TB_BASES, 2**31 - 1], dtype=torch.int32)
    got = tp.normalized(out, big)
    assert torch.equal(got, (out.double() / big.double()[:, None]).float())
    assert not torch.equal(got, out / big.float()[:, None])


def test_limits_of_the_int32_positions():
    """One read set's positions and windows are int32 in the kernels: the
    edges of ``READ_MAX_BASES`` and of the bag's ``BAG_MAX_WINDOWS``.  A
    batch's offsets are 64-bit, so the scratch and the workspace may pass
    2^31 entries."""
    te.check_row_length("t", te.READ_MAX_BASES)
    with pytest.raises(ValueError, match="at most"):
        te.check_row_length("t", te.READ_MAX_BASES + 1)
    assert tp.bag_row_groups(16, tp.BAG_MAX_WINDOWS) == [(b, b + 1) for b in range(16)]
    with pytest.raises(ValueError, match="the bag takes at most"):
        tp.bag_row_groups(16, tp.BAG_MAX_WINDOWS + 1)
    # 32 read sets of 88.8M bases: 2.8G ints of count scratch, 3.2G of bag
    # workspace in a group of 12
    assert tp.count_scratch_ints(32, TB_BASES, 12, 8_390_656) > 2**31
    assert tp.bag_workspace_ints(12, TB_BASES, 12, 8_390_656) > 2**31
    # the wrappers refuse before they allocate (stride-0 views hold 1 byte)
    one = torch.zeros((1, 1), dtype=torch.int8)
    params = lut_params(random_lut(np.random.default_rng(1), K, 50), 50, 4, K, seed=1)
    for fn in (tp.count_spectra, tp.project_reads):
        with pytest.raises(ValueError, match="at most"):
            fn(params, one.expand(1, te.READ_MAX_BASES + 1))
    with pytest.raises(ValueError, match="the bag takes at most"):
        tp.project_reads(params, one.expand(1, tp.BAG_MAX_WINDOWS + K))
    rows = torch.zeros((1, 1), dtype=torch.uint8).expand(1, te.READ_MAX_BASES + 16)
    with pytest.raises(ValueError, match="at most"):
        te.encode_bytes(rows, torch.zeros(1, dtype=torch.int32), 1,
                        torch.zeros(256, dtype=torch.int8))


def test_wrappers_launch_tb_read_sets(monkeypatch):
    """The card paths of the count and the bag at 16 read sets of
    88,818,803 bases (88.8M windows, five times 2^24) against the
    M. tuberculosis vocabulary (k = 12, 8,390,656 rows, d = 999), on meta
    tensors: no refusal, one count launch, the bag in groups of 12 and 4,
    each into its rows of the output."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(tp, "_sm_count", lambda dev: 132)
    V, d, meta = 8_390_656, 999, torch.device("meta")
    params = tp.ClassifierParams(
        torch.empty(4**12 + 1, dtype=torch.int32, device=meta),
        torch.empty((V, d), device=meta), torch.empty(d, device=meta),
        torch.empty((1000, d), device=meta), torch.empty(1000, device=meta), k=12,
        canonical=True)
    codes = torch.empty((16, TB_BASES), dtype=torch.int8, device=meta)
    spectra, known = tp.count_spectra(params, codes, known=True)
    assert spectra.shape == (16, V) and known.shape == (16,) and known.dtype == torch.int32
    (name, args), = calls
    assert name == "kpop_count_spectra" and args[1:3] == (16, TB_BASES)
    assert args[8:10] == (0, V)  # the whole vocabulary: the unranged lookup
    assert args[11] == 1 and tp.count_plan(TB_BASES - 11, V).slices == 342  # bucketed
    assert tp.project(params, spectra, known=known).shape == (16, d)
    calls.clear()
    assert tp.project_reads(params, codes).shape == (16, d)
    assert [(n, a[1]) for n, a in calls] == [("kpop_embedding_bag", 12),
                                             ("kpop_embedding_bag", 4)]
    assert calls[1][1][-1] - calls[0][1][-1] == 4 * 12 * d  # group 2's rows of out


# ---------------- on a card -------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the count and bag kernels run only there")
    monkeypatch.setenv("KPOP_PLATFORM", "cuda")
    return torch.device("cuda", 0)


def canonical_codes(k: int) -> np.ndarray:
    """The sorted canonical codes of every DNA k-mer: those not above their
    reverse complement's."""
    codes = np.arange(4**k, dtype=np.int64)
    rc, x = np.zeros_like(codes), codes.copy()
    for _ in range(k):
        rc = rc * 4 + (3 - x % 4)
        x //= 4
    return codes[codes <= rc]


def canonical_lut(k: int) -> tuple[np.ndarray, int]:
    """The dense table of every canonical k-mer, in code order, and V."""
    vocab = canonical_codes(k)
    lut = np.full(4**k + 1, len(vocab), dtype=np.int32)
    lut[vocab] = np.arange(len(vocab), dtype=np.int32)
    return lut, len(vocab)


def tb_codes(device, B: int, seed: int) -> torch.Tensor:
    """``[B, 88,818,803]`` int8 random joined reads on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 4, (B, TB_BASES), generator=g, device=device, dtype=torch.int8)
    codes[:, 150::151] = -1
    return codes


@pytest.fixture(scope="module")
def tb_params():
    """k = 12 over every canonical 12-mer (8,390,656 rows), d = 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lut, V = canonical_lut(12)
    return lut_params(lut, V, 32, 12, seed=12, device="cuda")


@pytest.mark.card
def test_count_at_tb_read_sets_equals_plain_version(card, tb_params):
    codes = tb_codes(card, 2, seed=3)
    # one k-mer (all A) in W windows, W = 88,818,789, which no float32 holds
    homo = torch.zeros((1, TB_BASES), dtype=torch.int8, device=card)
    homo[0, -3:] = -1
    W = TB_BASES - 12 + 1 - 3
    both = torch.cat([codes, homo])
    got, known = tp.count_spectra(tb_params, both, known=True)
    for b in range(3):  # the plain version a read set at a time (int64 temporaries)
        want, want_known = tp.count_spectra_ref(tb_params, both[b:b + 1], known=True)
        assert torch.equal(got[b:b + 1], want) and int(known[b]) == int(want_known[0])
    row = int(tb_params.vocab_lut[0])
    assert int(known[2]) == W  # the normaliser stays exact
    assert float(got[2, row]) == float(np.float32(W)) != W  # the cell rounded once
    assert float(got[2].sum(dtype=torch.float64)) == float(np.float32(W))


@pytest.mark.card
def test_count_bucketed_at_sars2_reads_shape(card):
    """64 read sets of 601,885 bases of joined 150 bp reads (the benchmark's
    sars2-reads) at k = 10 over every canonical 10-mer (V = 524,800), one
    of them one k-mer repeated: the count takes the bucketed plan (u32
    counters, 22 slices) and is torch.equal to its plain version on the
    whole vocabulary and on a row range with every read set's known
    windows."""
    lut, V = canonical_lut(10)
    params = lut_params(lut, V, 8, 10, seed=10, device=card)
    L = 601_885
    g = torch.Generator(device=card).manual_seed(L)
    codes = torch.randint(0, 4, (64, L), generator=g, device=card, dtype=torch.int8)
    codes[:, 150::151] = -1
    codes[5] = 0  # one k-mer in every window: all in one bucket
    for row0, rows in ((0, V), (100_003, 200_000)):
        plan = tp.count_plan(L - 10 + 1, rows)
        assert plan.bucket and plan.bits == 32 and plan.slices == -(-rows // 24_576)
        got, known = tp.count_spectra(params, codes, row0, rows, known=True)
        want, want_known = tp.count_spectra_ref(params, codes, row0, rows, known=True)
        assert torch.equal(got, want) and torch.equal(known, want_known)
    assert int(known[5]) == L - 10 + 1


@pytest.mark.card
def test_bag_and_dense_at_tb_read_sets_against_float64(card, tb_params):
    """13 read sets: the bag's groups of 12 and 1."""
    codes = tb_codes(card, 13, seed=4)
    want, exact = float64_chain(tb_params, codes)
    spectra, known = tp.count_spectra(tb_params, codes, known=True)
    assert torch.equal(known.long().cpu(), exact)
    for got in (tp.project_reads(tb_params, codes), tp.project(tb_params, spectra, known=known)):
        torch.testing.assert_close(got.double(), want, rtol=BAG_RTOL, atol=BAG_ATOL)


@pytest.mark.card
def test_encode_takes_a_row_past_65535_chunks(card):
    """A row of 65,537 chunks of 16,384 bytes, past 1 GiB: the chunks past
    grid.y's 65,535 run on grid.z, and a dash run near the row's start
    shifts every later code, across both."""
    from kpop_tpu_torch.core.kmers import _DNA_CODE

    n = 65_537 * te.ENCODE_CHUNK - 5
    g = torch.Generator(device=card).manual_seed(8)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=card)
    row = acgt[torch.randint(0, 4, (n,), generator=g, device=card)]
    row[1000:1010] = ord("-")
    rows = torch.zeros((1, -(-n // 16) * 16), dtype=torch.uint8, device=card)
    rows[0, :n] = row
    table = torch.from_numpy(_DNA_CODE).to(card)
    got = te.encode_bytes(rows, torch.tensor([n], dtype=torch.int32, device=card), n, table)
    kept = row[row != ord("-")]
    want = torch.full((1, n), -1, dtype=torch.int8, device=card)
    want[0, : kept.numel()] = table[kept.int()]
    assert torch.equal(got, want)


def tb_strings(n_distinct: int, B: int, seed: int) -> list[str]:
    """``B`` strings of 88,818,803 bases of joined reads, ``n_distinct``
    of them distinct (repeated to fill the batch)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_distinct):
        raw = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=TB_BASES)]
        raw[150::151] = ord("N")
        out.append(raw.tobytes().decode("ascii"))
    return [out[i % n_distinct] for i in range(B)]


@pytest.mark.card
def test_bytes_wire_and_step_at_16_tb_read_sets(card, tb_params):
    from kpop_tpu_torch.cli.classify import DeviceStep

    seqs = tb_strings(4, 16, seed=5)
    from kpop_tpu_torch.core.kmers import _DNA_CODE

    ring = te.ByteRing(pinned=True)
    staged = ring.reserve(seqs)
    ring.fill(staged)
    table = torch.from_numpy(_DNA_CODE).to(card)
    got = te.encode_bytes(*staged.split(staged.buffer.to(card)), TB_BASES, table)
    want = te.encode_reads_host(seqs[:4])
    assert torch.equal(got[:4].cpu(), torch.from_numpy(want))
    del got
    for path in ("dense", "bag"):
        step, codes = DeviceStep(tb_params, path), DeviceStep(tb_params, path, wire="codes")
        assert step.wire == "bytes"
        a = step.materialize(step.dispatch(seqs))
        b = codes.materialize(codes.dispatch(seqs))
        assert a.shape == (16, 3) and np.array_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("path", ["dense", "bag"])
def test_classify_cli_serves_tb_read_sets(card, tmp_path, path):
    """``kpop-classify-torch`` on 16 read sets of 88.8M windows, k = 12,
    against 8 classes on a twister of 60,000 random canonical 12-mers: its
    lines' nearest class and distance are the in-process step's."""
    from kpop_tpu_torch.cli.classify import DeviceStep
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu_torch.core.space import Distance, Metric
    from kpop_tpu_torch.core.twister import Twister

    rng = np.random.default_rng(6)
    space = KmerSpace("DNA-ds", 12)
    vocab = np.sort(rng.choice(canonical_codes(12), 60_000, replace=False))
    names = [space.code_to_hex(int(c)) for c in vocab]
    d, C = 7, 8
    dims = ["D%d" % i for i in range(d)]
    tw = Twister(KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, names,
                                                            rng.standard_normal((d, len(names))))),
                 KPopMatrix(MatrixType.INERTIA, NamedMatrix(["inertia"], dims,
                                                            (0.5 ** np.arange(d))[None])))
    tw.to_binary(str(tmp_path / "TB"))
    coords = rng.standard_normal((C, d)) * 0.01
    KPopMatrix(MatrixType.TWISTED, NamedMatrix(["C%d" % c for c in range(C)], dims, coords)) \
        .to_binary(str(tmp_path / "TB"))
    seqs = tb_strings(2, 16, seed=7)
    with open(tmp_path / "reads.fasta", "w") as f:
        f.writelines(">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))
    env = dict(os.environ, PYTHONPATH=REPO, KPOP_PLATFORM="cuda")
    res = subprocess.run([sys.executable, os.path.join(REPO, "bin", "kpop-classify-torch"),
                          "-T", "TB", "-t", "TB", "-k", "12", "-f", "reads.fasta",
                          "--project-path", path, "-o", "out"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = (tmp_path / "out.KPopSummary.txt").read_text().splitlines()
    assert len(lines) == 16
    from kpop_tpu_torch.ops.pipeline import build_classifier_params

    params = build_classifier_params(space, Twister.of_binary(str(tmp_path / "TB")), coords,
                                     distance=Distance.of_string("euclidean"),
                                     metric=Metric.of_string("powers(1,1,2)"), device=card)
    step = DeviceStep(params, path)
    dmat = step.materialize(step.dispatch(seqs))
    for line, row in zip(lines, dmat):
        f = line.split("\t")
        assert f[5] == "C%d" % int(np.argmin(row))
        assert abs(float(f[6]) - row.min()) <= 1e-6 * max(1.0, row.min())


if __name__ == "__main__":
    if sys.argv[1:] == ["above_2_24"]:
        check_dense_and_bag_above_2_24_windows()
