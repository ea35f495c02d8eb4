"""The serving step's bytes wire (``DeviceStep(wire="bytes")``): each
sequence's raw bytes staged in a ring of two reused host buffers
(``ops/encode.py::ByteRing``), uploaded, then linted and encoded on the
device (``encode_bytes``; ``csrc/encode_bytes.cu`` on a card, its plain
PyTorch version ``encode_bytes_ref`` on the CPU).

On the CPU: the plain encoder against ``native.encode_batch`` and its numpy
fallback on seeded strings (DNA and protein, str and bytes), equal on the
common columns and -1 beyond; the ring's bytes and lengths against
``s.encode()`` across reuse, growth and padding rows; the ring's split fill
(pieces of a few bytes, on a few threads) against its one-thread fill, the
whole slot byte for byte, a thread's failure raised in the caller, and the
step's fill counters; the step's distances equal to the codes wire's on
both routes, and on two gloo ranks (dp = 2, and kp = 2 through
``sharded_dmat_fn``, each rank's fill split on its share of the cores)
against one rank.

On a card (``-m card``; skipped without one): the kernel equal to the
plain version on a batch of 64 x 601,885 bytes with dashes sprinkled in,
DNA and protein, and on ragged rows; the kernel's refusal of rows off a
16-byte stride or boundary; the default wire; the step's distances
equal to the codes wire's; and the kernel launched once a served batch.
Run them there with ``python3 -m pytest tests/test_torch_bytes_wire.py -q
-m card``.

Also a worker script: ``python tests/test_torch_bytes_wire.py <rank>
<world> <port> <workdir>``; it imports nothing of JAX."""

import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))

from kpop_tpu_torch import _build, native, trace  # noqa: E402
from kpop_tpu_torch.cli.classify import DeviceStep  # noqa: E402
from kpop_tpu_torch.core.kmers import _DNA_CODE, _PROT_CODE  # noqa: E402
from kpop_tpu_torch.ops import encode as te  # noqa: E402

K = 4
#: the lint table of DNA (False) and protein (True)
TABLE = {False: _DNA_CODE, True: _PROT_CODE}
#: every character class the lint table knows, and some it does not
ALPHABET = list("ACGTacgtUuNnRYKMSWBDHVryk-*.XZ0 ") + ["é", "ß", "Ω", "→"]


def random_seqs(rng, n: int, longest: int, alphabet=ALPHABET) -> list[str]:
    """Seeded strings over ``alphabet`` with dash runs at the start, middle
    and end, an all-dash row, an empty row and a row of bases only."""
    out = ["".join(rng.choice(alphabet, size=int(rng.integers(0, longest))))
           for _ in range(n)]
    out[0] = "---" + out[0] + "--"
    out[1] = out[1][: len(out[1]) // 2] + "-" * 7 + out[1][len(out[1]) // 2:]
    out[2] = "-" * 40
    out[3] = ""
    out[4] = "".join(rng.choice(list("ACGT"), size=longest))
    return out


def staged_codes(seqs, protein: bool, width: int | None = None) -> np.ndarray:
    ring = te.ByteRing(pinned=False)
    staged = ring.reserve(seqs)
    ring.fill(staged)
    width = max(staged.longest, 1) if width is None else width
    return te.encode_bytes(*staged.split(), width,
                           torch.from_numpy(TABLE[protein])).numpy()


def assert_same_codes(got: np.ndarray, want: np.ndarray) -> None:
    """Equal on the common columns, -1 past them."""
    w = want.shape[1]
    assert got.shape[0] == want.shape[0] and got.shape[1] >= w
    np.testing.assert_array_equal(got[:, :w], want)
    assert (got[:, w:] == -1).all()


# ---------------- the plain encoder ----------------------------------------


@pytest.mark.parametrize("kind", ["str", "bytes"])
@pytest.mark.parametrize("protein", [False, True])
@pytest.mark.parametrize("encoder", ["native", "numpy"])
def test_plain_encoder_equal_to_the_host_encoder(monkeypatch, kind, protein, encoder):
    seqs = random_seqs(np.random.default_rng(7 + protein), 40, 300)
    if kind == "bytes":
        seqs = [s.encode() for s in seqs]
    got = staged_codes(seqs, protein)
    if encoder == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    want = te.encode_reads_host(seqs, protein=protein)
    assert got.dtype == np.int8
    assert_same_codes(got, want)
    assert (got[2] == -1).all() and (got[3] == -1).all()  # all dashes; empty


def test_plain_encoder_truncates_at_width():
    seqs = random_seqs(np.random.default_rng(3), 12, 90)
    want = native.encode_batch(seqs, False, 20)
    np.testing.assert_array_equal(staged_codes(seqs, False, width=20), want)


def test_encode_bytes_checks_its_inputs():
    rows, lengths = torch.zeros((3, 16), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32)
    table = torch.from_numpy(TABLE[False])
    with pytest.raises(TypeError, match="uint8"):
        te.encode_bytes(rows.to(torch.int8), lengths, 4, table)
    with pytest.raises(TypeError, match="int32"):
        te.encode_bytes(rows, lengths.long(), 4, table)
    with pytest.raises(TypeError, match="table"):
        te.encode_bytes(rows, lengths, 4, table[:100])
    with pytest.raises(ValueError, match="width"):
        te.encode_bytes(rows, lengths, 0, table)


def emulate_kernel(rows: np.ndarray, lengths: np.ndarray, width: int, table: np.ndarray,
                   threads: int, span: int = 64) -> np.ndarray:
    """``csrc/encode_bytes.cu``'s plan in numpy, with ``threads`` threads a
    block of ``span`` bytes each: each chunk's kept count, the exclusive
    scan of a row's chunks, each thread's offset by a block scan, the
    chunk's kept codes staged in order, then written to ``dst[base, base +
    n)`` as bytes up to a 4-byte boundary of the output, words shifted out
    of two aligned staged words, and the tail; -1 over each chunk's columns
    past the row's encoded length."""
    B, stride = rows.shape
    table = table.view(np.uint8)  # a code's byte
    chunk = threads * span
    chunks = -(-max(stride, width) // chunk)
    out = np.full(B * width + 3, 0x55, dtype=np.uint8)  # not -1: every cell is written
    at0 = 3 - (width % 4)  # rows start at every offset modulo 4 of the output
    work = np.zeros((B, chunks), dtype=np.int64)
    for pass_ in ("count", "write"):
        for r in range(B):
            n_len = min(max(int(lengths[r]), 0), stride)
            for c in range(chunks):
                staged, kept = np.zeros(chunk + 16, dtype=np.uint8), 0
                for t in range(threads):  # in thread order: the block scan
                    for j in range(span):
                        p = c * chunk + t * span + j
                        if p < n_len and table[rows[r, p]] != 0xFE:  # not a dash
                            staged[kept] = table[rows[r, p]]
                            kept += 1
                if pass_ == "count":
                    work[r, c] = kept
                    continue
                base, encoded = int(work[r, :c].sum()), int(work[r].sum())
                d0 = at0 + r * width + base
                n = min(kept, width - base) if base < width else 0
                head = min((4 - d0 % 4) % 4, n)
                words = (n - head) >> 2
                out[d0: d0 + head] = staged[:head]
                sw = staged.view(np.uint32)
                for i in range(words):
                    v = (int(sw[i]) | int(sw[i + 1]) << 32) >> (8 * head) & 0xFFFFFFFF
                    out[d0 + head + 4 * i: d0 + head + 4 * i + 4] = np.frombuffer(
                        np.uint32(v).tobytes(), dtype=np.uint8)
                out[d0 + head + 4 * words: d0 + n] = staged[head + 4 * words: n]
                c0 = c * chunk
                lo, hi = max(encoded, c0), min(c0 + chunk, width)
                if lo < hi:
                    out[at0 + r * width + lo: at0 + r * width + hi] = 0xFF
    return out[at0: at0 + B * width].view(np.int8).reshape(B, width)


@pytest.mark.parametrize("threads", [1, 2, 3])
@pytest.mark.parametrize("protein", [False, True])
def test_emulated_kernel_equal_to_plain_version(threads, protein):
    """Rows over several chunks with dash runs across their edges, at every
    alignment of the output, widths wider and narrower than the rows."""
    rng = np.random.default_rng(31 + threads)
    seqs = random_seqs(rng, 7, 450)
    ring = te.ByteRing(pinned=False)
    staged = ring.reserve(seqs)
    ring.fill(staged)
    rows, lengths = staged.split()
    table = TABLE[protein]
    for width in (staged.longest, staged.longest + 37, 130):
        want = te.encode_bytes_ref(rows, lengths, width, torch.from_numpy(table)).numpy()
        got = emulate_kernel(rows.numpy(), lengths.numpy(), width, table, threads)
        np.testing.assert_array_equal(got, want, err_msg=f"width {width}")


# ---------------- the ring --------------------------------------------------


def test_ring_rows_and_lengths_equal_the_encoded_strings():
    """Slot bytes and lengths equal ``s.encode()`` on both slots in turn,
    when a slot grows, and for length-0 padding rows."""
    rng = np.random.default_rng(5)
    ring = te.ByteRing(pinned=False)
    batches = [random_seqs(rng, 8, 60), random_seqs(rng, 8, 60), random_seqs(rng, 5, 40),
               random_seqs(rng, 9, 700), random_seqs(rng, 5, 30)]
    ptrs = []
    for i, seqs in enumerate(batches):
        r0, r1 = (1, len(seqs) + 2) if i == 2 else (0, len(seqs))  # 2 padding rows
        staged = ring.reserve(seqs, r0, r1)
        ring.fill(staged)
        rows, lengths = staged.split()
        enc = [s.encode() for s in seqs]
        assert staged.stride % 16 == 0 and staged.stride >= max(map(len, enc))
        assert staged.longest == max(map(len, enc)) and staged.rows == r1 - r0
        assert staged.buffer.nbytes == (r1 - r0) * (staged.stride + 4)
        for j in range(r0, r1):
            n = len(enc[j]) if j < len(enc) else 0
            assert lengths[j - r0] == n
            assert bytes(rows[j - r0, :n].numpy()) == (enc[j] if j < len(enc) else b"")
        ptrs.append(staged.buffer.data_ptr())
    assert ptrs[2] == ptrs[0]  # the first slot again, large enough
    assert ptrs[3] != ptrs[1]  # the second slot grew


#: the piece size the split fill's tests set, so that each case stays small
PIECE = 64
#: what a slot's row bytes hold before a fill, where nothing is written
SENTINEL = 0xA5


def fill_case(case: str, rng):
    """``(seqs, r0, r1)`` of one split-fill case at :data:`PIECE` bytes."""
    if case == "long_rows":  # rows over several pieces, with padding rows
        seqs = random_seqs(rng, 6, 400)
        return seqs, 1, len(seqs) + 2
    if case == "shared_pieces":  # many rows a piece
        return ["".join(rng.choice(list("ACGTN-"), size=int(rng.integers(0, 21))))
                for _ in range(40)], 0, 40
    if case == "piece_boundary":  # rows 0, 2 and 3 end on a piece's end
        return ["A" * PIECE, "C" * 32, "G" * 32, "T" * 2 * PIECE, "ACGT" * 5], 0, 5
    if case == "non_ascii":  # multibyte characters cut across pieces
        return ["".join(rng.choice(["é", "Ω", "→", "A", "ß"], size=int(rng.integers(20, 90))))
                for _ in range(7)], 0, 7
    if case == "bytes_sources":
        enc = [s.encode() for s in random_seqs(rng, 6, 300)]
        return enc[:3] + [bytearray(enc[3])] + enc[4:], 0, 6
    assert case == "one_piece"
    return ["ACGT", "é", "", "NN-A"], 0, 4


@pytest.mark.parametrize("case", ["long_rows", "shared_pieces", "piece_boundary", "non_ascii",
                                  "bytes_sources", "one_piece"])
def test_split_fill_equals_one_thread_fill(monkeypatch, case):
    """The split fill's whole slot equals the one-thread fill's on the same
    staged batch, byte for byte: each row's bytes, the sentinel past each
    row's length and in the padding rows, the lengths.  Pieces of
    ``PIECE`` bytes, each copy within one row; a batch of one piece takes
    the calling thread alone."""
    monkeypatch.setattr(te, "FILL_PIECE", PIECE)
    seqs, r0, r1 = fill_case(case, np.random.default_rng(23))
    enc = [s.encode() if isinstance(s, str) else bytes(s) for s in seqs]
    ring = te.ByteRing(pinned=False)
    staged = ring.reserve(seqs, r0, r1)
    rows, lengths = staged.split()
    total = sum(len(e) for e in enc[r0:r1])
    pieces = -(-total // PIECE)
    assert (pieces == 1) == (case == "one_piece")

    monkeypatch.setattr(te, "fill_cores", lambda: 1)
    rows.fill_(SENTINEL)
    assert ring.fill(staged) == (pieces, 1)
    one = staged.buffer.clone()

    monkeypatch.setattr(te, "fill_cores", lambda: 3)
    rows.fill_(SENTINEL)
    started = threading.active_count()
    assert ring.fill(staged) == (pieces, min(pieces, 3))
    assert torch.equal(staged.buffer, one)
    if case == "one_piece":
        assert ring._pool is None and threading.active_count() == started

    for j in range(r0, r1):
        n = len(enc[j]) if j < len(enc) else 0
        row = bytes(rows[j - r0].numpy())
        assert lengths[j - r0] == n and row[:n] == (enc[j] if n else b"")
        assert set(row[n:]) <= {SENTINEL}
    cut = te._fill_pieces(staged)
    sizes = [sum(n for _, _, n in piece) for piece in cut]
    assert sum(sizes) == total and len(cut) == pieces
    assert all(size == PIECE for size in sizes[:-1]) and 0 < sizes[-1] <= PIECE
    base = staged.buffer.data_ptr()
    for piece in cut:
        for dst, _, n in piece:
            i = (dst - base) // staged.stride
            assert n > 0 and dst + n <= base + i * staged.stride + lengths[i]


def test_split_fill_raises_a_thread_failure(monkeypatch):
    """A failure in one of the pool's threads is raised in the caller,
    once every share has returned."""
    monkeypatch.setattr(te, "FILL_PIECE", PIECE)
    monkeypatch.setattr(te, "fill_cores", lambda: 3)
    caller, copy, done = threading.get_ident(), te._copy_share, []

    def share(pieces):
        if threading.get_ident() != caller:
            raise RuntimeError("a pool thread failed")
        copy(pieces)
        done.append(len(pieces))

    monkeypatch.setattr(te, "_copy_share", share)
    ring = te.ByteRing(pinned=False)
    staged = ring.reserve(["ACGT" * 100] * 4)
    with pytest.raises(RuntimeError, match="a pool thread failed"):
        ring.fill(staged)
    assert done == [len(range(0, -(-1600 // PIECE), 3))]  # the caller's share, copied


@pytest.mark.parametrize("piece", ["one", "split"])
def test_step_counts_the_fill(trained, monkeypatch, piece):
    """``serve.fill_split``, ``serve.fill_pieces`` and
    ``serve.fill_threads`` a served batch on the bytes wire: a batch of
    one piece is copied on the calling thread (no pool started); a split
    batch takes at most its pieces and the cores in threads."""
    from torch.profiler import ProfilerActivity, profile

    _, params, seqs = trained
    total = sum(len(s.encode()) for s in seqs)
    size = total if piece == "one" else 16
    monkeypatch.setattr(te, "FILL_PIECE", size)
    step = DeviceStep(params, "dense", wire="bytes")
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                step.materialize(step.dispatch(seqs))
        counts = dict(trace.COUNTS)
    finally:
        trace.reset()
    pieces = -(-total // size)
    threads = min(pieces, te.fill_cores())
    assert counts["serve.batches"] == 2
    assert counts["serve.fill_pieces"] == 2 * pieces
    assert counts["serve.fill_threads"] == 2 * threads
    assert counts["serve.fill_threads"] <= min(counts["serve.fill_pieces"],
                                               2 * len(os.sched_getaffinity(0)))
    assert counts["serve.fill_split"] == (2 if threads > 1 else 0)
    assert (step._ring._pool is None) == (threads == 1)


# ---------------- the serving step -----------------------------------------

from test_torch_trace import trained  # noqa: E402,F401


@pytest.mark.parametrize("path", ["dense", "bag"])
def test_device_step_bytes_equal_to_codes(trained, path):  # noqa: F811
    _, params, seqs = trained
    seqs = seqs + ["AC-GT" * 20, "", "-" * 10, "ACGTNé" * 15]
    got, want = DeviceStep(params, path, wire="bytes"), DeviceStep(params, path)
    assert want.wire == "codes"  # the default on the CPU
    for batch in (seqs, seqs[3:], seqs):  # both slots, then the first again
        a, b = got.materialize(got.dispatch(batch)), want.materialize(want.dispatch(batch))
        assert a.shape == (len(batch), params.class_coords.shape[0])
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


def trained_params(device="cpu"):
    """A 5-class twister trained on the host at k = 4 (as
    tests/test_torch_trace.py's fixture), its parameters on ``device``, and
    queries of several lengths."""
    from kpop_tpu_torch.core.count import spectrum_of_sequences
    from kpop_tpu_torch.core.counter_db import CounterDB
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.core.space import Distance, Metric
    from kpop_tpu_torch.core.twister import twist_counter_db
    from kpop_tpu_torch.ops.pipeline import build_classifier_params

    rng = np.random.default_rng(11)
    space = KmerSpace("DNA-ds", K)
    db = CounterDB()
    genomes = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(5)]
    for c, seq in enumerate(genomes):
        codes, counts = spectrum_of_sequences(space, [seq])
        db.add_spectra_stream(io.StringIO("\tS%d\n" % c + "".join(
            "%s\t%d\n" % (space.code_to_hex(cd), ct) for cd, ct in zip(codes, counts))))
    twister, twisted, _ = twist_counter_db(db, backend="host")
    coords = np.asarray(twisted.matrix.data, dtype=np.float64)
    params = build_classifier_params(space, twister, coords, distance=Distance.of_string(
        "euclidean"), metric=Metric.of_string("powers(1,1,2)"), device=device,
        dtype=torch.float32)
    seqs = [g[i: i + 60 + 11 * i] for i, g in enumerate(genomes)] + ["AC-GTN" * 9, ""]
    return params, seqs


def worker(rank: int, world: int, port: int, workdir: str) -> int:
    """One gloo rank: the step on the bytes wire, at dp = 2 (the batch's
    rows split, with a padding row) and at kp = 2 (the twister's rows
    split), against the codes wire on the same layout and one rank.  The
    rank's fill is split into pieces of ``PIECE`` bytes, on its share of
    the host's cores."""
    from kpop_tpu_torch.parallel import distributed
    from kpop_tpu_torch.parallel.mesh import make_mesh
    from kpop_tpu_torch.parallel.serving import shard_classifier_params, sharded_dmat_fn

    torch.set_num_threads(1)
    distributed.initialize(f"tcp://localhost:{port}", world, rank, backend="gloo")
    te.FILL_PIECE = PIECE
    assert te.fill_cores() == max(1, len(os.sched_getaffinity(0)) // world)
    params, seqs = trained_params()
    one = DeviceStep(params, "dense", wire="codes")
    want = one.materialize(one.dispatch(seqs))
    assert len(seqs) % 2 == 1  # rank 1 holds a padding row at dp = 2
    dp2, kp2 = make_mesh(data_parallel=2), make_mesh(data_parallel=1)
    sharded, v = shard_classifier_params(params, kp2, "cpu")
    steps = {
        "dp2": lambda wire: DeviceStep(params, "dense", mesh=dp2, wire=wire),
        "kp2": lambda wire: DeviceStep(sharded, mesh=kp2, dmat=sharded_dmat_fn(kp2, v),
                                       wire=wire),
    }
    for name, make in steps.items():
        got = {}
        for wire in ("bytes", "codes"):
            step = make(wire)
            got[wire] = step.materialize(step.dispatch(seqs))
        assert np.array_equal(got["bytes"], got["codes"]), name
        np.testing.assert_allclose(got["bytes"], want, rtol=1e-5, atol=1e-6, err_msg=name)
    assert "jax" not in sys.modules and "kpop_tpu" not in sys.modules
    open(os.path.join(workdir, f"ok.{rank}"), "w").close()
    distributed.shutdown()
    return 0


def test_two_ranks_serve_the_bytes_wire(tmp_path):
    from test_torch_distributed import run_job

    run_job(str(tmp_path), 2, script=os.path.abspath(__file__))
    assert all((tmp_path / f"ok.{r}").exists() for r in range(2))


# ---------------- on a card -------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/encode_bytes.cu runs only there")
    monkeypatch.setenv("KPOP_PLATFORM", "cuda")
    return torch.device("cuda", 0)


def read_set_batch(rng, B: int, L: int, dash_share: float, alphabet: str) -> list[str]:
    """``B`` strings of ``L`` characters of ``alphabet``, ``N`` joins, and
    about ``dash_share`` of them dashes in runs."""
    letters = np.frombuffer(alphabet.encode(), dtype=np.uint8)
    out = []
    for _ in range(B):
        raw = letters[rng.integers(0, len(letters), size=L)]
        raw[rng.integers(0, L, size=L // 300)] = ord("N")
        for at in rng.integers(0, L, size=int(L * dash_share / 8)):
            raw[at: at + 8] = ord("-")
        out.append(raw.tobytes().decode())
    return out


@pytest.mark.card
@pytest.mark.parametrize("case", ["dna", "protein", "ragged"])
def test_kernel_equal_to_plain_version(card, case):
    rng = np.random.default_rng(2718281903)
    if case == "ragged":  # every length around the chunk and vector edges
        lengths = [0, 1, 15, 16, 17, 4095, 4096, 4097, 8191, 12_289, 40_000]
        seqs = ["".join(rng.choice(ALPHABET, size=n)) for n in lengths]
        seqs += ["-" * 5000, "---A" * 3000, "ACGT-" * 2000]
    else:
        seqs = read_set_batch(rng, 64, 601_885, 0.01,
                              "ACDEFGHIKLMNPQRSTVWY" if case == "protein" else "ACGT")
    protein = case == "protein"
    ring = te.ByteRing(pinned=True)
    staged = ring.reserve(seqs)
    ring.fill(staged)
    table = torch.from_numpy(TABLE[protein]).to(card)
    dev = staged.buffer.to(card)
    width = max(staged.longest, 1)
    got = te.encode_bytes(*staged.split(dev), width, table)
    want = te.encode_bytes_ref(*staged.split(dev), width, table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "ragged":
        assert_same_codes(got.cpu().numpy(), native.encode_batch(seqs, protein))
        narrow = te.encode_bytes(*staged.split(dev), 5000, table)
        assert torch.equal(narrow, te.encode_bytes_ref(*staged.split(dev), 5000, table))


@pytest.mark.card
def test_kernel_refuses_rows_off_its_alignment(card):
    """The kernel's own checks: a stride that is not a multiple of 16, or
    rows off a 16-byte boundary, raise through ``_build.launch``."""
    table = torch.from_numpy(TABLE[False]).to(card)
    lengths = torch.full((4,), 20, dtype=torch.int32, device=card)
    buf = torch.zeros(4 * 48 + 16, dtype=torch.uint8, device=card)
    assert te.encode_bytes(buf[:4 * 48].view(4, 48), lengths, 48, table).shape == (4, 48)
    with pytest.raises(RuntimeError, match="kpop_encode_bytes"):
        te.encode_bytes(buf[:4 * 40].view(4, 40), lengths, 40, table)
    with pytest.raises(RuntimeError, match="kpop_encode_bytes"):
        te.encode_bytes(buf[1:1 + 4 * 48].view(4, 48), lengths, 48, table)


@pytest.mark.card
@pytest.mark.parametrize("path", ["dense", "bag"])
def test_step_on_a_card_takes_the_bytes_wire(card, path):
    params, seqs = trained_params(card)
    step, codes = DeviceStep(params, path), DeviceStep(params, path, wire="codes")
    assert step.wire == "bytes"
    for batch in (seqs, seqs[2:], seqs):
        a, b = step.materialize(step.dispatch(batch)), codes.materialize(codes.dispatch(batch))
        assert np.array_equal(a, b)
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    before = _build.LAUNCHES["kpop_encode_bytes"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            step.materialize(step.dispatch(seqs))
    counted = trace.counters()
    trace.reset()
    assert counted["serve.batches"] == 3
    assert counted["launch.kpop_encode_bytes"] - before == counted["serve.batches"]


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
