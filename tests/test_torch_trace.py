"""The port's spans and counters (kpop_tpu_torch/trace.py) on the CPU: off
without a profiler; under one, the serving step's ranges nest in order and
its counters count the batch; kpop-classify-torch --profile writes the
trace with the ranges and the counters beside it."""

import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kpop_tpu_torch import _build, trace
from kpop_tpu_torch.cli import classify
from kpop_tpu_torch.cli.classify import DeviceStep
from kpop_tpu_torch.core.count import spectrum_of_sequences
from kpop_tpu_torch.core.counter_db import CounterDB
from kpop_tpu_torch.core.kmers import KmerSpace
from kpop_tpu_torch.core.space import Distance, Metric
from kpop_tpu_torch.core.twister import twist_counter_db
from kpop_tpu_torch.ops.encode import encode_reads_host
from kpop_tpu_torch.ops.pipeline import build_classifier_params

K = 4


def random_seqs(rng, n, length):
    return ["".join(np.array(list("ACGT"))[rng.integers(0, 4, length)]) for _ in range(n)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 5-class twister trained on the host, its files, and queries of
    several lengths."""
    td = tmp_path_factory.mktemp("trace_torch")
    rng = np.random.default_rng(11)
    space = KmerSpace("DNA-ds", K)
    db = CounterDB()
    for c, seq in enumerate(random_seqs(rng, 5, 200)):
        codes, counts = spectrum_of_sequences(space, [seq])
        db.add_spectra_stream(io.StringIO("\tS%d\n" % c + "".join(
            "%s\t%d\n" % (space.code_to_hex(cd), ct) for cd, ct in zip(codes, counts))))
    twister, twisted, _ = twist_counter_db(db, backend="host")
    twister.to_binary(str(td / "TW"))
    twisted.to_binary(str(td / "TW"))
    seqs = [s[: 60 + 13 * i] for i, s in enumerate(random_seqs(rng, 6, 140))]
    with open(td / "q.fasta", "w") as f:
        f.writelines(">q%d\n%s\n" % (i, s) for i, s in enumerate(seqs))
    coords = np.asarray(twisted.matrix.data, dtype=np.float64)
    params = build_classifier_params(space, twister, coords, distance=Distance.of_string(
        "euclidean"), metric=Metric.of_string("powers(1,1,2)"), device="cpu",
        dtype=torch.float32)
    return td, params, seqs


@pytest.fixture
def counts():
    trace.reset()
    yield trace.COUNTS
    trace.reset()


def ranges(prof) -> dict[str, list[tuple[float, float]]]:
    out: dict[str, list[tuple[float, float]]] = {}
    for ev in prof.events():
        if ev.name.startswith(trace.PREFIX):
            out.setdefault(ev.name[len(trace.PREFIX):], []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def test_off_without_a_profiler(trained, counts):
    assert trace.span("serve.encode") is trace.span("serve.stage")
    with trace.span("serve.encode"):
        trace.count("serve.batches", 3)
    step = DeviceStep(trained[1], "dense")
    step.materialize(step.dispatch(trained[2]))
    assert not counts


def test_serving_step_ranges_nest_in_order(trained, counts):
    step = DeviceStep(trained[1], "dense")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dmat = step.materialize(step.dispatch(trained[2]))
    assert dmat.shape == (len(trained[2]), 5)
    got = ranges(prof)
    # the CPU has no upload, download or wait
    assert set(got) == {"serve.dispatch", "serve.encode", "serve.stage", "serve.launch",
                        "serve.materialize", "serve.gather"}
    assert all(len(v) == 1 for v in got.values())
    (d0, d1), (m0, m1) = got["serve.dispatch"][0], got["serve.materialize"][0]
    stages = [got[n][0] for n in ("serve.encode", "serve.stage", "serve.launch")]
    assert all(d0 <= s and e <= d1 for s, e in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    g0, g1 = got["serve.gather"][0]
    assert d1 <= m0 <= g0 and g1 <= m1
    for name in got:
        assert counts[name + ".calls"] == 1 and counts[name + ".ns"] > 0


@pytest.mark.parametrize("wire", ["codes", "bytes"])
@pytest.mark.parametrize("path", ["auto", "bag"])
def test_counters_count_the_batch(trained, counts, path, wire):
    _, params, seqs = trained
    step = DeviceStep(params, path, wire=wire)
    with profile(activities=[ProfilerActivity.CPU]):
        step.materialize(step.dispatch(seqs))
    codes = encode_reads_host(seqs)
    B, L = codes.shape
    sent = {"codes": codes.nbytes,
            # rows at the longest rounded up to 16 bytes, then int32 lengths
            "bytes": B * (-(-max(map(len, seqs)) // 16) * 16 + 4)}[wire]
    # the count reads each row of codes and writes [B, V] f32
    count_bytes = B * (L + 4 * params.n_vocab) if step.path == "dense" else 0
    assert step.path in ("dense", "bag")
    # the bytes wire's fill: these strings make one piece, copied on the calling thread
    filled = {"serve.fill_split": 0, "serve.fill_pieces": 1, "serve.fill_threads": 1}
    assert {k: v for k, v in counts.items() if not k.endswith((".ns", ".calls"))} == {
        "serve.batches": 1, "serve.queries": len(seqs), "serve.bases": sum(map(len, seqs)),
        "serve.upload_bytes": sent, "serve.route." + step.path: 1,
        "serve.windows": sum(len(s) - K + 1 for s in seqs), "serve.long_rows": 0,
        "serve.count_bytes": count_bytes, "serve.count_bucketed": 0,
        **(filled if wire == "bytes" else {})}
    assert trace.counters()["launch.kpop_count_spectra"] == _build.LAUNCHES["kpop_count_spectra"]


@pytest.mark.parametrize("path", ["dense", "bag"])
def test_count_bucketed_counts_the_batches_of_the_bucketed_plan(trained, counts, monkeypatch,
                                                                 path):
    """``serve.count_bucketed`` counts a batch where the count takes the
    bucketed plan (here forced at these sizes: u32 counters past 10
    windows, slices of 16 cells), by the same ``count_plan`` the count
    reads; never on the bag route."""
    from kpop_tpu_torch.ops import pipeline as tp

    _, params, seqs = trained
    monkeypatch.setattr(tp, "COUNT_NARROW_MAX", 10)
    monkeypatch.setattr(tp, "COUNT_SLICE_BYTES", 64)
    L = max(map(len, seqs))
    assert tp.count_plan(L - K + 1, params.n_vocab).bucket
    step = DeviceStep(params, path)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            step.materialize(step.dispatch(seqs))
    assert counts["serve.batches"] == 2
    assert counts["serve.count_bucketed"] == (2 if path == "dense" else 0)


def test_classify_profile_writes_trace_and_counters(trained, monkeypatch, counts):
    td = trained[0]
    monkeypatch.setenv("KPOP_PLATFORM", "cpu")
    prof_dir = td / "prof"
    tw = str(td / "TW")
    assert classify.main(["-T", tw, "-t", tw, "-k", str(K), "-f", str(td / "q.fasta"),
                          "--batch", "4", "-o", str(td / "out"), "--profile",
                          str(prof_dir)]) == 0
    assert len((td / "out.KPopSummary.txt").read_text().splitlines()) == 6
    names = {ev["name"] for ev in json.loads((prof_dir / "kpop_classify_trace.json").read_text())
             ["traceEvents"]}
    assert {"kpop:serve.encode", "kpop:serve.format"} <= names
    got = json.loads((prof_dir / "kpop_classify_counters.json").read_text())
    assert got["serve.batches"] == 2 and got["serve.queries"] == 6
    assert got["serve.format.calls"] == 2
    assert set(got) >= {"launch." + name for name in _build.LAUNCHES}
