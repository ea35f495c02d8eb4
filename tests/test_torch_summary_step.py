"""kpop_tpu_torch.ops.summaries.SummaryStep, the relatedness engine of
``kpop-twistdb -s`` as a step, against the benchmark's plain reference
(``portbench/reference/classify.py``: float64 distances, a line's numbers
and its nearest targets in (distance, index) order).

On the CPU the step runs the code it runs on a card, on host tensors: the
slots, the cast into them, the query distances (the tile route for
euclidean under ``"pallas"``, the matmul route otherwise), the digest and
the formatter.  Bounds: names and nearest targets equal to the
reference's, numbers within 2e-4 * max(1, |x|) (float32 distances, as
tests/test_torch_summaries.py).  This file imports nothing of JAX."""

import io

import numpy as np
import pytest
import torch

import kpop_tpu_torch.ops.summaries as ts
from kpop_tpu_torch import native, trace
from kpop_tpu_torch.core.matrix import NamedMatrix
from kpop_tpu_torch.core.space import Distance
from portbench.reference import classify as ref

BOUND = 2e-4
N, D = 37, 23


def plain_distances(spec: str, metric, targets, queries, normalize: bool) -> np.ndarray:
    """Float64 distances ``[queries, targets]``: each row divided by its own
    norm under the distance (0 -> 1) where ``normalize``, then the weighted
    sum of |a - b|^p scaled as the distance scales it (euclidean sqrt,
    cosine /2, minkowski ^(1/p))."""
    t, q, m = (torch.as_tensor(x, dtype=torch.float64) for x in (targets, queries, metric))
    if spec == "euclidean" and normalize:
        return ref.distances(q, t, m, "f64").numpy()
    p = 3.0 if spec == "minkowski(3)" else 2.0

    def scale(acc):
        return {"euclidean": acc.sqrt(), "cosine": acc / 2.0}.get(spec, acc ** (1.0 / p))

    if normalize:
        norms = [scale((x.abs() ** p * m).sum(dim=1)) for x in (t, q)]
        t, q = (x / torch.where(n == 0, torch.ones_like(n), n)[:, None]
                for x, n in zip((t, q), norms))
    return scale(((q[:, None, :] - t[None, :, :]).abs() ** p * m).sum(dim=2)).numpy()


def make_case(seed: int, B: int):
    rng = np.random.default_rng(seed)
    targets = NamedMatrix([f"t{i}" for i in range(N)], [f"d{j}" for j in range(D)],
                          rng.standard_normal((N, D)))
    queries = NamedMatrix([f"q{i}" for i in range(B)], [f"d{j}" for j in range(D)],
                          rng.standard_normal((B, D)))
    metric = rng.random(D)
    return targets, queries, metric / metric.sum()


def served(step: ts.SummaryStep, queries: NamedMatrix, batch: int) -> list[str]:
    """The step's texts, a batch at a time, with one batch in flight."""
    texts, pending = [], None
    for lo in range(0, queries.n_rows, batch):
        handle = step.dispatch(queries.data[lo : lo + batch], queries.row_names[lo : lo + batch])
        if pending is not None:
            texts.append(step.materialize(pending))
        pending = handle
    texts.append(step.materialize(pending))
    return texts


def assert_lines_match_reference(lines, queries, targets, rows, keep):
    keep = N if keep is None else keep
    assert len(lines) == queries.n_rows
    for line, name, row in zip(lines, queries.row_names, rows):
        want = ref.format_line(name, row, targets.row_names, keep).split("\t")
        got = line.split("\t")
        assert got[0] == name and len(got) == len(want), (line, want)
        assert got[5::3] == want[5::3], (line, want)
        for a, b in zip(got[1:], want[1:]):
            if a not in targets.row_names:
                assert abs(float(a) - float(b)) < BOUND * max(1.0, abs(float(b))), (line, want)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("keep", [2, None])
@pytest.mark.parametrize("spec,backend", [("euclidean", "pallas"), ("cosine", "jax"),
                                          ("minkowski(3)", "jax")])
def test_step_matches_plain_reference(spec, backend, keep, normalize):
    """Batches of 5 and a ragged last one of 3, against the plain float64
    distances' lines."""
    targets, queries, metric = make_case(3, B=23)
    step = ts.SummaryStep(Distance.of_string(spec), metric, targets, keep, normalize,
                          backend, batch=5)
    texts = served(step, queries, 5)
    assert [t.count("\n") for t in texts] == [5, 5, 5, 5, 3]
    lines = "".join(texts).split("\n")[:-1]
    rows = plain_distances(spec, metric, targets.data, queries.data, normalize)
    assert_lines_match_reference(lines, queries, targets, rows, keep)


@pytest.mark.parametrize("spec,backend", [("euclidean", "pallas"), ("cosine", "jax")])
def test_rowwise_is_the_step_a_batch_at_a_time(spec, backend):
    targets, queries, metric = make_case(4, B=17)
    dist = Distance.of_string(spec)
    buf = io.StringIO()
    n = ts.summarize_rowwise_device(dist, metric, targets, queries, 2, True, buf,
                                    batch=4, backend=backend)
    step = ts.SummaryStep(dist, metric, targets, 2, True, backend, batch=4)
    assert n == 17
    assert buf.getvalue() == "".join(step.materialize(step.dispatch(
        queries.data[lo : lo + 4], queries.row_names[lo : lo + 4])) for lo in range(0, 17, 4))


def tie_case():
    """20 equal targets (a tie group beyond 2 + TOPK_SLACK) and queries of
    which rows 1 and 6 lie next to them."""
    targets, queries, metric = make_case(5, B=9)
    targets.data[5:25] = targets.data[5]
    queries.data[[1, 6]] = targets.data[5] + 1e-3
    return targets, queries, metric


@pytest.mark.parametrize("native_fmt", [True, False])
def test_overflowing_tie_group_falls_back_at_its_row(monkeypatch, native_fmt):
    if native_fmt and not ts._native_formatter():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(ts, "_native_formatter", lambda: native_fmt)
    targets, queries, metric = tie_case()
    dist = Distance.of_string("euclidean")
    step = ts.SummaryStep(dist, metric, targets, 2, True, "pallas", batch=4)
    lines = "".join(served(step, queries, 4)).split("\n")[:-1]
    rows = plain_distances("euclidean", metric, targets.data, queries.data, True)
    assert_lines_match_reference(lines, queries, targets, rows, 2)
    for j, line in enumerate(lines):
        groups = line.split("\t")[5::3]
        assert len(groups) == (20 if j in (1, 6) else 2)
        if j in (1, 6):  # the host float64 row: its squared distances to 1e-12
            got = np.array(line.split("\t")[6::3], dtype=np.float64)
            assert np.abs(got**2 - rows[j, 5:25] ** 2).max() < 1e-12


def test_no_fresh_buffers_in_the_loop(monkeypatch):
    """The target norms, the targets' upload and the names blob are made
    once a step; every batch reuses the step's two slots."""
    calls = {"norms": 0, "blob": 0, "upload": 0}
    targets, queries, metric = make_case(6, B=30)

    def counted(name, real):
        def f(*a, **kw):
            # the names blob of the targets; the queries' is made a batch
            calls[name] += name != "blob" or list(a[0]) == targets.row_names
            return real(*a, **kw)
        return f

    monkeypatch.setattr(ts, "_target_norms", counted("norms", ts._target_norms))
    monkeypatch.setattr(ts, "_to_device", counted("upload", ts._to_device))
    monkeypatch.setattr(native, "_names_blob", counted("blob", native._names_blob))
    step = ts.SummaryStep(Distance.of_string("euclidean"), metric, targets, 2, True,
                          "pallas", batch=4)
    buffers = [(s.host.data_ptr(), s.device.data_ptr(), *(h.data_ptr() for h in s.digests))
               for s in step._slots]
    made = dict(calls)
    assert len(served(step, queries, 4)) == 8
    assert calls == made and made["norms"] == 1 and made["upload"] == 3
    assert made["blob"] == (1 if ts._native_formatter() else 0)
    assert len(step._slots) == ts.SummaryStep.SLOTS == 2
    assert buffers == [(s.host.data_ptr(), s.device.data_ptr(),
                        *(h.data_ptr() for h in s.digests)) for s in step._slots]


def test_step_refuses_misuse():
    targets, queries, metric = make_case(7, B=12)
    step = ts.SummaryStep(Distance.of_string("euclidean"), metric, targets, 2, True,
                          "pallas", batch=4)
    with pytest.raises(ValueError):
        step.dispatch(queries.data[:5], queries.row_names[:5])  # above the batch
    with pytest.raises(ValueError):
        step.dispatch(queries.data[:3], queries.row_names[:2])  # names short
    first = step.dispatch(queries.data[:4], queries.row_names[:4])
    step.dispatch(queries.data[4:8], queries.row_names[4:8])
    with pytest.raises(RuntimeError):  # a third batch in flight
        step.dispatch(queries.data[8:], queries.row_names[8:])
    step.materialize(first)
    with pytest.raises(ValueError):
        step.materialize(first)


def test_spans_and_counters_under_a_profile():
    targets, queries, metric = tie_case()
    trace.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            buf = io.StringIO()
            ts.summarize_rowwise_device(Distance.of_string("euclidean"), metric, targets,
                                        queries, 2, True, buf, batch=4, backend="pallas")
        counts = dict(trace.COUNTS)
    finally:
        trace.reset()
    spans = ["dispatch", "stage", "upload", "launch", "download", "wait", "format"]
    for name in spans:
        assert counts["relate.%s.calls" % name] == 3 and counts["relate.%s.ns" % name] > 0
    assert counts["relate.batches"] == 3
    assert counts["relate.queries"] == queries.n_rows == 9
    assert counts["relate.upload_bytes"] == 9 * D * 4
    assert counts["relate.fallback_rows"] == 2
    names = {e.name for e in prof.events()}
    assert {trace.PREFIX + "relate." + s for s in spans} <= names


def test_spans_cost_nothing_without_a_profile():
    targets, queries, metric = make_case(8, B=6)
    trace.reset()
    ts.summarize_rowwise_device(Distance.of_string("euclidean"), metric, targets, queries,
                                2, True, io.StringIO(), batch=4, backend="pallas")
    assert not trace.COUNTS
