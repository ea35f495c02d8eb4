"""The cell ``sars2-summarize`` and its readers: the configuration, traffic
and cell are found by name and hold upstream's sizes; the cell runs at
small sizes on the CPU with ``correct`` true, and a listed distance
altered where it is made or half a batch's lines left out read
``correct`` false; a port without the engine's step stops before any
work; the roofline's least time and the six ``summarize.*`` readers give
numbers on a synthetic trace and nothing for another driver."""

import copy
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import kpop_tpu_torch.ops.summaries as summaries
from kpop_tpu_torch import trace
from portbench import harness, peaks
from portbench.drivers import classify_loop, summarize_loop
from portbench.roofline import summarize_loop as roofline
from portbench.tests import small
from portbench.trace import TraceView, profiler_events

READERS = ["summarize.device_ms", "summarize.idle_pct", "summarize.tile_roofline",
           "summarize.digest_roofline", "summarize.stage_ms", "summarize.format_ms"]
#: names the profiler gives the tile's and the digest's kernels on the card
TILE = "void (anonymous namespace)::dist_tile_kernel<false>(float const*, float const*, int)"
NORMS = "(anonymous namespace)::weighted_norms_kernel(float const*, float const*, int)"
DIGEST = "(anonymous namespace)::row_digest_staged(float const*, int, int, float*)"


@pytest.fixture
def counts():
    trace.reset()
    yield trace.COUNTS
    trace.reset()


def load(seed: int = 2**33 + 5, traced: bool = False, queries: int = 45, batch: int = 8):
    """A run of the cell at small sizes on the CPU: ``queries`` rows of the
    small classifier's 6 lineages, ``batch`` a batch."""
    cell = copy.deepcopy(harness.load_json("cells", "sars2-summarize"))
    cell["limits"] = {k: small.LIMITS.get(k, v) for k, v in cell["limits"].items()}
    cfg = dict(small.config(cell["config"]), queries=queries)
    tr = dict(harness.load_json("traffic", cell["traffic"]), batch=batch)
    return harness.load_run("sars2-summarize", seed, torch.device("cpu"), traced, cell=cell,
                            config=cfg, traffic=tr)


def outcome(traced: bool = False) -> dict:
    return harness.execute(load(traced=traced), 0.3, time.perf_counter(), on_card=False)


def test_cell_is_found_by_name():
    cell = harness.load_json("cells", "sars2-summarize")
    cfg = harness.load_json("configs", cell["config"])
    assert (cell["driver"], cell["chips"]) == ("summarize_loop", 1)
    assert cell["limits"] == {"rank_gap": 2e-5, "line_gap": 5e-5, "lines_wrong": 0}
    assert harness.load_json("traffic", cell["traffic"]) == dict(
        batch=1024, keep_at_most=2, backend="pallas")
    # sars2-lineages-k10's classifier, with the queries of -s added
    k10 = harness.load_json("configs", "sars2-lineages-k10")
    differ = {key for key in cfg.keys() | k10.keys() if cfg.get(key) != k10.get(key)}
    assert differ == {"name", "source", "deployment", "assumed", "queries", "query_noise",
                      "distance_normalize"}
    assert cfg["distance_normalize"] is True and cfg["reduced"] == []
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    [entry] = [w for w in bench["workloads"] if w["name"] == "sars2-summarize"]
    assert (entry["config"], entry["traffic"], entry["chips"], entry["why"]) == (
        cell["config"], cell["traffic"], 1, cell["why"])
    [conf] = [c for c in bench["configs"] if c["name"] == cell["config"]]
    assert conf["file"] == "portbench/configs/sars2-lineages-k10-summarize.json"
    assert conf["reduced"] == [] and conf["source"] == cfg["source"]
    metrics = {m["name"]: m for m in bench["per_layer"] + bench["end_to_end"]}
    assert all(metrics[n]["workloads"] == ["sars2-summarize"] for n in READERS)
    assert all("sars2-summarize" in metrics[n]["workloads"] for n in (
        "classify_seqs_per_s", "classify_p95_ms", "classify.host_ms", "classify.wait_ms"))
    assert set(summarize_loop.END_TO_END) == {"classify_seqs_per_s", "classify_p95_ms"}


def test_configuration_sizes():
    """Upstream's test half: 641,847 float64 rows of d = 1,635 (8.4 GB, as
    Test.KPopTwisted holds them) against 1,636 lineages."""
    cfg = harness.load_json("configs", "sars2-lineages-k10-summarize")
    d = cfg["classes"] - 1
    assert (cfg["queries"], d, cfg["classes"]) == (641_847, 1_635, 1_636)
    assert cfg["queries"] * d * 8 == 8_395_358_760
    assert "8,395,358,760" in cfg["deployment"] and "641,847" in cfg["source"]


def test_twisted_rows_follow_the_seed():
    coords = np.random.default_rng(0).standard_normal((5, 7))
    seeds = harness.load_run("sars2-summarize", 2**32 + 3, torch.device("cpu"), False).seeds
    rows, lineage = summarize_loop.twisted_rows(coords, 40, 0.05, seeds)
    again, same = summarize_loop.twisted_rows(coords, 40, 0.05, seeds)
    assert rows.shape == (40, 7) and rows.dtype == np.float64 and lineage.shape == (40,)
    assert np.array_equal(rows, again) and np.array_equal(lineage, same)
    # each row lies near its lineage: the noise's norm about 0.05 |c|
    gap = np.linalg.norm(rows - coords[lineage], axis=1) / np.linalg.norm(coords[lineage], axis=1)
    assert 0 < gap.max() < 0.2


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_small_and_correct(traced, counts):
    run = load(traced=traced)
    out = harness.execute(run, 0.3, time.perf_counter(), on_card=False)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"rank_gap", "line_gap", "lines_wrong"}
    if not traced:
        assert set(out["metrics"]) == {"classify_seqs_per_s", "classify_p95_ms", "setup_s"}
        assert not counts
        return
    # the step's spans and counters over the window's batches (a wrapping
    # batch among them), and no device metric on the CPU
    units = summarize_loop.work(run)
    assert counts["relate.batches"] == len(units) > 0
    assert counts["relate.queries"] == 8 * len(units)
    assert set(out["metrics"]) == {"classify.host_ms", "classify.wait_ms",
                                   "summarize.stage_ms", "summarize.format_ms"}


def test_batches_wrap_around_the_queries():
    run = load(queries=45, batch=8)
    assert summarize_loop.rows_of(run, 0).tolist() == list(range(8))
    assert summarize_loop.rows_of(run, 5).tolist() == [40, 41, 42, 43, 44, 0, 1, 2]
    assert summarize_loop.rows_of(run, 6).tolist() == list(range(3, 11))


def test_a_port_without_the_step_stops_before_any_work(monkeypatch):
    monkeypatch.delattr(summaries, "SummaryStep")
    monkeypatch.setattr(classify_loop, "corpus", lambda run: pytest.fail("corpus was built"))
    with pytest.raises(ImportError):
        summarize_loop.setup(load())


def test_altered_distance_is_not_correct(monkeypatch):
    real = summaries.query_distances

    def altered(*args, **kw):  # each row's nearest distance altered where it is made
        d = real(*args, **kw)
        d[torch.arange(len(d)), d.argmin(dim=1)] += 0.05
        return d

    monkeypatch.setattr(summaries, "query_distances", altered)
    assert outcome()["correct"] is False


def test_half_a_batch_left_out_is_not_correct(monkeypatch):
    real = summaries.SummaryStep.materialize

    def half(self, handle):
        lines = real(self, handle).split("\n")[:-1]
        return "".join(line + "\n" for line in lines[: len(lines) // 2])

    monkeypatch.setattr(summaries.SummaryStep, "materialize", half)
    out = outcome()
    assert out["correct"] is False and out["failed"] > 0


def test_least_seconds_by_hand():
    u = dict(B=1024, N=1636, d=1635, k=2)
    ops = 2 * 1024 * 1636 * 1635
    tile_bytes = (1024 + 1636) * 1635 * 4 + 1024 * 1636 * 4
    least = roofline.least_seconds(u)
    assert ops / peaks.TF32_FLOPS > (tile_bytes + 1024 * 40) / peaks.HBM_BYTES_PER_S
    assert float(least) == pytest.approx(ops / 495e12)
    assert least.tile == pytest.approx(ops / 495e12)
    assert least.digest == pytest.approx(1024 * 1636 * 4 / 3.35e12)
    # a narrow batch: the bytes bound it
    u = dict(B=4096, N=100_000, d=4, k=16)
    nbytes = (4096 + 100_000) * 16 + 4096 * 100_000 * 4
    assert float(roofline.least_seconds(u)) == pytest.approx(
        (nbytes + 4096 * (16 + 12 * 16)) / 3.35e12)
    assert roofline.least_seconds(u).tile == pytest.approx(nbytes / 3.35e12)


def ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def view_of(driver: str) -> TraceView:
    """Two batches in a window of 1,000 µs: per batch an upload of 10 µs,
    the norms (2 µs) and the tile (20 µs), the digest (8 µs) and a
    download of 1 µs."""
    events = [ev("pb:window", 0.0, 1000.0)]
    for b0 in (0.0, 500.0):
        events += [ev("pb:classify.dispatch", b0 + 10, b0 + 100),
                   ev("Memcpy HtoD", b0 + 100, b0 + 110, DeviceType.CUDA),
                   ev(NORMS, b0 + 110, b0 + 112, DeviceType.CUDA),
                   ev(TILE, b0 + 112, b0 + 132, DeviceType.CUDA),
                   ev(DIGEST, b0 + 132, b0 + 140, DeviceType.CUDA),
                   ev("Memcpy DtoH", b0 + 140, b0 + 141, DeviceType.CUDA)]
    device, spans = profiler_events(SimpleNamespace(events=lambda: events))
    return TraceView(driver, device, spans, [roofline.Least(3e-6, 2e-6, 1e-6)] * 2)


def test_readers_read_a_synthetic_trace(counts):
    counts.update({"relate.stage.ns": 3_000_000, "relate.stage.calls": 2,
                   "relate.format.ns": 5_000_000, "relate.format.calls": 2})
    readers = harness.metric_readers()
    assert set(READERS) <= set(readers)
    view = view_of("summarize_loop")
    got = {n: readers[n].read(view) for n in READERS}
    assert got == pytest.approx({
        "summarize.device_ms": 0.041,  # 2 x 41 µs over 2 batches
        "summarize.idle_pct": 100.0 * (1 - 82e-6 / 1e-3),
        "summarize.tile_roofline": 100.0 * 4e-6 / 44e-6,
        "summarize.digest_roofline": 100.0 * 2e-6 / 16e-6,
        "summarize.stage_ms": 1.5, "summarize.format_ms": 2.5})
    # the classify readers of the benchmark's own spans read the cell too
    assert readers["classify.host_ms"].read(view) == pytest.approx(0.09)


def test_readers_read_nothing_elsewhere(counts):
    counts.update({"relate.stage.ns": 3_000_000, "relate.stage.calls": 2})
    readers = harness.metric_readers()
    for driver in ("classify_loop", "classify_loop_long", "another_driver"):
        assert all(readers[n].read(view_of(driver)) is None for n in READERS)
    view = view_of("summarize_loop")
    view.least = [3e-6, 3e-6]  # a work count without its parts
    assert readers["summarize.tile_roofline"].read(view) is None
    assert readers["summarize.digest_roofline"].read(view) is None
    trace.reset()  # a port that counted nothing
    assert readers["summarize.stage_ms"].read(view) is None
