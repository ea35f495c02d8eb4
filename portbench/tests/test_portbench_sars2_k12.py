"""The cell ``sars2-k12-genomes`` and the bag's readers: the
configuration, traffic and cell are found by name, the configuration
reckons the twister the card holds, the cell runs at small sizes on the
CPU with ``correct`` true and every batch on the bag route;
``classify.bag_ms`` reads the bag's kernels and ``classify.bag_roofline``
the batches' least time (the driver's work count) over them, and neither
reads anything where the bag's kernels or the work count are missing."""

import json
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from kpop_tpu_torch import trace
from portbench import harness
from portbench.roofline import classify_loop as classify_loop_roofline
from portbench.reference.kmers import canonical_codes
from portbench.tests import small
from portbench.trace import TraceView, profiler_events

READERS = ["classify.bag_ms", "classify.bag_roofline"]
#: names the profiler gives two of the bag's kernels on the card
HISTOGRAM = ("void (anonymous namespace)::bag_histogram<kpop::CodeWire, kpop::LutFind>"
             "(kpop::CodeWire::Byte const*, unsigned char const*, int, int, int, int)")
GATHER = "void (anonymous namespace)::bag_gather<float>(int4 const*, int const*, int)"


@pytest.fixture
def counts():
    trace.reset()
    yield trace.COUNTS
    trace.reset()


def ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def view_of(driver: str, bag: bool = True) -> TraceView:
    """Two served batches in a window of 1,000 µs: per batch an upload of
    10 µs, the bag's histogram (4 µs) and gather (40 µs) overlapping by
    2 µs, the distance tile (5 µs); without ``bag`` the dense route's count
    and product in their place."""
    events = [ev("pb:window", 0.0, 1000.0)]
    for b0 in (0.0, 500.0):
        events += [ev("pb:classify.dispatch", b0 + 10, b0 + 200),
                   ev("Memcpy HtoD", b0 + 150, b0 + 160, DeviceType.CUDA),
                   ev("dist_tile_kernel", b0 + 200, b0 + 205, DeviceType.CUDA)]
        if bag:
            events += [ev(HISTOGRAM, b0 + 160, b0 + 164, DeviceType.CUDA),
                       ev(GATHER, b0 + 162, b0 + 202, DeviceType.CUDA)]
        else:
            events += [ev("count_slices", b0 + 160, b0 + 185, DeviceType.CUDA),
                       ev("sm80_xmma_gemm_f32f32", b0 + 185, b0 + 199, DeviceType.CUDA)]
    device, spans = profiler_events(SimpleNamespace(events=lambda: events))
    return TraceView(driver, device, spans, [1e-6, 1e-6])


def test_cell_is_found_by_name():
    cell = harness.load_json("cells", "sars2-k12-genomes")
    cfg = harness.load_json("configs", cell["config"])
    tr = harness.load_json("traffic", cell["traffic"])
    assert (cell["driver"], cell["chips"]) == ("classify_loop", 1)
    assert cell["limits"] == harness.load_json("cells", "sars2-genomes")["limits"]
    # the k = 10 configuration with k = 12, nothing else changed or cut
    k10 = harness.load_json("configs", "sars2-lineages-k10")
    differ = {key for key in cfg.keys() | k10.keys() if cfg.get(key) != k10.get(key)}
    assert differ == {"name", "source", "deployment", "k", "assumed"}
    assert (cfg["k"], cfg["reduced"]) == (12, [])
    assert tr == dict(harness.load_json("traffic", "genomes64"), project_path="bag")
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    [entry] = [w for w in bench["workloads"] if w["name"] == "sars2-k12-genomes"]
    assert (entry["config"], entry["traffic"], entry["chips"], entry["why"]) == (
        cell["config"], cell["traffic"], 1, cell["why"])
    [conf] = [c for c in bench["configs"] if c["name"] == cell["config"]]
    assert conf["file"] == "portbench/configs/sars2-lineages-k12.json" and conf["reduced"] == []
    metrics = {m["name"]: m for m in bench["per_layer"] + bench["end_to_end"]}
    assert all(metrics[n]["workloads"] == ["sars2-k12-genomes"] for n in READERS)
    assert all("sars2-k12-genomes" not in metrics[n]["workloads"]
               for n in ("classify.count_ms", "classify.count_roofline"))


def test_configuration_reckons_the_twister():
    """Every canonical 12-mer a row, d = classes - 1 f32 columns: the
    54,874,890,240 B the card holds, and a genome's windows hit at most
    0.36 % of its rows."""
    cfg = harness.load_json("configs", "sars2-lineages-k12")
    V = len(canonical_codes(cfg["k"]))
    assert V == (4**12 + 4**6) // 2 == 8_390_656
    assert V * (cfg["classes"] - 1) * 4 == 54_874_890_240
    assert str(V) in cfg["deployment"].replace(",", "")
    windows = cfg["genome_length"] - cfg["k"] + 1
    assert windows == 29_892 and round(100 * windows / V, 2) == 0.36


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_small_and_correct(traced, counts):
    run = small.load("sars2-k12-genomes", seed=2**31 + 31, traced=traced)
    out = harness.execute(run, 0.3, time.perf_counter(), on_card=False)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    if not traced:
        assert set(out["metrics"]) == {"classify_seqs_per_s", "classify_p95_ms", "setup_s"}
        assert not counts
        return
    # every batch of the window took the bag, and none the count
    units = harness.driver("classify_loop").work(run)
    assert counts["serve.route.bag"] == counts["serve.batches"] == len(units) > 0
    assert not counts["serve.route.dense"] and not counts["serve.count_bytes"]
    assert all(0 < u["rows"] < u["pairs"] for u in units)
    assert not set(READERS) & set(out["metrics"])  # no kernel on the CPU


@pytest.mark.parametrize("driver", ["classify_loop", "classify_loop_long"])
def test_bag_readers_read_the_bag(driver):
    readers = harness.metric_readers()
    assert set(READERS) <= set(readers)
    view = view_of(driver)
    assert readers["classify.bag_ms"].read(view) == pytest.approx(0.042)  # (4 + 40 - 2) µs
    # the two batches' least time over the bag's 84 µs
    assert readers["classify.bag_roofline"].read(view) == pytest.approx(100.0 * 2e-6 / 84e-6)
    # a sound work count: bytes and operations that the kernels' 84 µs could move at best
    unit = dict(rows=3_000, d=1_635, itemsize=4, C=1_636, bases=64 * 29_903, B=64,
                pairs=90_000)
    view.least = [classify_loop_roofline.least_seconds(unit)] * 2
    share = readers["classify.bag_roofline"].read(view)
    assert share == pytest.approx(100.0 * sum(view.least) / 84e-6)
    assert 0 < share <= 100


def test_bag_readers_read_nothing_without_a_bag():
    readers = {n: m for n, m in harness.metric_readers().items() if n in READERS}
    assert all(m.read(view_of("classify_loop", bag=False)) is None
               for m in readers.values())  # the dense route: no bag kernel
    assert all(m.read(view_of("another_driver")) is None for m in readers.values())
    view = view_of("classify_loop")
    view.least = []  # no work counted
    assert readers["classify.bag_roofline"].read(view) is None
    assert readers["classify.bag_ms"].read(view) == pytest.approx(0.042)
