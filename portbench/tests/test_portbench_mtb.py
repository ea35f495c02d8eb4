"""The cell ``mtb-reads`` and the count's readers: the cell is found by
name and runs at small sizes on the CPU with ``correct`` true; its driver
counts the reference's queries one at a time and reads what
``classify_loop`` reads; ``classify.count_ms`` and
``classify.count_roofline`` read the count's kernels and the port's
``serve.count_bytes``, and nothing where either is missing."""

import json
import sys
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from kpop_tpu_torch import trace
from portbench import harness
from portbench.peaks import HBM_BYTES_PER_S
from portbench.reference import kmers
from portbench.tests import small
from portbench.trace import TraceView, profiler_events

READERS = ["classify.count_ms", "classify.count_roofline"]
#: the names the profiler gives the count's kernels on the card
SLICES = "void (anonymous namespace)::count_slices<true>(unsigned int const*, int const*, int)"
LOOKUP = ("void (anonymous namespace)::count_lookup<kpop::CodeWire, kpop::LutFind, false>"
          "(kpop::CodeWire::Byte const*, unsigned char const*, int)")


@pytest.fixture
def counts():
    trace.reset()
    yield trace.COUNTS
    trace.reset()


def ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def view_of(driver: str, kernels: bool = True) -> TraceView:
    """Two served batches in a window of 1,000 µs: per batch an upload of
    10 µs, the count's lookup (5 µs) and slices (20 µs), the product
    (8 µs); without ``kernels`` no count ran (the bag route)."""
    events = [ev("pb:window", 0.0, 1000.0)]
    for b0 in (0.0, 500.0):
        events += [ev("pb:classify.dispatch", b0 + 10, b0 + 200),
                   ev("Memcpy HtoD", b0 + 150, b0 + 160, DeviceType.CUDA),
                   ev("sm80_xmma_gemm_f32f32", b0 + 185, b0 + 193, DeviceType.CUDA)]
        if kernels:
            events += [ev(LOOKUP, b0 + 160, b0 + 165, DeviceType.CUDA),
                       ev(SLICES, b0 + 165, b0 + 185, DeviceType.CUDA)]
        else:
            events += [ev("bag_accumulate", b0 + 160, b0 + 185, DeviceType.CUDA)]
    device, spans = profiler_events(SimpleNamespace(events=lambda: events))
    return TraceView(driver, device, spans, [1e-6, 1e-6])


def load(seed: int, traced: bool = False):
    """The cell at ``small.py``'s sizes, its tree's rate raised: at 400
    bases the configuration's own rate leaves most targets' genomes equal
    (and a summary line's distances with them); this one differs them at
    about 5 % of their sites, 10 times more than an isolate from its
    target, as 4,400 and 440 SNPs do at the published length."""
    run = small.load("mtb-reads", seed=seed, traced=traced)
    run.config["tree"] = dict(run.config["tree"], rate=0.05)
    return run


def test_cell_is_found_by_name():
    cell = harness.load_json("cells", "mtb-reads")
    cfg = harness.load_json("configs", cell["config"])
    tr = harness.load_json("traffic", cell["traffic"])
    assert cell["chips"] == 1 and cell["driver"] == "classify_loop_long"
    assert (cfg["k"], cfg["classes"], cfg["genome_length"], cfg["reduced"]) == (12, 1000,
                                                                               4411532, [])
    assert (tr["batch"], tr["pool"], tr["keep_at_most"], tr["project_path"]) == (16, 24, 2, "auto")
    pairs = int(cfg["genome_length"] * tr["reads"]["coverage"] / (2 * tr["reads"]["read_len"]))
    assert 2 * pairs * (tr["reads"]["read_len"] + 1) - 1 == 88_818_803  # bases a read set
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    [entry] = [w for w in bench["workloads"] if w["name"] == "mtb-reads"]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (cell["config"],
                                                                   cell["traffic"], 1)
    assert harness.roofline(cell["driver"]).least_seconds is \
        harness.roofline("classify_loop").least_seconds


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_small_and_correct(traced):
    run = load(2**31 + 19, traced)
    out = harness.execute(run, 0.5, time.perf_counter(), on_card=False)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(run.cell["limits"])
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(out["metrics"]) == {"classify_seqs_per_s", "classify_p95_ms", "setup_s"}


def test_reference_counts_one_query_at_a_time(monkeypatch):
    """The driver's check counts each query alone, and reads the same
    numbers as ``classify_loop``'s, which counts 8 at a time."""
    seen = []
    counts_of = kmers.counts

    def spy(codes, k, lut, V, chunk=8):
        seen.append((codes.shape[0], chunk))
        return counts_of(codes, k, lut, V, chunk)

    run = load(2**31 + 23)
    drv = harness.driver(run.cell["driver"])
    drv.setup(run)
    drv.window(run, 0.3)
    drv.release(run)
    monkeypatch.setattr("portbench.gen.counts", spy)
    long = drv.check(run)
    assert seen and all(chunk == 1 for _, chunk in seen)
    del run.state["vocab"].counts  # back to the class's method, 8 at a time
    seen.clear()
    assert harness.driver("classify_loop").check(run) == long
    assert seen and all(chunk == 8 for _, chunk in seen)


@pytest.mark.parametrize("driver", ["classify_loop", "classify_loop_long"])
def test_count_readers_read_the_count(driver, counts):
    readers = harness.metric_readers()
    assert set(READERS) <= set(readers)
    view = view_of(driver)
    assert readers["classify.count_ms"].read(view) == pytest.approx(0.025)  # (5 + 20) µs
    assert readers["classify.count_roofline"].read(view) is None  # nothing counted
    counts["serve.count_bytes"] = 2 * 30_000_000
    share = readers["classify.count_roofline"].read(view)
    assert share == pytest.approx(100.0 * 60e6 / HBM_BYTES_PER_S / 50e-6)


def test_count_readers_read_nothing_without_a_count(counts, monkeypatch):
    readers = {n: m for n, m in harness.metric_readers().items() if n in READERS}
    counts["serve.count_bytes"] = 1000
    assert all(m.read(view_of("classify_loop", kernels=False)) is None
               for m in readers.values())  # the bag route: no count kernel
    assert all(m.read(view_of("another_driver")) is None for m in readers.values())
    counts.clear()
    assert readers["classify.count_roofline"].read(view_of("classify_loop")) is None
    counts["serve.count_bytes"] = 1000
    monkeypatch.setitem(sys.modules, "kpop_tpu_torch.trace", None)  # a port without it
    assert readers["classify.count_roofline"].read(view_of("classify_loop")) is None
    assert readers["classify.count_ms"].read(view_of("classify_loop")) == pytest.approx(0.025)


def test_traced_run_counts_the_count_bytes(counts):
    """The port's counter over a small traced run: codes at their stride
    and the f32 spectra, a row each, on the dense route (no kernel on the
    CPU, so no share is read)."""
    run = load(2**31 + 29, traced=True)
    out = harness.execute(run, 0.3, time.perf_counter(), on_card=False)
    assert out["correct"] is True
    V = run.state["vocab"].size
    rows, longest = counts["serve.queries"], max(len(s) for s in run.state["seqs"])
    assert 0 < counts["serve.count_bytes"] <= rows * (longest + 4 * V)
    assert not set(READERS) & set(out["metrics"])
