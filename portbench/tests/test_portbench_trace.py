"""The port's spans and counters (``kpop_tpu_torch/trace.py``) beside the
benchmark's: its host ranges leave every reader's value and the breakdown
as they were, its names are not the benchmark's, and the readers of its
counts read the window's alone, or nothing where the port has no such
module.  On the card (``-m card``): the port's ranges stay off the device
timeline, where a user-scope range would land."""

import copy
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from kpop_tpu_torch import trace
from portbench import harness
from portbench.tests import small
from portbench.trace import TraceView, profiler_events

NEW_READERS = ["classify.encode_ms", "classify.stage_ms", "classify.launch_ms",
               "classify.upload_mb"]


def ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def stub_events(port: bool) -> list:
    """Two served batches: the benchmark's spans, the card's kernels and
    copies, and with ``port`` the port's ranges inside the spans."""
    out = [ev("pb:window", 0.0, 1000.0)]
    for b0 in (0.0, 500.0):
        out += [ev("pb:classify.dispatch", b0 + 10, b0 + 200),
                ev("pb:classify.wait", b0 + 210, b0 + 220),
                ev("pb:classify.format", b0 + 230, b0 + 480),
                ev("pb:classify.dispatch", b0 + 150, b0 + 190, DeviceType.CUDA),
                ev("Memcpy HtoD", b0 + 150, b0 + 160, DeviceType.CUDA),
                ev("count_slices", b0 + 160, b0 + 185, DeviceType.CUDA),
                ev("Memcpy DtoH", b0 + 186, b0 + 190, DeviceType.CUDA)]
        if port:
            out += [ev("kpop:serve.dispatch", b0 + 11, b0 + 199),
                    ev("kpop:serve.encode", b0 + 12, b0 + 120),
                    ev("kpop:serve.stage", b0 + 121, b0 + 148),
                    ev("kpop:serve.upload", b0 + 149, b0 + 150),
                    ev("kpop:serve.launch", b0 + 151, b0 + 180),
                    ev("kpop:serve.download", b0 + 181, b0 + 198),
                    ev("kpop:serve.materialize", b0 + 211, b0 + 219)]
    return out


def view_of(events) -> TraceView:
    device, spans = profiler_events(SimpleNamespace(events=lambda: events))
    return TraceView("classify_loop", device, spans, [1e-6, 1e-6])


@pytest.fixture
def counts():
    trace.reset()
    yield trace.COUNTS
    trace.reset()


def test_port_ranges_change_no_reader_and_no_breakdown(counts):
    counts.update({"serve.batches": 2, "serve.upload_bytes": 3_000_000,
                   "serve.encode.ns": 216_000, "serve.encode.calls": 2})
    bare, port = view_of(stub_events(False)), view_of(stub_events(True))
    assert port.device == bare.device and port.spans == bare.spans
    readers = harness.metric_readers()
    assert set(NEW_READERS) <= set(readers)
    values = {name: mod.read(port) for name, mod in readers.items()}
    assert values == {name: mod.read(bare) for name, mod in readers.items()}
    assert values["classify.device_ms"] == pytest.approx(0.039)  # (35 + 4) µs a batch
    assert values["classify.encode_ms"] == pytest.approx(0.108)
    assert values["classify.upload_mb"] == pytest.approx(1.5)
    assert values["classify.stage_ms"] is None  # never ran
    assert port.device_ops() == bare.device_ops()
    assert port.idle_gaps() == bare.idle_gaps()


def test_port_readers_read_nothing_without_the_port(counts, monkeypatch):
    view = view_of(stub_events(True))
    readers = harness.metric_readers()
    assert all(readers[n].read(view) is None for n in NEW_READERS)  # nothing counted
    counts.update({"serve.batches": 1, "serve.upload_bytes": 10, "serve.stage.ns": 5,
                   "serve.stage.calls": 1})
    other = TraceView("another_driver", view.device, [], [])
    assert all(readers[n].read(other) is None for n in NEW_READERS)
    monkeypatch.setitem(sys.modules, "kpop_tpu_torch.trace", None)  # a port without it
    assert all(readers[n].read(view) is None for n in NEW_READERS)


@pytest.mark.parametrize("workload", ["sars2-genomes", "sars2-reads"])
def test_traced_run_reads_the_windows_counts(workload, counts):
    run = small.load(workload, seed=2**31 + 5, traced=True)
    out = harness.execute(run, 0.3, time.perf_counter(), on_card=False)
    assert out["correct"] is True
    got = {n: out["metrics"][n]["value"] for n in NEW_READERS}
    assert all(v > 0 for v in got.values())
    # the warm-up's batches ran before the profiler: the window's alone
    assert counts["serve.queries"] == out["attempted"]
    assert got["classify.upload_mb"] * counts["serve.batches"] * 1e6 == pytest.approx(
        counts["serve.upload_bytes"])
    # the port's span names are not the benchmark's
    port_names = {k[: -len(".calls")] for k in counts if k.endswith(".calls")}
    assert port_names == {"serve.dispatch", "serve.encode", "serve.stage", "serve.launch",
                          "serve.materialize", "serve.gather"}
    assert not port_names & {n for n, _ in out["breakdown"]["idle_gaps"]}


@pytest.mark.card
def test_port_ranges_stay_off_the_device_timeline(card, counts):
    """A user-scope range around the same call lands on the device
    timeline (the check is not blind); the port's ranges do not."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = harness.load_json("cells", "sars2-genomes")
    cfg = dict(copy.deepcopy(harness.load_json("configs", cell["config"])), classes=128)
    tr = dict(harness.load_json("traffic", cell["traffic"]), pool=128)
    run = harness.load_run("sars2-genomes", 17, card, True, cell=cell, config=cfg, traffic=tr)
    drv = harness.driver(cell["driver"])
    drv.setup(run)
    step, seqs = run.state["step"], run.state["seqs"][: tr["batch"]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("kpop:probe"):
            step.materialize(step.dispatch(seqs))
        torch.cuda.synchronize()
    drv.release(run)
    device, _ = profiler_events(prof)
    names = {n for n, _, _ in device}
    assert "kpop:probe" in names
    assert not {n for n in names if n.startswith(trace.PREFIX)} - {"kpop:probe"}
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert {"kpop:serve." + n for n in ("encode", "stage", "upload", "launch", "download",
                                        "wait", "gather")} <= host
