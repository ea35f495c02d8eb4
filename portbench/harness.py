"""Discovery and the run of one cell.

Everything is found by name, so a later change adds a cell, a
configuration, a traffic mix or a per-layer metric by adding files:

- ``cells/<workload>.json``: ``config``, ``traffic``, ``driver``,
  ``limits`` (each compared number's limit) and ``why``;
- ``configs/<config>.json``: the deployment's sizes and source;
- ``traffic/<traffic>.json``: the parameters the driver's traffic takes;
- ``drivers/<driver>.py``: ``END_TO_END`` (metric -> unit), ``setup``,
  ``window``, ``release``, ``check`` and, for traced runs, ``work``;
- ``roofline/<driver>.py``: ``least_seconds(unit)`` of one work unit;
- ``metrics/<name>.py``: ``UNIT`` and ``read(view)``, a per-layer metric
  read from a traced run, None where there is nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "kpop_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


@dataclass
class Run:
    """One run of a cell: its files' contents, the seed, the device, and
    the recorder of spans."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    recorder: object
    state: dict = field(default_factory=dict)

    @property
    def seeds(self):
        from .gen import Seeds

        return Seeds(self.seed, self.device)


def load_run(workload: str, seed: int, device, traced: bool, cell: dict | None = None,
             config: dict | None = None, traffic: dict | None = None) -> Run:
    """A :class:`Run` of ``workload`` from its files; ``cell``, ``config``
    and ``traffic`` replace a file's contents (the tests' small sizes)."""
    from .trace import Recorder

    cell = cell or load_json("cells", workload)
    return Run(workload, cell, config or load_json("configs", cell["config"]),
               traffic or load_json("traffic", cell["traffic"]), int(seed), device,
               Recorder(traced))


def driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def roofline(name: str):
    return importlib.import_module(f"{__package__}.roofline.{name}")


def metric_readers() -> dict:
    """Every per-layer metric reader under ``metrics/``, by name."""
    out = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"{__package__}_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _number(x: float) -> float:
    """A JSON number: an unbounded reading prints as 1e300."""
    return float(x) if math.isfinite(x) else 1e300


def execute(run: Run, seconds: float, t0: float, on_card: bool) -> dict:
    """Set up, measure for ``seconds``, read the trace (a traced run), free
    the program's state and compare with the reference.  ``t0`` is the
    process's start on ``time.perf_counter``.  Returns the result line's
    contents."""
    import torch

    drv = driver(run.cell["driver"])
    rec = run.recorder
    drv.setup(run)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if rec.traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    from .trace import WINDOW

    with rec.span(WINDOW):
        win = drv.window(run, seconds)
    if prof is not None:
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    metrics: dict = {}
    breakdown = None
    if rec.traced:
        from .trace import TraceView, profiler_events

        device_ev, spans = profiler_events(prof)
        del prof
        least_of = roofline(run.cell["driver"]).least_seconds
        view = TraceView(run.cell["driver"], device_ev, spans,
                         [least_of(u) for u in drv.work(run)])
        for name, mod in metric_readers().items():
            value = mod.read(view)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        breakdown = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps()}
    else:
        for name, value in win["metrics"].items():
            metrics[name] = {"value": float(value), "unit": drv.END_TO_END[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    drv.release(run)
    from .reference.compare import verdict

    correct, checks = verdict(drv.check(run), run.cell["limits"])
    out = {"correct": correct and win["failed"] == 0, "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out
