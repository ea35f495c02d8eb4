"""A whole run of each cell at small sizes on the CPU: the result line's
keys, the traced run's per-layer metrics and breakdown, and the entry
point's refusal without a card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import small

CELLS = ["sars2-genomes", "sars2-reads"]
REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, traced):
    run = small.load(workload, seed=2**31 + 11, traced=traced)
    out = harness.execute(run, 0.5, time.perf_counter(), on_card=False)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(run.cell["limits"])
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    drv = harness.driver(run.cell["driver"])
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device metric from a CPU run
        assert not any(k.endswith(("device_ms", "_roofline", "idle_pct")) for k in out["metrics"])
    else:
        assert set(out["metrics"]) == set(drv.END_TO_END) | {"setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out, allow_nan=False)


def test_run_without_a_card_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "sars2-genomes",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_classify_latency_and_rate_cover_every_batch():
    run = small.load("sars2-genomes")
    drv = harness.driver("classify_loop")
    drv.setup(run)
    out = drv._serve(run, batches=5)
    assert out["attempted"] == out["lines"] == 5 * run.traffic["batch"]
    assert len(out["lat"]) == 5 and out["served"] == list(range(5))
