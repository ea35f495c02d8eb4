"""A cell, a configuration, a traffic mix and a per-layer metric added as
files are found by name, with no edit to a file that is there."""

import json
import shutil
import time

from portbench import harness
from portbench.tests import small


def test_new_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    for kind in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / kind, root / kind)
    # a new configuration, traffic mix and cell
    cfg = small.config("sars2-lineages-k10")
    cfg.update(name="sars2-wide", classes=9)
    (root / "configs" / "sars2-wide.json").write_text(json.dumps(cfg))
    tr = dict(small.traffic("genomes64"), batch=3, project_path="bag")
    (root / "traffic" / "genomes3-bag.json").write_text(json.dumps(tr))
    cell = dict(config="sars2-wide", traffic="genomes3-bag", driver="classify_loop", chips=1,
                limits=dict(small.LIMITS, lines_wrong=0), why="a cell added as data")
    (root / "cells" / "sars2-wide.bag.json").write_text(json.dumps(cell))
    # a new per-layer metric
    (root / "metrics" / "classify.batches.py").write_text(
        'UNIT = "batches"\n\n\ndef read(view):\n'
        '    n = len(view.spans.get("classify.dispatch", []))\n    return n or None\n')
    monkeypatch.setattr(harness, "ROOT", root)
    run = harness.load_run("sars2-wide.bag", 5, small.load("sars2-genomes").device, True)
    assert run.config["classes"] == 9 and run.traffic["batch"] == 3
    assert "classify.batches" in harness.metric_readers()
    out = harness.execute(run, 0.3, time.perf_counter(), on_card=False)
    assert out["correct"] is True
    assert out["metrics"]["classify.batches"]["value"] > 0
    assert out["metrics"]["classify.batches"]["unit"] == "batches"
