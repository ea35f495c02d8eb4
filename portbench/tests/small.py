"""Small versions of the benchmark's configurations and traffic, for the
CPU tests: the same keys, sizes a test run holds."""

from __future__ import annotations

import copy

from .. import harness

READS = {"read_len": 30, "coverage": 6.0, "insert_mean": 50.0, "insert_sd": 5.0,
         "error_rate": 0.01}


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", name))
    cfg.update(k=5, classes=6, genome_length=400, twister_scale=1.0)
    return cfg


def traffic(name: str) -> dict:
    tr = copy.deepcopy(harness.load_json("traffic", name))
    if "pool" in tr:
        tr.update(batch=4, pool=8)
    if tr.get("reads"):
        tr["reads"] = dict(READS)
    return tr


#: limits at these sizes: a few hundred bases share most of their k-mers,
#: so float32 distances between near neighbours lose more digits than at
#: the cells' sizes
LIMITS = {"dist2_gap": 5e-3, "rank_gap": 5e-3, "line_gap": 5e-2}


def load(workload: str, seed: int = 7, traced: bool = False):
    """A :class:`~portbench.harness.Run` of the cell at small sizes on the
    CPU."""
    import torch

    cell = copy.deepcopy(harness.load_json("cells", workload))
    cell["limits"] = {k: LIMITS.get(k, v) for k, v in cell["limits"].items()}
    return harness.load_run(workload, seed, torch.device("cpu"), traced, cell=cell,
                            config=config(cell["config"]), traffic=traffic(cell["traffic"]))
