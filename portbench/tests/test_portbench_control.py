"""The control on the card: the reference in the precision below the one
the configuration states, put in the program's place, reads ``correct``
false against each cell's limits, while the program reads true.  At a
size a test run holds (fewer classes, the published genome length and
widths of the serving path); the cells' own readings on many seeds are in
PERF.md (``python3 -m portbench.calibrate --control``)."""

import copy

import pytest

from portbench import harness
from portbench.reference.compare import verdict

#: sizes a test run holds on the card
SIZES = {
    "sars2-genomes": (dict(classes=128), dict(pool=256)),
    "sars2-reads": (dict(classes=64), dict(pool=128)),
}


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_program_passes(card, workload):
    cell = harness.load_json("cells", workload)
    cfg = dict(copy.deepcopy(harness.load_json("configs", cell["config"])), **SIZES[workload][0])
    tr = dict(harness.load_json("traffic", cell["traffic"]), **SIZES[workload][1])
    for seed in (101, 102, 103):
        run = harness.load_run(workload, seed, card, False, cell=cell, config=cfg, traffic=tr)
        drv = harness.driver(cell["driver"])
        drv.setup(run)
        drv.window(run, 1.0)
        control_ok, _ = verdict(drv.control(run), cell["limits"])
        drv.release(run)
        program_ok, checks = verdict(drv.check(run), cell["limits"])
        assert program_ok, checks
        assert not control_ok
