"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have, planted in the port at small sizes on the
CPU (the look for a card skipped)."""

import time

import pytest

from kpop_tpu_torch.cli.classify import DeviceStep
from portbench import harness
from portbench.tests import small


def outcome(workload: str) -> dict:
    run = small.load(workload, seed=21)
    return harness.execute(run, 0.3, time.perf_counter(), on_card=False)


@pytest.mark.parametrize("workload", ["sars2-genomes", "sars2-reads"])
def test_sound_run_is_correct(workload):
    assert outcome(workload)["correct"] is True


def _classify_fault(kind):
    real = DeviceStep.materialize

    def broken(handle):
        d = real(handle)
        if kind == "altered":  # one distance altered where it is made
            d = d.copy()
            d[0, 0] += 0.05
            return d
        return d[: len(d) // 2]  # half of the batch left out

    return staticmethod(broken)


@pytest.mark.parametrize("kind", ["altered", "half"])
@pytest.mark.parametrize("workload", ["sars2-genomes", "sars2-reads"])
def test_classify_fault(monkeypatch, workload, kind):
    monkeypatch.setattr(DeviceStep, "materialize", _classify_fault(kind))
    assert outcome(workload)["correct"] is False
