"""The benchmark's tests run on the CPU (``KPOP_PLATFORM=cpu``, the port's
plain PyTorch versions) at small sizes.  Tests marked ``card`` need a CUDA
card: the ``card`` fixture skips them without one and points the port at
the card.  Run them on the card with

    python3 -m pytest portbench/tests -q -m card
"""

import os

import pytest

os.environ.setdefault("KPOP_PLATFORM", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 and the port's kernels run only there")
    monkeypatch.setenv("KPOP_PLATFORM", "cuda")
    return torch.device("cuda", 0)
