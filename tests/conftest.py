"""Test configuration: run JAX on CPU with 8 virtual devices so that the
multi-chip sharded paths are exercised without TPU hardware (SURVEY.md §4)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("KPOP_PLATFORM", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one); run on the card with -m card")
