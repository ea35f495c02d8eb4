"""Each work count at a fixed shape, worked out by hand."""

import pytest

from portbench import peaks
from portbench.roofline import classify_loop


def test_classify_bytes_bound():
    u = dict(rows=90_000, pairs=1_900_000, bases=64 * 29_903, B=64, C=1636, d=1635, itemsize=4)
    nbytes = 90_000 * 1635 * 4 + 1636 * 1635 * 4 + 64 * 29_903 / 4 + 64 * 1636 * 4
    ops = 2 * 1_900_000 * 1635 / 67e12 + 2 * 64 * 1636 * 1635 / 495e12
    assert nbytes / 3.35e12 > ops
    assert classify_loop.least_seconds(u) == pytest.approx(nbytes / 3.35e12)


def test_classify_operations_bound():
    u = dict(rows=10, pairs=10**9, bases=0, B=1, C=1, d=100, itemsize=2)
    assert classify_loop.least_seconds(u) == pytest.approx(2e11 / 67e12 + 200 / 495e12)


def test_peaks():
    assert peaks.least_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(0, f32=67e12, tf32=495e12) == pytest.approx(2.0)
