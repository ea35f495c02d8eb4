"""The port's summary line (``core/space.py::summarize_distance_row``) is
byte-identical to the JAX package's, with the native row digest
(``native/summary_row.cpp``) and without it.

The digest takes a C-contiguous float64 row of 2 to ``np.getbufsize()``
finite entries with no -0.0 and a positive ``req_len``; every other row
takes the sorts.  The rows below cross each of those edges, numpy's
pairwise-sum blocks (8 and 128 entries) and its buffer (8,192), with ties
at the k-th, equal rows, infinities, NaN and signed zeros."""

import numpy as np
import pytest
import torch

from kpop_tpu.core import space as want
from kpop_tpu_torch import native, trace
from kpop_tpu_torch.core import space as got

LENGTHS = [1, 2, 7, 8, 9, 127, 128, 129, 1000, 1636, 8192, 8193, 10001]
KINDS = ["f32", "tie_kth", "all_equal", "inf", "nan", "signed_zero"]
#: kinds whose rows the digest refuses
REFUSED = {"inf", "nan", "signed_zero"}


def req_lens(n: int) -> list[int]:
    return [0, 1, 2, 5, n, n + 3]


def make_row(kind: str, n: int, req_len: int, rng) -> np.ndarray:
    """A float64 row of ``n`` distances of ``kind``."""
    row = (rng.random(n) * 3.0).astype(np.float32).astype(np.float64)
    if kind == "tie_kth":
        # whole tie groups: three more entries equal to the k-th
        kth = np.sort(row)[max(min(req_len, n) - 1, 0)]
        row[rng.integers(0, n, 3)] = kth
        row = np.round(row, 2)
    elif kind == "all_equal":
        row[:] = 0.25
    elif kind == "inf":
        row[rng.integers(0, n, 2)] = np.inf
        if n > 2:
            row[rng.integers(0, n)] = -np.inf
    elif kind == "nan":
        row[rng.integers(0, n, 2)] = np.nan
    elif kind == "signed_zero":
        at = rng.permutation(n)
        row[at[0]] = -0.0
        if n > 1:
            row[at[1]] = 0.0
    return row


def lines_equal(row, req_len, names):
    line = got.summarize_distance_row(req_len, "q", row, names)
    assert line == want.summarize_distance_row(req_len, "q", row, names)


@pytest.fixture(params=["native", "numpy"])
def library(request, monkeypatch):
    """The native library on (skipped without a compiler), or forced off."""
    if request.param == "native":
        if not native.available():
            pytest.skip("no C++ compiler: the port falls back to numpy")
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("n", LENGTHS)
def test_line_is_the_original(n, library):
    rng = np.random.default_rng(n)
    names = ["C%d" % i for i in range(n)]
    for kind in KINDS:
        for req_len in req_lens(n):
            row = make_row(kind, n, req_len, rng)
            lines_equal(row, req_len, names)
            if library == "native":
                takes = kind not in REFUSED and 2 <= n <= np.getbufsize() and req_len > 0
                assert (native.summary_row(row, req_len) is not None) == takes, (kind, req_len)


@pytest.mark.parametrize("n", [2, 7, 8, 9, 127, 128, 129, 1000, 1636, 8192])
def test_digest_numbers_are_numpy_bit_for_bit(n):
    if not native.available():
        pytest.skip("no C++ compiler: the port falls back to numpy")
    rng = np.random.default_rng(100 + n)
    for kind in ("f32", "tie_kth", "all_equal"):
        for req_len in req_lens(n)[1:]:
            row = make_row(kind, n, req_len, rng) * 10.0 ** rng.integers(-4, 5)
            stats, near = native.summary_row(row, req_len)
            srt = np.sort(row)
            numbers = np.array(want.mean_std_median_mad(row, srt=srt), dtype=np.float64)
            assert np.array(stats).tobytes() == numbers.tobytes(), (kind, req_len)
            eff_len = int((row <= srt[min(req_len, n) - 1]).sum())
            order = np.lexsort((np.arange(n), row))[:eff_len]
            assert near == order.tolist(), (kind, req_len)


def test_digest_refuses_what_numpy_must_take():
    if not native.available():
        pytest.skip("no C++ compiler: the port falls back to numpy")
    rng = np.random.default_rng(5)
    row = rng.random(300)
    assert native.summary_row(row, 2) is not None
    for bad in (np.nan, np.inf, -np.inf, -0.0):
        r = row.copy()
        r[17] = bad
        assert native.summary_row(r, 2) is None, bad
    assert native.summary_row(row, 0) is None
    assert native.summary_row(row[:1], 2) is None
    assert native.summary_row(row[::2], 2) is None  # not contiguous: no copy
    assert native.summary_row(row.astype(np.float32), 2) is None
    assert native.summary_row(list(row), 2) is None
    big = rng.random(np.getbufsize() + 1)
    assert native.summary_row(big, 2) is None
    assert native.summary_row(big[:-1], 2) is not None


def test_counters_split_the_rows_served(library):
    """``summary.native_rows`` and ``summary.numpy_rows`` add up to the
    rows served, and the second counts the rows that fall back."""
    rng = np.random.default_rng(9)
    rows = rng.random((12, 40))
    rows[3, 5] = np.nan
    rows[7, 0] = -0.0
    rows[10, 9] = np.inf
    names = ["C%d" % i for i in range(40)]
    trace.reset()
    got.summarize_distance_row(2, "q", rows[0], names)  # no profiler: not counted
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        lines = [got.summarize_distance_row(2, "q%d" % i, r, names) for i, r in enumerate(rows)]
    counts = trace.counters()
    trace.reset()
    assert lines == [want.summarize_distance_row(2, "q%d" % i, r, names) for i, r in enumerate(rows)]
    numpy_rows = 3 if library == "native" else len(rows)
    assert counts.get("summary.numpy_rows", 0) == numpy_rows
    assert counts.get("summary.native_rows", 0) == len(rows) - numpy_rows
