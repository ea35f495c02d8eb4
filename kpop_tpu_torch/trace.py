"""Spans and counters of the port's serving step, for a profiler to read.

While a ``torch.profiler`` profile records in this process
(``torch.autograd._profiler_enabled()``), :func:`span` opens a range named
``kpop:<name>`` on the profiler's clock, beside the card's kernels and
copies, and adds its wall time and its call to :data:`COUNTS`
(``<name>.ns``, ``<name>.calls``); :func:`count` adds to a counter there.
With no profiler recording, :func:`span` returns one shared no-op context
and :func:`count` does nothing: each costs that one check, so the profiler
is the only switch.  Spans are opened a batch at a time, never in a loop
over rows.

``kpop-classify-torch --profile DIR`` writes the profile's Chrome trace and
:func:`counters` beside it; a benchmark reads :data:`COUNTS` after its
profiled window.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
from torch._C._profiler import _RecordFunctionFast

from . import _build

#: the prefix of the port's ranges on the profiler's timeline
PREFIX = "kpop:"
#: counters, and each span's wall time (``<name>.ns``) and calls
#: (``<name>.calls``), counted while a profiler records, since :func:`reset`
COUNTS: Counter[str] = Counter()

_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    """A function-scope profiler range, timed.  A user-scope range
    (``record_function``) is also copied onto the device timeline as an
    annotation around the kernels launched inside it, where a reader of the
    card's busy time would count it as device work."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        COUNTS[self.name + ".ns"] += time.perf_counter_ns() - self._t0
        COUNTS[self.name + ".calls"] += 1
        self._range.__exit__(*exc)


def span(name: str):
    """A context that spans ``name`` while a profiler records."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _recording():
        COUNTS[name] += n


def counters() -> dict[str, int]:
    """:data:`COUNTS`, and each kernel's launches from
    :data:`~._build.LAUNCHES` as ``launch.<kernel>``."""
    out = dict(COUNTS)
    out.update(("launch." + name, n) for name, n in _build.LAUNCHES.items())
    return out


def reset() -> None:
    """Clear :data:`COUNTS`."""
    COUNTS.clear()
