"""Spans and the device trace of a run.

Spans are opened by the benchmark around its calls into the port
(``Recorder.span``).  In a traced run each span is a
``torch.profiler.record_function`` range, so it lies on the profiler's
clock beside the device's kernels and copies; untraced, a span costs
nothing.  After the window, :class:`TraceView` holds the device intervals
and the spans, and the per-layer metric readers (``metrics/*.py``) read
it.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

#: the prefix of the benchmark's spans on the profiler's timeline
PREFIX = "pb:"
#: the span that brackets the measured window
WINDOW = "window"
#: how many spans back a gap looks for the span open over it
SPAN_DEPTH = 8


class Recorder:
    """The spans of one run; ``traced`` turns them on."""

    def __init__(self, traced: bool):
        self.traced = traced

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profiler_events(prof) -> tuple[list, list]:
    """(device intervals ``[(name, start_us, end_us)]``: every kernel, copy
    and set on the card; span intervals ``[(name, start_us, end_us)]``: the
    benchmark's ranges on the host, without their prefix), on the
    profiler's clock."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for ev in prof.events():
        name = ev.name
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if not name.startswith(PREFIX):  # a range's copy on the device timeline
                device.append((name, s, e))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, e))
    return device, spans


class TraceView:
    """What the readers read: the device intervals and the spans inside
    the window (µs on the profiler's clock), the work units' least
    seconds (``least``), and the driver's name."""

    def __init__(self, driver: str, device: list, spans: list, least: list[float]):
        self.driver = driver
        wins = [(s, e) for n, s, e in spans if n == WINDOW]
        self.lo, self.hi = (wins[0] if wins else (0.0, 0.0))
        self.device = [(n, max(s, self.lo), min(e, self.hi)) for n, s, e in device
                       if e > self.lo and s < self.hi]
        self.spans: dict[str, list[tuple[float, float]]] = defaultdict(list)
        for n, s, e in spans:
            if n != WINDOW:
                self.spans[n].append((s, e))
        self.least = least
        self.busy = union([(s, e) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def span_ms(self, name: str) -> list[float]:
        return [(e - s) / 1e3 for s, e in self.spans.get(name, [])]

    def device_ops(self, top: int = 10) -> list[list]:
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle time on the card inside the window, summed by the innermost
        benchmark span open on the host at each gap's middle."""
        edges = [(self.lo, self.lo)] + self.busy + [(self.hi, self.hi)]
        opened = sorted((s, e, n) for n, iv in self.spans.items() for s, e in iv)
        starts = [s for s, _, _ in opened]
        by = defaultdict(float)
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = "no span"
            # the latest-opened span that covers the middle: spans nest
            # shallowly, so a few steps back find it
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1)[:SPAN_DEPTH]:
                if opened[i][1] >= mid:
                    name = opened[i][2]
                    break
            by[name] += (b - a) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]
