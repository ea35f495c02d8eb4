#!/usr/bin/env python3
"""Probe of what the port's spans and counters cost on the host
(``kpop_tpu_torch/trace.py``).

Run from the root of a checkout: ``python3 tools/probe_trace.py``.  It
prints one JSON object of µs a call, each the median of 9 rounds of
``--calls`` calls: an empty ``trace.span`` and a ``trace.count`` with no
profiler recording (``off``) and inside a ``torch.profiler`` profile of
the CPU (``on``), and ``record_function`` on the same names beside them.
Nothing runs on a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kpop_tpu_torch import trace  # noqa: E402


def per_call_us(fn, calls: int) -> float:
    rounds = []
    for _ in range(9):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(rounds)


def span():
    with trace.span("probe.span"):
        pass


def count():
    trace.count("probe.count", 3)


def user_range():
    with record_function("kpop:probe.user"):
        pass


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=20000)
    calls = p.parse_args().calls
    out = {"off": {"span": per_call_us(span, calls), "count": per_call_us(count, calls),
                   "record_function": per_call_us(user_range, calls)}}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on"] = {"span": per_call_us(span, calls), "count": per_call_us(count, calls),
                     "record_function": per_call_us(user_range, calls)}
    out["counted_on"] = trace.COUNTS["probe.span.calls"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
