"""What the port counted in a traced window: its own spans and counters
(``kpop_tpu_torch/trace.py``), counted only while a profiler records, so in
a run of ``portbench.run`` the window's alone.  A port without that module
counts nothing, and its readers give None."""

from __future__ import annotations


def counts(view) -> dict | None:
    """The port's counters after a serving window, or None."""
    if view.driver != "classify_loop":
        return None
    try:
        from kpop_tpu_torch.trace import COUNTS
    except ImportError:
        return None
    return COUNTS or None


def span_ms(view, name: str) -> float | None:
    """Mean ms of the port's span ``name``, or None where it never ran."""
    c = counts(view)
    if not c or not c.get(name + ".calls"):
        return None
    return c[name + ".ns"] / c[name + ".calls"] / 1e6
