"""The count's kernels in a traced serving window, for the readers
``classify.count_ms`` and ``classify.count_roofline``: the device time of
the kernels named ``count_lookup*`` and ``count_slices*``
(``kpop_tpu_torch/csrc/count_spectra.cu``), and the port's counters."""

from __future__ import annotations

import re

from .trace import union

#: the drivers whose window is ``classify_loop``'s serving loop
DRIVERS = ("classify_loop", "classify_loop_long")
#: a count kernel's name, bare or as the profiler demangles it
#: (``void (anonymous namespace)::count_slices<true>(...)``)
KERNEL = re.compile(r"(?:^|[\s:])count_(?:lookup|slices)\w*(?:$|[<(])")


def busy_s(view) -> float:
    """Seconds inside the window in which a count kernel ran."""
    if view.driver not in DRIVERS:
        return 0.0
    return sum(e - s for s, e in union([(s, e) for n, s, e in view.device
                                        if KERNEL.search(n)])) / 1e6


def batches(view) -> int:
    return len(view.spans.get("classify.dispatch", [])) if view.driver in DRIVERS else 0


def port_count(name: str) -> int:
    """The port's counter ``name`` (``kpop_tpu_torch/trace.py``), 0 where the
    port has no such module or counted nothing under that name."""
    try:
        from kpop_tpu_torch.trace import COUNTS
    except ImportError:
        return 0
    return int(COUNTS.get(name, 0))
