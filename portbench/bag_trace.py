"""The bag's kernels in a traced serving window, for the readers
``classify.bag_ms`` and ``classify.bag_roofline``: the device time of the
kernels named ``bag_*`` (``kpop_tpu_torch/csrc/embedding_bag.cu``: the
histogram, tile sums, scan, cursors, scatter, compact, both accumulates
and the slice sum)."""

from __future__ import annotations

import re

from .count_trace import DRIVERS
from .trace import union

#: a bag kernel's name, bare or as the profiler demangles it
#: (``void (anonymous namespace)::bag_gather<float>(...)``)
KERNEL = re.compile(r"(?:^|[\s:])bag_\w+(?:$|[<(])")


def busy_s(view) -> float:
    """Seconds inside the window in which a bag kernel ran."""
    if view.driver not in DRIVERS:
        return 0.0
    return sum(e - s for s, e in union([(s, e) for n, s, e in view.device
                                        if KERNEL.search(n)])) / 1e6
