"""The relatedness engine in a traced window of ``summarize_loop``, for the
readers ``summarize.*``: the batches served, the device time of the
distance tile's and the row digest's kernels, the batches' least time by
part (``roofline/summarize_loop.py``) and the port's spans ``relate.*``
(``kpop_tpu_torch/trace.py``).  For another driver, or a port without the
spans, each gives nothing to read."""

from __future__ import annotations

import re

from .trace import union

DRIVER = "summarize_loop"
#: the distance tile's kernels (``kpop_tpu_torch/csrc/pairwise.cu``), bare
#: or as the profiler demangles them
#: (``void (anonymous namespace)::dist_tile_kernel<false>(...)``)
TILE = re.compile(r"(?:^|[\s:])(?:dist_tile|weighted_norms|split_finish)_kernel(?:$|[<(])")
#: the row digest's kernels (``kpop_tpu_torch/csrc/digest.cu``)
DIGEST = re.compile(r"(?:^|[\s:])row_digest_(?:staged|streamed)(?:$|[<(])")


def batches(view) -> int:
    return len(view.spans.get("classify.dispatch", [])) if view.driver == DRIVER else 0


def busy_s(view, kernel: re.Pattern) -> float:
    """Seconds inside the window in which a kernel named by ``kernel`` ran."""
    if view.driver != DRIVER:
        return 0.0
    return sum(e - s for s, e in union([(s, e) for n, s, e in view.device
                                        if kernel.search(n)])) / 1e6


def least_s(view, part: str) -> float | None:
    """The served batches' least seconds of ``part`` (``tile`` or
    ``digest``), or None where the work count has none."""
    parts = [getattr(x, part, None) for x in view.least] if view.driver == DRIVER else []
    if not parts or None in parts:
        return None
    return sum(parts)


def span_ms(view, name: str) -> float | None:
    """Mean ms of the port's span ``name``, or None where it never ran."""
    if view.driver != DRIVER:
        return None
    try:
        from kpop_tpu_torch.trace import COUNTS
    except ImportError:
        return None
    calls = COUNTS.get(name + ".calls")
    return COUNTS[name + ".ns"] / calls / 1e6 if calls else None
