"""Ms a served batch spends blocked on the card: the benchmark's span
around ``DeviceStep.materialize``."""

import statistics

UNIT = "ms"


def read(view):
    wait = view.span_ms("classify.wait")
    return statistics.fmean(wait) if wait else None
