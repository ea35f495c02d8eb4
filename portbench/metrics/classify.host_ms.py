"""Host ms a served batch: the benchmark's spans around
``DeviceStep.dispatch`` (encode, upload, launches) and around the
formatting and writing of the batch's summary lines."""

import statistics

UNIT = "ms"


def read(view):
    dispatch, fmt = view.span_ms("classify.dispatch"), view.span_ms("classify.format")
    if not dispatch:
        return None
    return statistics.fmean(dispatch) + (statistics.fmean(fmt) if fmt else 0.0)
