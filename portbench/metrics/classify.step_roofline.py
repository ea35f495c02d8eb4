"""The served batches' least device time (``roofline/classify_loop.py``)
over their device time, in %."""

UNIT = "%"


def read(view):
    if view.driver != "classify_loop" or view.busy_s <= 0 or not view.least:
        return None
    return 100.0 * sum(view.least) / view.busy_s
