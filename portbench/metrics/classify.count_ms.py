"""Device ms a served batch in the count's kernels (``count_lookup*`` and
``count_slices*``, the dense route's count): the union of their intervals
inside the window, over the batches served."""

from portbench.count_trace import batches, busy_s

UNIT = "ms"


def read(view):
    n, busy = batches(view), busy_s(view)
    if not n or busy <= 0:
        return None
    return busy * 1e3 / n
