"""Device ms a served batch in the bag's kernels (``bag_*``, the bag
route's projection in place of the count and the twister product): the
union of their intervals inside the window, over the batches served."""

from portbench.bag_trace import busy_s
from portbench.count_trace import batches

UNIT = "ms"


def read(view):
    n, busy = batches(view), busy_s(view)
    if not n or busy <= 0:
        return None
    return busy * 1e3 / n
