"""Device ms a summarized batch: the union of the card's kernel, copy and
set intervals inside the window, over the batches served."""

from portbench.summarize_trace import batches

UNIT = "ms"


def read(view):
    n = batches(view)
    if not n or view.busy_s <= 0:
        return None
    return view.busy_s * 1e3 / n
