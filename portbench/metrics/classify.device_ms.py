"""Device ms a served batch: the union of the card's kernel, copy and set
intervals inside the window, over the batches served."""

UNIT = "ms"


def read(view):
    n = len(view.spans.get("classify.dispatch", []))
    if view.driver != "classify_loop" or not n or view.busy_s <= 0:
        return None
    return view.busy_s * 1e3 / n
