"""The bag's share of its roofline, in %: the served batches' least time,
reckoned from the driver's own work count (``roofline/classify_loop.py``:
each twister row a batch hits read once, its bases and the distances
moved once, at the card's memory rate; a multiply and an add a column for
each (query, row) pair it hits, at the f32 peak; the larger), over the
device time of the bag's kernels (``classify.bag_ms``'s).  The batch's
least also holds the class coordinates' read and the distance tile's
cross term, which the bag does not do: at sars2-k12-genomes' shape about
2 % of it, so the share reads at most that much above the bag's own."""

from portbench.bag_trace import busy_s

UNIT = "%"


def read(view):
    busy = busy_s(view)
    if busy <= 0 or not view.least:
        return None
    return 100.0 * sum(view.least) / busy
