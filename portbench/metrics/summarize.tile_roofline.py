"""The distance tile's share of its roofline, in %: the served batches'
least tile time (``roofline/summarize_loop.py``, from the driver's own
count: 2 B N d operations at the TF32 peak, or (B + N) d 4 + B N 4 bytes
at the memory rate, the larger), over the device time of the tile's
kernels (``dist_tile_kernel``, ``weighted_norms_kernel``,
``split_finish_kernel``)."""

from portbench.summarize_trace import TILE, busy_s, least_s

UNIT = "%"


def read(view):
    busy, least = busy_s(view, TILE), least_s(view, "tile")
    if busy <= 0 or least is None:
        return None
    return 100.0 * least / busy
