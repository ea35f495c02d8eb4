"""The row digest's share of its roofline, in %: the served batches' least
digest time (``roofline/summarize_loop.py``, from the driver's own count:
the B N f32 distances read once at the memory rate), over the device time
of the digest's kernels (``row_digest_staged``, ``row_digest_streamed``)."""

from portbench.summarize_trace import DIGEST, busy_s, least_s

UNIT = "%"


def read(view):
    busy, least = busy_s(view, DIGEST), least_s(view, "digest")
    if busy <= 0 or least is None:
        return None
    return 100.0 * least / busy
