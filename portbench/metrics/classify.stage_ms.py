"""Host ms a served batch between the encode and the upload: the port's
span ``serve.stage`` inside ``DeviceStep.dispatch`` (the pad, the row slice
and the contiguous copy, ``pick_path`` on the first batch, and the copy into
pinned memory, or the pack and staging of the 2-bit wire)."""

from portbench.port_counts import span_ms

UNIT = "ms"


def read(view):
    return span_ms(view, "serve.stage")
