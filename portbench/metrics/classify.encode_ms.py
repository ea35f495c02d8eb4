"""Host ms a served batch in the port's host encode: its span
``serve.encode`` inside ``DeviceStep.dispatch``."""

from portbench.port_counts import span_ms

UNIT = "ms"


def read(view):
    return span_ms(view, "serve.encode")
