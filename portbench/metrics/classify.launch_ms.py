"""Host ms a served batch spends enqueueing the device step: the port's
span ``serve.launch`` around ``dmat_step`` inside ``DeviceStep.dispatch``."""

from portbench.port_counts import span_ms

UNIT = "ms"


def read(view):
    return span_ms(view, "serve.launch")
