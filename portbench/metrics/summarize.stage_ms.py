"""Host ms a summarized batch spends casting its float64 rows into the
step's reused f32 slot: the port's span ``relate.stage`` inside
``SummaryStep.dispatch`` (with the wait for the slot's last batch)."""

from portbench.summarize_trace import span_ms

UNIT = "ms"


def read(view):
    return span_ms(view, "relate.stage")
