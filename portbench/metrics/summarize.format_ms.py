"""Host ms a summarized batch spends formatting its lines: the port's span
``relate.format`` inside ``SummaryStep.materialize`` (the whole tie
groups, the C formatter and the float64 fallback lines)."""

from portbench.summarize_trace import span_ms

UNIT = "ms"


def read(view):
    return span_ms(view, "relate.format")
