"""Share of the traced summarizing window in which no kernel, copy or set
ran on the card, in %."""

from portbench.summarize_trace import DRIVER

UNIT = "%"


def read(view):
    if view.driver != DRIVER or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
