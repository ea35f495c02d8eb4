"""Share of the traced serving window in which no kernel, copy or set ran
on the card, in %."""

UNIT = "%"


def read(view):
    if view.driver != "classify_loop" or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
