"""MB (1e6 bytes) that cross to the card a served batch: the port's
counters ``serve.upload_bytes`` over ``serve.batches``."""

from portbench.port_counts import counts

UNIT = "MB"


def read(view):
    c = counts(view)
    if not c or not c.get("serve.batches"):
        return None
    return c["serve.upload_bytes"] / c["serve.batches"] / 1e6
