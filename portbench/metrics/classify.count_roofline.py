"""The count's share of its roofline, in %: the least bytes the port
counted for it in the window (``serve.count_bytes``: the codes it reads at
their stride and the f32 spectra it writes) at the card's memory rate
(``peaks.py``), over the device time of its kernels
(``classify.count_ms``'s)."""

from portbench.count_trace import busy_s, port_count
from portbench.peaks import HBM_BYTES_PER_S

UNIT = "%"


def read(view):
    nbytes, busy = port_count("serve.count_bytes"), busy_s(view)
    if nbytes <= 0 or busy <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy
