"""``classify_loop`` for read sets of tens of millions of windows: the same
set-up, window, work count, release and comparison, with the plain
reference counting one query at a time.

``classify_loop``'s check counts 8 queries at a time through int64
``[8, windows]`` temporaries (``reference/kmers.py::window_rows``): at
88.8M windows a read set that is up to eight tensors of 5.7 GB beside
the cell's 33.5 GB twister, more than the card holds.  Counted one at a time
they take an eighth of that; the counts, and so every compared number,
are the same.
"""

from __future__ import annotations

import functools

from . import classify_loop
from .classify_loop import END_TO_END, check, control, release, window, work  # noqa: F401


def setup(run) -> None:
    classify_loop.setup(run)
    vocab = run.state["vocab"]
    vocab.counts = functools.partial(vocab.counts, chunk=1)
