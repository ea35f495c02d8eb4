"""Live carriage-return progress reporting (the reference's ``-v`` UX).

The reference emits ``<clear>\\r(<function>): <what> [<done>/<total>]`` on
stderr throughout every long chunk-parallel pass (lib/KMerDB.ml:226-229,
lib/Matrix.ml:181-187, lib/Twister.ml:147); at multi-hour scale this is the
only way to tell a working job from a hung one.  This module provides the
same UX for the streamed passes here (ingest, stats, export, distill, CA
block uploads, summary batches), throttled by wall time so the write cost
never shows up in the pass being reported.
"""

from __future__ import annotations

import sys
import time

#: ANSI erase-to-end-of-line, the equivalent of the reference's
#: ``String.TermIO.clear``
_CLEAR = "\x1b[K"

#: process-wide default for ``Progress(enabled=None)`` — the analogue of
#: the reference's global ``Parameters.verbose`` flag, set once by each
#: CLI's ``-v`` so the deep streaming loops need no verbose plumbing
_default_enabled = False


def set_verbose(on: bool) -> None:
    global _default_enabled
    _default_enabled = bool(on)


def verbose_enabled() -> bool:
    return _default_enabled


class Progress:
    """One progress line, updated in place.

    >>> p = Progress("KMerDB.to_table", "Writing table", 1000, enabled=True)
    >>> for block in blocks: ...; p.update(done_rows)
    >>> p.done()
    """

    def __init__(
        self,
        label: str,
        what: str,
        total: int | None = None,
        enabled: bool | None = None,
        stream=None,
        min_interval: float = 0.1,
    ):
        self.label = label
        self.what = what
        self.total = total
        self.enabled = _default_enabled if enabled is None else enabled
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self._done = 0
        self._last = None  # None = nothing emitted yet: first emit always goes
        self._wrote = False

    def _line(self) -> str:
        if self.total is not None:
            return "(%s): %s [%d/%d]" % (
                self.label,
                self.what,
                self._done,
                self.total,
            )
        return "(%s): %s [%d]" % (self.label, self.what, self._done)

    def _emit(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        if (
            not force
            and self._last is not None
            and now - self._last < self.min_interval
        ):
            return
        self._last = now
        try:
            self.stream.write("\r" + _CLEAR + self._line())
            self.stream.flush()
        except (OSError, ValueError):
            self.enabled = False  # closed/broken stderr: stop reporting
            return
        self._wrote = True

    def update(self, done: int) -> None:
        """Set absolute progress (monotonic by convention)."""
        self._done = done
        self._emit()

    def step(self, n: int = 1) -> None:
        self._done += n
        self._emit()

    def done(self, suffix: str = "done.") -> None:
        """Finalize: rewrite the full line and terminate it with a newline
        (matching the reference's end-of-pass line, lib/KMerDB.ml:265)."""
        if not self.enabled:
            return
        if self.total is not None:
            self._done = self.total
        self._emit(force=True)
        if self._wrote:
            try:
                self.stream.write(" %s\n" % suffix)
                self.stream.flush()
            except (OSError, ValueError):
                pass
