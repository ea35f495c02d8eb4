"""The comparison that decides ``correct``: each number that it reads from
the program's outputs beside the plain reference's, and its limit.

Every reading is a gap that is 0 for outputs equal to the reference's; a
run is correct when each reading is at most its limit (a cell's
``limits``).  A reading that could not be taken (no output to read) is
infinite.
"""

from __future__ import annotations

import math

import numpy as np

from .classify import digest


def parse_line(line: str) -> tuple[str, list[float], list[tuple[str, float, float]]]:
    """A ``.KPopSummary.txt`` line: its name, its four statistics (mean,
    standard deviation, median, MAD), and its (target, distance, z-score)
    groups."""
    f = line.rstrip("\n").split("\t")
    if len(f) < 5 or (len(f) - 5) % 3:
        raise ValueError(f"malformed summary line: {line[:80]!r}")
    groups = [(f[i], float(f[i + 1]), float(f[i + 2])) for i in range(5, len(f), 3)]
    return f[0], [float(x) for x in f[1:5]], groups


def line_readings(tag: str, line: str, ref_row: np.ndarray, names: dict[str, int],
                  keep: int) -> dict[str, float]:
    """Readings of one summary line against the reference's distance row.

    Distances are compared squared: a float32 distance is the square root
    of a sum that carries float32 rounding, so the gap of two distances
    near 0 swings with that root, and the gap of their squares does not.

    ``line_gap``: the four statistics over max(1, |reference|), each
    listed distance squared against the reference's for the same target,
    and each z-score against the one the line's own numbers give;
    ``rank_gap``: how far the reference's squared distance to the s-th
    listed target lies above the reference's s-th smallest;
    ``lines_wrong``: 1 for a line with another name, unreadable, naming an
    unknown target or listing fewer than ``keep``."""
    bad = dict(line_gap=0.0, rank_gap=0.0, lines_wrong=1.0)
    try:
        name, stats, groups = parse_line(line)
    except ValueError:
        return bad
    if name != tag or len(groups) < min(keep, len(ref_row)) or any(
            t not in names for t, _, _ in groups):
        return bad
    ref_stats, _ = digest(ref_row, keep)
    srt2 = np.sort(ref_row) ** 2
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(stats, ref_stats))
    rank = 0.0
    for s, (target, dist, z) in enumerate(groups):
        ref2 = ref_row[names[target]] ** 2
        own_z = (dist - stats[0]) / stats[1]
        gap = max(gap, abs(dist * dist - ref2), abs(z - own_z) / max(1.0, abs(own_z)))
        rank = max(rank, ref2 - srt2[min(s, len(srt2) - 1)])
    return dict(line_gap=gap, rank_gap=rank, lines_wrong=0.0)


def dist2_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between the program's and the reference's squared
    distances (see :func:`line_readings`)."""
    if np.shape(prog) != np.shape(ref) or not np.isfinite(prog).all():
        return math.inf
    return float(np.abs(np.asarray(prog) ** 2 - ref**2).max())


def merge(readings: list[dict[str, float]]) -> dict[str, float]:
    """The worst of each reading (counts are summed)."""
    out: dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = out.get(k, 0.0) + v if k == "lines_wrong" else max(out.get(k, 0.0), v)
    return out


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each limited reading beside its limit; a reading
    that is missing or not a number fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = float(readings.get(name, math.inf))
        if not value <= limit:
            ok = False
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
