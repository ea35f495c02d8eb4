"""Count transformations and column/row statistics.

Exact re-implementations (vectorized) of the reference's
``KMerDB.Transformation`` (lib/KMerDB.ml:73-168) and
``stats_table_of_core_db`` (lib/KMerDB.ml:170-268).

All functions take the counts matrix as ``[n_rows(kmers), n_cols(samples)]``
float64 and are pure numpy; the JAX versions used inside fused TPU pipelines
live in :mod:`kpop_tpu.ops.transform_kernels` and are tested for agreement
against these.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EPSILON = 0.1  # CLR epsilon, lib/KMerDB.ml:96


class UnknownTransformation(ValueError):
    pass


class InvalidTransformation(ValueError):
    pass


@dataclass(frozen=True)
class Transformation:
    """Parameters: which ('binary'|'power'|'clr'|'pseudocounts'), threshold, power."""

    which: str = "power"
    threshold: float = 1.0
    power: float = 1.0

    def __post_init__(self):
        w = self.normalized_which
        if w not in ("binary", "power", "clr", "pseudocounts"):
            raise UnknownTransformation(self.which)

    @property
    def normalized_which(self) -> str:
        w = self.which
        if w == "pow":
            return "power"
        if w == "CLR":
            return "clr"
        if w == "pseudo":
            return "pseudocounts"
        return w


@dataclass
class StatsTable:
    """Per-column and per-row stats {non_zero, min, max, sum(v^p), sum_log}."""

    col_non_zero: np.ndarray
    col_min: np.ndarray
    col_max: np.ndarray
    col_sum: np.ndarray
    col_sum_log: np.ndarray
    row_non_zero: np.ndarray
    row_min: np.ndarray
    row_max: np.ndarray
    row_sum: np.ndarray
    row_sum_log: np.ndarray


def _axis_stats(
    counts: np.ndarray,
    threshold: float,
    power: float,
    axis: int,
    thr: np.ndarray | None = None,
):
    """Stats along one axis with the reference's threshold semantics
    (lib/KMerDB.ml:179-216): the fractional threshold is relative to the
    *powered* sum over all entries; stats then accumulate entries whose raw
    value is >= threshold.  Note the reference initializes ``min`` to 0 so it
    never exceeds 0 for non-negative counts; we reproduce that.

    ``thr``: precomputed per-lane thresholds (used by the blocked column
    pass, where the fractional threshold depends on column sums over ALL
    row blocks, not just this one).
    """
    c = counts.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        powered = c if power == 1.0 else np.power(c, power)
        if thr is None:
            pre_sum = powered.sum(axis=axis)
            thr = np.where(threshold < 1.0, threshold * pre_sum, threshold)
        thr = np.expand_dims(thr, axis)
        mask = c >= thr
        non_zero = mask.sum(axis=axis)
        mn = np.minimum(np.where(mask, c, 0).min(axis=axis), 0)  # ref min starts at 0
        mx = np.where(mask, c, 0).max(axis=axis)
        s = np.where(mask, powered, 0.0).sum(axis=axis)
        logs = np.where(mask & (c > 0), np.log(np.where(c > 0, c, 1.0)) * power, 0.0)
        # the reference computes log of any passing value; counts==0 passes
        # only when threshold <= 0, in which case log 0 = -inf
        neg_inf = mask & (c == 0)
        sum_log = logs.sum(axis=axis)
        sum_log = np.where(neg_inf.any(axis=axis), -np.inf, sum_log)
    return non_zero, mn, mx, s, sum_log


def export_block_rows(n_cols: int, block_bytes: int | None = None) -> int:
    """Rows per block for the streaming stats/export passes, from a byte
    budget on the per-block float64 temporaries (default 256 MB, env
    ``KPOP_EXPORT_BLOCK_BYTES``)."""
    if block_bytes is None:
        import os

        block_bytes = int(os.environ.get("KPOP_EXPORT_BLOCK_BYTES", 256 << 20))
    return max(1, block_bytes // max(1, n_cols * 8 * 4))


def stats_table(
    counts: np.ndarray,
    transform: Transformation,
    block_bytes: int | None = None,
) -> StatsTable:
    """counts: [n_rows, n_cols] non-negative ints (as any numeric dtype).

    Streams over row blocks like the reference's chunk-parallel
    ``stats_table_of_core_db`` (lib/KMerDB.ml:170-268): peak extra memory
    is O(block x n_cols) float64, never a full float64 copy of the counts.
    Row stats are complete within a block; column stats accumulate across
    blocks (for fractional thresholds a first pass accumulates the powered
    column sums the thresholds are relative to).
    """
    from ..utils.progress import Progress

    nr, nc = counts.shape
    t, p = transform.threshold, transform.power
    R = export_block_rows(nc, block_bytes)
    if t < 1.0:
        col_pre = np.zeros(nc)
        prog = Progress("KMerDB.stats", "Computing column thresholds", nr)
        for r0 in range(0, nr, R):
            prog.update(r0)
            c = counts[r0 : r0 + R].astype(np.float64)
            col_pre += (c if p == 1.0 else np.power(c, p)).sum(axis=0)
        prog.done()
        col_thr = t * col_pre
    else:
        col_thr = np.full(nc, t)
    cn = np.zeros(nc)
    cmin = np.zeros(nc)
    cmax = np.zeros(nc)
    cs = np.zeros(nc)
    csl = np.zeros(nc)
    c_neg_inf = np.zeros(nc, dtype=bool)
    rn = np.zeros(nr)
    rmin = np.zeros(nr)
    rmax = np.zeros(nr)
    rs = np.zeros(nr)
    rsl = np.zeros(nr)
    prog = Progress("KMerDB.stats", "Computing col/row statistics", nr)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r0 in range(0, nr, R):
            prog.update(r0)
            r1 = min(r0 + R, nr)
            c = counts[r0:r1].astype(np.float64)
            powered = c if p == 1.0 else np.power(c, p)
            mask = c >= col_thr[None, :]
            cn += mask.sum(axis=0)
            cmin = np.minimum(cmin, np.where(mask, c, 0).min(axis=0))
            cmax = np.maximum(cmax, np.where(mask, c, 0).max(axis=0))
            cs += np.where(mask, powered, 0.0).sum(axis=0)
            logs = np.where(
                mask & (c > 0), np.log(np.where(c > 0, c, 1.0)) * p, 0.0
            )
            csl += logs.sum(axis=0)
            c_neg_inf |= (mask & (c == 0)).any(axis=0)
            (
                rn[r0:r1], rmin[r0:r1], rmax[r0:r1], rs[r0:r1], rsl[r0:r1]
            ) = _axis_stats(c, t, p, axis=1)
    prog.done()
    csl = np.where(c_neg_inf, -np.inf, csl)
    return StatsTable(cn, cmin, cmax, cs, csl, rn, rmin, rmax, rs, rsl)


def apply_transform(
    counts: np.ndarray, transform: Transformation, stats: StatsTable | None = None
) -> np.ndarray:
    """Transform a ``[n_rows, n_cols]`` counts matrix elementwise.

    Vectorization of ``Transformation.compute`` (lib/KMerDB.ml:97-144); the
    per-element ``threshold`` is column-scaled when fractional.
    """
    if stats is None:
        stats = stats_table(counts, transform)
    c = counts.astype(np.float64)
    which = transform.normalized_which
    t, p = transform.threshold, transform.power
    thr = t * stats.col_sum[None, :] if t < 1.0 else np.full((1, c.shape[1]), t)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if which == "binary":
            return (c >= thr).astype(np.float64)
        if which == "power":
            kept = np.where(c >= thr, c, 0.0)
            return kept if p == 1.0 else np.power(kept, p)
        if which == "clr":
            v = np.where(c >= thr, c, 0.0)
            v = np.maximum(v, EPSILON)
            mean_log = stats.col_sum_log / stats.col_non_zero
            return np.log(v) * p - mean_log[None, :]
        if which == "pseudocounts":
            if p < 0.0:
                raise InvalidTransformation(("pseudocounts", t, p))
            col_max = stats.col_max[None, :]
            if p == 0.0:
                v = col_max * np.log((c + 1.0) / thr)
            else:
                red_thr = np.maximum(thr - 1.0, 0.0)
                c_p = np.power(red_thr, p)
                if p < 1.0:
                    v = (np.power(c, p) - c_p) * np.power(col_max, 1.0 - p) / p
                else:
                    v = (np.power(c, p) - c_p) / (np.power(thr, p) - c_p)
            return np.maximum(np.floor(v) / stats.col_sum[None, :], 0.0)
    raise UnknownTransformation(which)
