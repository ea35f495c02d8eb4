"""Plain classification: metric weights, the twist of a spectrum,
distances to the classes and a summary line's numbers (upstream KPop's
lib/Space.ml, lib/Twister.ml and lib/Matrix.ml:632-690)."""

from __future__ import annotations

import re

import numpy as np
import torch

from .precision import precision


def metric_weights(inertia: np.ndarray, spec: str) -> np.ndarray:
    """Per-dimension weights from the inertia: ``flat``, or
    ``powers(p_int, threshold, p_ext)``: |inertia|^p_int, the leading
    dimensions kept until ``threshold`` of the mass, raised to p_ext, made
    to sum to 1."""
    m = np.asarray(inertia, dtype=np.float64)
    if spec == "flat":
        return np.full(len(m), 1.0 / len(m))
    p_int, thr, p_ext = (float(g) for g in re.fullmatch(r"powers\(([^,]*),([^,]*),([^)]*)\)",
                                                        spec).groups())
    x = np.abs(m) ** p_int
    before = np.concatenate([[0.0], np.cumsum(x)[:-1]])
    x = np.where(before < thr * x.sum(), x, 0.0) ** p_ext
    return x / x.sum()


def twist(spectra: torch.Tensor, twister: torch.Tensor, name: str = "f64",
          rows: int = 65536) -> torch.Tensor:
    """``[n, V]`` counts -> ``[n, d]`` twisted vectors in the precision
    ``name``: the product with the ``[V, d]`` twister, taken ``rows``
    vocabulary rows at a time, divided by each spectrum's total count."""
    with precision(name) as dt:
        out = torch.zeros((spectra.shape[0], twister.shape[1]), dtype=dt, device=spectra.device)
        for i in range(0, twister.shape[0], rows):
            out += spectra[:, i : i + rows].to(dt) @ twister[i : i + rows].to(dt)
        sums = spectra.sum(dim=1).to(dt)
        return out / torch.where(sums == 0, torch.ones_like(sums), sums)[:, None]


def distances(queries: torch.Tensor, classes: torch.Tensor, metric: torch.Tensor,
              name: str = "f64") -> torch.Tensor:
    """Metric-weighted euclidean distances ``[n, C]`` between the rows of
    ``queries`` and of ``classes``, each row first divided by its own
    weighted norm (0 -> 1)."""
    with precision(name) as dt:
        a, b, m = queries.to(dt), classes.to(dt), metric.to(dt)
        na = torch.sqrt((a * a * m).sum(dim=1))
        nb = torch.sqrt((b * b * m).sum(dim=1))
        a = a / torch.where(na == 0, torch.ones_like(na), na)[:, None]
        b = b / torch.where(nb == 0, torch.ones_like(nb), nb)[:, None]
        cross = a @ (b * m).T
        acc = (a * a * m).sum(dim=1)[:, None] + (b * b * m).sum(dim=1)[None, :] - 2.0 * cross
        return torch.sqrt(torch.clamp(acc, min=0.0))


def digest(row: np.ndarray, keep: int) -> tuple[list[float], list[int]]:
    """A summary line's numbers for one distance row: mean, n-1 standard
    deviation, upper median (the element at n//2 of the sorted row), MAD
    of the same convention; and the indices of the nearest, at least
    ``keep`` of them with whole tie groups, in (distance, index) order."""
    row = np.asarray(row, dtype=np.float64)
    n = len(row)
    srt = np.sort(row)
    mean = row.mean()
    std = np.sqrt(((row - mean) ** 2).sum() / (n - 1)) if n > 1 else 0.0
    median = srt[n // 2]
    mad = np.sort(np.abs(row - median))[n // 2]
    kth = srt[min(keep, n) - 1]
    order = np.lexsort((np.arange(n), row))
    return [mean, std, median, mad], [int(i) for i in order[: int((row <= kth).sum())]]


def format_line(tag: str, row: np.ndarray, names: list[str], keep: int) -> str:
    """A summary line of a distance row (the control's lines): name, the
    four statistics, then each nearest target, its distance and z-score."""
    stats, nearest = digest(row, keep)
    parts = [tag] + ["%.15g" % x for x in stats]
    for i in nearest:
        parts += [names[i], "%.15g" % row[i], "%.15g" % ((row[i] - stats[0]) / stats[1])]
    return "\t".join(parts)
