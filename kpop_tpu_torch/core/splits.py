"""Phylogenetic splits from embeddings (pseudo-phylogenies).

Re-implements the two splits algorithms of the reference
(lib/Matrix.ml:350-613) plus a container equivalent to BiOCamLib's
``Trees.Splits`` (not vendored in the reference snapshot):

- ``gaps``: per-dimension coordinate sort; the largest gaps between
  consecutive coordinates define splits (vectorized here);
- ``centroids``: recursive simulated-annealing bipartition maximizing
  centroid separation.

Since the reference's ``.PhyloSplits`` binary/text layouts are not available,
this project defines its own documented format:

    .PhyloSplits.txt:
        line 1: tab-separated quoted element names
        then one line per split: weight, then tab, then the comma-separated
        sorted indices of the elements on one side of the split.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import IO, List, Sequence, Tuple

import numpy as np

from ..io import framed
from ..utils.naming import (
    SPLITS_BIN_EXT,
    SPLITS_TABLE_EXT,
    close_if_owned,
    open_in,
    open_in_bin,
    open_out,
    open_out_bin,
    with_ext,
)
from ..utils.quoting import quote, strip_external_quotes_and_check
from .matrix import KPopMatrix, MatrixType


class UnknownAlgorithm(ValueError):
    pass


@dataclass
class Splits:
    element_names: List[str]
    splits: List[Tuple[frozenset, float]] = field(default_factory=list)

    def add_split(self, members: Sequence[int], weight: float) -> None:
        self.splits.append((frozenset(int(m) for m in members), float(weight)))

    # ---------------- I/O (kpop-tpu's own formats) ----------------

    def write_text(self, f: IO[str], precision: int = 10) -> None:
        fmt = "%.{}g".format(precision)
        f.write("\t".join(quote(n) for n in self.element_names) + "\n")
        for members, weight in self.splits:
            f.write(
                fmt % weight
                + "\t"
                + ",".join(str(i) for i in sorted(members))
                + "\n"
            )

    @classmethod
    def read_text(cls, f: IO[str]) -> "Splits":
        header = f.readline().rstrip("\n")
        names = (
            [strip_external_quotes_and_check(x) for x in header.split("\t")]
            if header
            else []
        )
        out = cls(names)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            weight = float(parts[0])
            members = (
                [int(x) for x in parts[1].split(",")] if parts[1] else []
            )
            out.add_split(members, weight)
        return out

    def to_file(self, prefix: str, precision: int = 10) -> None:
        path = with_ext(prefix, SPLITS_TABLE_EXT)
        f = open_out(path)
        try:
            self.write_text(f, precision=precision)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_file(cls, prefix: str) -> "Splits":
        path = with_ext(prefix, SPLITS_TABLE_EXT)
        f = open_in(path)
        try:
            return cls.read_text(f)
        finally:
            close_if_owned(f, path)

    def to_binary(self, prefix: str) -> None:
        path = with_ext(prefix, SPLITS_BIN_EXT)
        f = open_out_bin(path)
        try:
            framed.write_header(f, "PhyloSplits")
            framed.write_strings(f, "element_names", self.element_names)
            weights = np.array([w for _, w in self.splits])
            framed.write_array(f, "weights", weights)
            flat = []
            offsets = [0]
            for members, _ in self.splits:
                flat.extend(sorted(members))
                offsets.append(len(flat))
            framed.write_array(f, "members", np.array(flat, dtype=np.int64))
            framed.write_array(f, "offsets", np.array(offsets, dtype=np.int64))
            framed.write_terminator(f)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_binary(cls, prefix: str) -> "Splits":
        path = with_ext(prefix, SPLITS_BIN_EXT)
        f = open_in_bin(path)
        try:
            framed.read_header(f, expect_tag="PhyloSplits")
            frames = framed.read_frames(f)
        finally:
            close_if_owned(f, path)
        out = cls(framed.strings_of_frames(frames, "element_names"))
        weights = frames["weights"]
        members = frames["members"]
        offsets = frames["offsets"]
        for i, w in enumerate(weights):
            out.add_split(members[offsets[i] : offsets[i + 1]].tolist(), w)
        return out


# ---------------- gaps algorithm (lib/Matrix.ml:528-599) ----------------


def splits_gaps(m: KPopMatrix, max_splits: int) -> Splits:
    """Per-dimension sort; the ``max_splits`` largest coordinate gaps become
    splits whose side is the set of rows below the gap.  Ordering matches the
    reference: by decreasing gap, then increasing dimension, then index."""
    m.expect(MatrixType.VECTORS)
    data = np.asarray(m.matrix.data, dtype=np.float64)
    n, d = data.shape
    res = Splits(list(m.matrix.row_names))
    if n < 2:
        return res
    order = np.argsort(data, axis=0, kind="stable")  # [n, d]
    sorted_coords = np.take_along_axis(data, order, axis=0)
    gaps = sorted_coords[1:, :] - sorted_coords[:-1, :]  # [n-1, d]
    dim_idx = np.broadcast_to(np.arange(d)[None, :], gaps.shape)
    pos_idx = np.broadcast_to(np.arange(n - 1)[:, None], gaps.shape)
    flat = np.stack(
        [gaps.ravel(), dim_idx.ravel().astype(float), pos_idx.ravel().astype(float)],
        axis=1,
    )
    # sort by decreasing gap, then increasing dim, then increasing index
    perm = np.lexsort((flat[:, 2], flat[:, 1], -flat[:, 0]))
    for row in perm[: min(len(perm), max_splits)]:
        gap, dim, idx = flat[row]
        dim, idx = int(dim), int(idx)
        members = order[: idx + 1, dim]
        res.add_split(members, gap)
    return res


# ---------------- centroids algorithm (lib/Matrix.ml:364-522) ----------------


def _bipartition(
    data: np.ndarray,
    element_ids: List[int],
    rng: random.Random,
    acceptance_probability_at_zero: float = 0.2,
    difference_magnification_factor: float = 10.0,
) -> Tuple[List[int], List[int], float, int]:
    """Simulated-annealing bipartition maximizing centroid separation.

    Objective: sum over dims of |centroid_one - centroid_two| scaled by
    1/sqrt(1 + |n1 - n2|); centroids are means (sums when a side has <= 1
    element).  Moves are accepted with probability
    ``1 / (1 + (1-p0)/p0 * exp(-magnification * delta))``; the search stops
    after ``max(n, 40)`` consecutive rejections (lib/Matrix.ml:370-521).

    Documented deviation: a step cap of ``max(200 n, 20000)`` moves.  The
    reference has no cap, but its termination criterion has VANISHING
    stopping probability as n grows — per-move deltas shrink as O(1/n), so
    the acceptance probability floors at p0=0.2 and a run of n consecutive
    rejections has probability ~0.8^n (the reference would effectively
    never terminate at its own 10^4-sample relatedness workloads).  Small
    inputs terminate naturally long before the cap, so behaviour there is
    unchanged; capped runs return the best assignment seen.
    """
    inverse_acceptance = (
        1.0 - acceptance_probability_at_zero
    ) / acceptance_probability_at_zero
    neg_scale = -difference_magnification_factor
    n = len(element_ids)
    d = data.shape[1]
    # positional (not dict) assignment + an O(1)-amortized best tracker:
    # `changed` holds positions flipped since the last best snapshot, so a
    # new best merges only those instead of copying the whole assignment
    # (the old dict copy made annealing O(n) per improvement — quadratic
    # at the relatedness engine's 10^4-10^5 leaves)
    side = np.empty(n, dtype=np.int8)
    sums = [np.zeros(d), np.zeros(d)]
    cards = [0, 0]
    for pos, e in enumerate(element_ids):
        s = 1 if rng.random() < 0.5 else 0
        side[pos] = s
        sums[s] += data[e]
        cards[s] += 1

    def objective() -> float:
        if cards[0] == 0 or cards[1] == 0:
            return 0.0
        c0 = sums[0] / cards[0] if cards[0] > 1 else sums[0]
        c1 = sums[1] / cards[1] if cards[1] > 1 else sums[1]
        return float(np.abs(c0 - c1).sum()) / np.sqrt(
            1.0 + abs(cards[0] - cards[1])
        )

    obj = objective()
    best_obj = obj
    best_side = side.copy()
    changed: set = set()
    terminator = max(n, 40)
    step_cap = max(200 * n, 20_000)
    rejected = 0
    steps = 0
    while rejected < terminator and steps < step_cap:
        steps += 1
        pos = rng.randrange(n)
        e = element_ids[pos]
        s = int(side[pos])
        # tentative move
        sums[s] -= data[e]
        cards[s] -= 1
        sums[1 - s] += data[e]
        cards[1 - s] += 1
        side[pos] = 1 - s
        new_obj = objective()
        delta = new_obj - obj
        score = 1.0 / (1.0 + inverse_acceptance * np.exp(neg_scale * delta))
        if rng.random() <= score:
            rejected = 0
            obj = new_obj
            if obj > best_obj:
                best_obj = obj
                for c in changed:
                    best_side[c] = side[c]
                best_side[pos] = side[pos]
                changed.clear()
            else:
                changed.add(pos)
        else:
            rejected += 1
            side[pos] = s
            sums[1 - s] -= data[e]
            cards[1 - s] -= 1
            sums[s] += data[e]
            cards[s] += 1
    one = [e for pos, e in enumerate(element_ids) if best_side[pos] == 0]
    two = [e for pos, e in enumerate(element_ids) if best_side[pos] == 1]
    return one, two, best_obj, steps


def splits_centroids(
    m: KPopMatrix,
    max_splits: int,
    seed: int | None = None,
    backend: str = "auto",
) -> Splits:
    """Recursive bipartition (lib/Matrix.ml:601-613).  ``max_splits`` is
    ignored by the reference for this algorithm; we keep that behaviour.
    ``seed`` is a documented deviation for reproducibility.

    ``backend``: "python" (the reference implementation, random.Random
    stream), "native" (the C++ annealer, ~100x faster per move — the
    reference's 10^4-10^5-leaf relatedness trees are only feasible here),
    or "auto" (native above 512 elements when the toolchain is present).
    Both are deterministic under ``seed`` but use different RNG streams,
    so their trees differ for the same seed.
    """
    m.expect(MatrixType.VECTORS)
    data = np.asarray(m.matrix.data, dtype=np.float64)
    res = Splits(list(m.matrix.row_names))
    if backend not in ("auto", "python", "native"):
        raise UnknownAlgorithm(f"splits backend {backend!r}")
    use_native = backend == "native"
    if backend == "auto" and data.shape[0] > 512:
        try:
            from .. import native

            use_native = native.available()
        except ImportError:
            use_native = False
    if use_native:
        from .. import native

        actual_seed = (
            seed
            if seed is not None
            else random.Random().randrange(1 << 63)
        )
        offsets, members, weights = native.splits_centroids(
            data, actual_seed
        )
        for i in range(len(weights)):
            res.add_split(
                members[offsets[i] : offsets[i + 1]].tolist(),
                float(weights[i]),
            )
        return res
    rng = random.Random(seed)

    # iterative preorder worklist (one before two), identical emission and
    # rng order to the recursive form but safe at 10^4-10^5 leaves where
    # a skewed tree would blow Python's recursion limit
    stack: List[List[int]] = [list(range(data.shape[0]))]
    while stack:
        element_ids = stack.pop()
        if len(element_ids) > 1:
            one, two, obj, _ = _bipartition(data, element_ids, rng)
            if not one or not two:
                # degenerate annealing outcome: fall back to a trivial cut
                mid = len(element_ids) // 2
                one, two = element_ids[:mid], element_ids[mid:]
                obj = 0.0
            res.add_split(one, obj)
            stack.append(two)
            stack.append(one)
        else:
            res.add_split(element_ids, 0.0)
    return res


def get_splits(
    algorithm: str, max_splits: int, m: KPopMatrix, seed: int | None = None
) -> Splits:
    if algorithm == "gaps":
        return splits_gaps(m, max_splits)
    if algorithm == "centroids":
        return splits_centroids(m, max_splits, seed=seed)
    raise UnknownAlgorithm(algorithm)
