"""1-D nearest-pair iterator: enumerate index pairs by increasing
single-coordinate distance.

Re-implements ``Space.Distance.Iterator`` (reference lib/Space.ml:231-487),
the groundwork for sparse neighbor search, exercised by the reference's only
golden unit test (test/DistanceIterator.ml / .txt — which
tests/test_distance_iterator.py reproduces pair-for-pair, including
IEEE-float tie behaviour).

Model: coordinates are grouped by distinct value ("groups", sorted).  An
*interval at stride s* is a pair of groups whose ranks differ by s; the
iterator keeps, per stride, one current interval and enumerates element
pairs inside it.  Stride 0 intervals are coinciding-point groups.  At each
step the minimum-difference stride state is advanced; when the topmost
stride is consumed the next stride is seeded with the current difference as
a lower bound.  ``max_distance_component`` prunes strides whose minimal
distance component exceeds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .space import Distance


def component_distance(distance: Distance, metric_value: float):
    """Unscaled single-component distance of a coordinate difference
    (lib/Space.ml:150-155)."""

    def f(diff: float) -> float:
        if distance.kind in ("euclidean", "cosine"):
            return diff * diff * metric_value
        return abs(diff) ** distance.power * metric_value

    return f


@dataclass
class _State:
    lo_group: int  # group rank
    lo_pos: int  # position within group's index list
    hi_group: int
    hi_pos: int


class DistanceIterator:
    def __init__(
        self,
        distance: Distance,
        metric_value: float,
        init: Callable[[int], float],
        n: int,
        max_distance_component: float = float("inf"),
    ):
        self.compute_component = component_distance(distance, metric_value)
        self.n = n
        by_coord: Dict[float, List[int]] = {}
        for i in range(n):
            by_coord.setdefault(init(i), []).append(i)
        self.coords = sorted(by_coord)
        self.groups = [sorted(by_coord[c]) for c in self.coords]
        self.state: Dict[int, _State] = {}
        mdc = max_distance_component
        w = self._minimum(0, float("-inf"), mdc)
        if w is not None:
            self.state[0] = w
        else:
            w = self._minimum(1, float("-inf"), mdc)
            if w is not None:
                self.state[1] = w

    # ---- helpers ----

    def _diff(self, st: _State) -> float:
        return self.coords[st.hi_group] - self.coords[st.lo_group]

    def range(self) -> Tuple[float, float]:
        if self.n == 0:
            return 0.0, 0.0
        return self.coords[0], self.coords[-1]

    def _minimum(
        self, stride: int, diff_bound: float, mdc: float
    ) -> Optional[_State]:
        """Minimum-difference interval of a stride with diff > diff_bound
        (lib/Space.ml:274-320).  First occurrence wins among equals."""
        g = len(self.groups)
        if stride == 0:
            for gi in range(g):
                if len(self.groups[gi]) > 1:
                    return _State(gi, 0, gi, 1)
            return None
        if stride >= g:
            return None
        best: Optional[_State] = None
        best_diff = float("inf")
        for lo in range(g - stride):
            diff = self.coords[lo + stride] - self.coords[lo]
            if diff > diff_bound and diff < best_diff:
                best_diff = diff
                best = _State(lo, 0, lo + stride, 0)
        if best is not None and self.compute_component(best_diff) <= mdc:
            return best
        return None

    def _next(self, stride: int, st: _State, mdc: float) -> Optional[_State]:
        """Next valid interval within a stride (lib/Space.ml:324-405):
        same-difference intervals come after the current one; larger
        differences restart the scan via :meth:`_minimum`."""
        diff = self._diff(st)
        if stride == 0:
            grp = self.groups[st.lo_group]
            lo, hi = st.lo_pos, st.hi_pos
            if hi + 1 < len(grp):
                return _State(st.lo_group, lo, st.lo_group, hi + 1)
            if lo + 2 < len(grp):
                return _State(st.lo_group, lo + 1, st.lo_group, lo + 2)
            for gi in range(st.lo_group + 1, len(self.groups)):
                if len(self.groups[gi]) > 1:
                    return _State(gi, 0, gi, 1)
            return None  # stride-0 differences are all 0; no larger ones
        lo_grp = self.groups[st.lo_group]
        hi_grp = self.groups[st.hi_group]
        if st.hi_pos + 1 < len(hi_grp):
            return _State(st.lo_group, st.lo_pos, st.hi_group, st.hi_pos + 1)
        if st.lo_pos + 1 < len(lo_grp):
            return _State(st.lo_group, st.lo_pos + 1, st.hi_group, 0)
        # scan forward for the next group pair with exactly the same diff
        g = len(self.groups)
        lo = st.lo_group
        while True:
            lo += 1
            hi = lo + stride
            if hi >= g:
                break
            if self.coords[hi] - self.coords[lo] == diff:
                return _State(lo, 0, hi, 0)
        return self._minimum(stride, diff, mdc)

    # ---- public protocol (get_opt / incr) ----

    def _find_minimum_stride(self) -> int:
        best_stride = -1
        best_diff = float("inf")
        for stride in sorted(self.state):  # lowest stride wins ties
            d = self._diff(self.state[stride])
            if d < best_diff:
                best_diff = d
                best_stride = stride
        return best_stride

    def get_opt(self) -> Optional[Tuple[int, int, float]]:
        if not self.state:
            return None
        st = self.state[self._find_minimum_stride()]
        i = self.groups[st.lo_group][st.lo_pos]
        j = self.groups[st.hi_group][st.hi_pos]
        return min(i, j), max(i, j), self.compute_component(self._diff(st))

    def incr(self, max_distance_component: float = float("inf")) -> None:
        if not self.state:
            return
        mdc = max_distance_component
        stride = self._find_minimum_stride()
        st = self.state[stride]
        diff = self._diff(st)
        nxt = self._next(stride, st, mdc)
        if nxt is None:
            del self.state[stride]
        else:
            self.state[stride] = nxt
        if self.state:
            top = max(self.state)
            if stride == top and stride + 1 != self.n:
                w = self._minimum(stride + 1, diff, mdc)
                if w is not None:
                    self.state[stride + 1] = w

def iterate_pairs(
    distance: Distance,
    metric_value: float,
    coords: List[float],
    max_distance_component: float = float("inf"),
):
    """Convenience generator over all pairs in increasing component order."""
    it = DistanceIterator(
        distance, metric_value, lambda i: coords[i], len(coords),
        max_distance_component,
    )
    while True:
        res = it.get_opt()
        if res is None:
            return
        yield res
        it.incr(max_distance_component=max_distance_component)
