"""Immutable sorted-boundary interval maps with merge folds.

Reference: accord/utils/ReducingIntervalMap.java:49 / ReducingRangeMap.java:30 —
the backing structure for RedundantBefore, DurableBefore and MaxConflicts range
maps (SURVEY.md §2.3).

Representation: sorted boundary tokens ``bounds = [b0..b_{n-1}]`` and
``values = [v0..v_n]`` where values[i] covers the half-open span
[bounds[i-1], bounds[i]) (values[0] covers (-inf, b0), values[n] covers
[b_{n-1}, +inf)). Values may be None meaning "no information".
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Callable, Generic, List, Optional, Sequence, Tuple, TypeVar

from accord_tpu_torch.utils.sorted_arrays import find_floor

V = TypeVar("V")


class ReducingIntervalMap(Generic[V]):
    __slots__ = ("bounds", "values")

    def __init__(self, bounds: Sequence = (), values: Sequence = (None,)):
        assert len(values) == len(bounds) + 1
        self.bounds: Tuple = tuple(bounds)
        self.values: Tuple = tuple(values)

    @classmethod
    def empty(cls) -> "ReducingIntervalMap":
        return cls((), (None,))

    def get(self, point) -> Optional[V]:
        return self.values[find_floor(self.bounds, point) + 1]

    def _normalized(self, bounds: List, values: List) -> "ReducingIntervalMap":
        # Coalesce adjacent equal values.
        nb: List = []
        nv: List = [values[0]]
        for i, b in enumerate(bounds):
            if values[i + 1] != nv[-1]:
                nb.append(b)
                nv.append(values[i + 1])
        return type(self)(nb, nv)

    def update(self, start, end, value: V,
               reduce_fn: Callable[[V, V], V]) -> "ReducingIntervalMap":
        """Fold `value` into span [start, end) with reduce_fn(old, new).

        Single spliced walk (two bisects + one copy) — this runs on every
        MaxConflicts/RedundantBefore advance, i.e. per commit on the host
        hot path, where the old sorted(set(...))-plus-binary-search-per-
        boundary formulation was a top-five profile entry."""
        if not (start < end):
            return self
        bounds, values = self.bounds, self.values
        i_s = bisect_right(bounds, start)  # span containing `start`
        i_e = bisect_left(bounds, end)     # last span reaching below `end`
        nb: List = list(bounds[:i_s])
        nv: List = list(values[:i_s + 1])

        def push(b, v):
            # append the span starting at `b`, coalescing equal neighbours
            # inline — only the spliced seams are compared, never the
            # (already-normalized) untouched prefix/suffix
            if v != nv[-1]:
                nb.append(b)
                nv.append(v)

        old = nv[-1]
        folded = reduce_fn(old, value) if old is not None else value
        if nb and nb[-1] == start:
            nb.pop()                       # span i_s starts exactly at
            nv.pop()                       # `start`: fold it in place
        push(start, folded)
        for j in range(i_s, i_e):
            old = values[j + 1]
            push(bounds[j],
                 reduce_fn(old, value) if old is not None else value)
        if not (i_e < len(bounds) and bounds[i_e] == end):
            push(end, values[i_e])         # resume the split span's value
        if i_e < len(bounds):
            push(bounds[i_e], values[i_e + 1])
            nb.extend(bounds[i_e + 1:])
            nv.extend(values[i_e + 2:])
        return type(self)(nb, nv)

    def merge(self, other: "ReducingIntervalMap[V]",
              reduce_fn: Callable[[V, V], V]) -> "ReducingIntervalMap[V]":
        """Pointwise merge of two maps with reduce_fn on overlapping info."""
        def combine(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return reduce_fn(a, b)

        points = sorted(set(self.bounds) | set(other.bounds))
        values: List = [combine(self.values[0], other.values[0])]
        for p in points:
            values.append(combine(self.get(p), other.get(p)))
        return self._normalized(points, values)

    def fold(self, fn: Callable, acc, start=None, end=None):
        """foldl fn(acc, span_start, span_end, value) over non-None spans
        intersecting [start, end). span_start/span_end may be None (unbounded)."""
        spans = self.spans()
        for s, e, v in spans:
            if v is None:
                continue
            if start is not None and e is not None and e <= start:
                continue
            if end is not None and s is not None and s >= end:
                continue
            acc = fn(acc, s, e, v)
        return acc

    def fold_intersecting(self, start, end, fn: Callable, acc):
        """foldl fn(acc, value_or_None) over every span (including
        no-information None spans) intersecting [start, end)."""
        for s, e, v in self.spans():
            if (e is not None and e <= start) or (s is not None and s >= end):
                continue
            acc = fn(acc, v)
        return acc

    def spans(self) -> List[Tuple]:
        """[(start|None, end|None, value)] covering the whole line."""
        out: List[Tuple] = []
        prev = None
        for i, b in enumerate(self.bounds):
            out.append((prev, b, self.values[i]))
            prev = b
        out.append((prev, None, self.values[-1]))
        return out

    def __eq__(self, other):
        return (type(self) is type(other) and self.bounds == other.bounds
                and self.values == other.values)

    def __hash__(self):
        return hash((self.bounds, self.values))

    def __repr__(self):
        return f"{type(self).__name__}({self.spans()!r})"


class ReducingRangeMap(ReducingIntervalMap[V]):
    """Interval map keyed by routing-key tokens; adds Ranges-aware folds."""

    def get_range_min(self, start, end, default=None):
        """Minimum non-None value over [start, end); default if any span None."""
        result = []

        def f(acc, s, e, v):
            acc.append(v)
            return acc

        covered = self.fold(f, result, start, end)
        # check coverage for None spans intersecting
        for s, e, v in self.spans():
            s_eff = s
            e_eff = e
            inter = not ((e_eff is not None and e_eff <= start)
                         or (s_eff is not None and s_eff >= end))
            if inter and v is None:
                return default
        return min(covered) if covered else default

    def fold_max(self, start, end, default=None):
        """Maximum value over spans intersecting [start, end)."""
        best = default

        def f(acc, s, e, v):
            return v if acc is None or v > acc else acc

        return self.fold(f, best, start, end)
