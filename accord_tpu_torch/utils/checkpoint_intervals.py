"""Checkpoint-interval index for interval stabbing queries (CINTIA).

Reference: accord/utils/CheckpointIntervalArray.java:28-84 and its RangeDeps
instantiation SearchableRangeList.java:79 — intervals sorted by start, with
periodic *checkpoints*: every C entries, a list of earlier intervals that are
still "open" (their end extends past the checkpoint's start), so a stabbing
query scans at most C entries plus one checkpoint list instead of the whole
prefix. O(N) space, O(lg N + K) query.

The reference builds a considerably more engineered structure (tenuring
heuristics, scan-distance headers packed into the sorted array,
CheckpointIntervalArrayBuilder.java:1133LoC); this keeps the same asymptotics
and query semantics with a plain layout. The arrays (`starts`, `ends`,
checkpoint CSR) are flat int lists on purpose: the device tier consumes the
same layout for batched stabbing (accord_tpu_torch.ops).
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Sequence, Tuple

from accord_tpu_torch import native as _native_pkg

_native_mod = _native_pkg.get()

CHECKPOINT_EVERY = 8


class CheckpointIntervalIndex:
    """Stabbing index over half-open intervals [start, end), sorted by
    (start, end). `find(point)` yields indices of every interval containing
    the point; `find_overlaps(lo, hi)` every interval intersecting [lo, hi).
    """

    __slots__ = ("starts", "ends", "_cp_offsets", "_cp_entries", "_every",
                 "_capsule")

    def __init__(self, starts: Sequence[int], ends: Sequence[int],
                 every: int = CHECKPOINT_EVERY):
        n = len(starts)
        assert n == len(ends)
        assert all(starts[i] <= starts[i + 1] for i in range(n - 1)), \
            "intervals must be sorted by start"
        if every <= 0:
            raise ValueError("checkpoint spacing must be positive")
        self.starts = list(starts)
        self.ends = list(ends)
        self._every = every
        # native: one conversion at build time into an opaque capsule of
        # int64 arrays; queries run against it with no per-query marshalling
        self._capsule = None
        if _native_mod is not None and hasattr(_native_mod, "cintia_build"):
            try:
                self._capsule = _native_mod.cintia_build(
                    self.starts, self.ends, every)
            except (OverflowError, TypeError):
                # tokens wider than int64, or non-int comparables (any
                # ordered numbers work on the Python tier): fall back
                self._capsule = None
        self._cp_offsets = None  # built lazily when the Python tier is used
        self._cp_entries = None
        if self._capsule is None:
            self._build_py_checkpoints()

    def _build_py_checkpoints(self) -> None:
        # checkpoint c (at index c*every) lists every i < c*every with
        # end > starts[c*every]: the intervals still open at the checkpoint
        offsets: List[int] = []
        entries: List[int] = []
        for cp in range(0, len(self.starts), self._every):
            if cp > 0:
                boundary = self.starts[cp]
                for i in range(cp):
                    if self.ends[i] > boundary:
                        entries.append(i)
            offsets.append(len(entries))
        self._cp_offsets = offsets   # offsets[c] = end of checkpoint c's list
        self._cp_entries = entries

    def __len__(self) -> int:
        return len(self.starts)

    def _checkpoint_span(self, cp_idx: int) -> Tuple[int, int]:
        c = cp_idx // self._every
        lo = self._cp_offsets[c - 1] if c > 0 else 0
        return lo, self._cp_offsets[c]

    def find(self, point: int, fn: Callable[[int], None]) -> None:
        """Visit the index of every interval with start <= point < end,
        in ascending index order."""
        if self._capsule is not None:
            try:
                found = _native_mod.cintia_find(self._capsule, point)
            except (OverflowError, TypeError):  # point outside int64 / non-int
                found = None
            if found is not None:
                # callbacks run OUTSIDE the try: their own exceptions must
                # propagate, not trigger a duplicate Python-tier pass
                for i in found:
                    fn(i)
                return
        if self._cp_offsets is None:
            self._build_py_checkpoints()
        # j = count of intervals with start <= point
        j = bisect.bisect_right(self.starts, point)
        if j == 0:
            return
        cp = ((j - 1) // self._every) * self._every
        lo, hi = self._checkpoint_span(cp)
        for e in range(lo, hi):
            i = self._cp_entries[e]
            if self.ends[i] > point:
                fn(i)
        for i in range(cp, j):
            if self.ends[i] > point:
                fn(i)

    def find_overlaps(self, lo: int, hi: int, fn: Callable[[int], None]) -> None:
        """Visit every interval intersecting [lo, hi): interval.start < hi and
        interval.end > lo. Ascending index order, each at most once."""
        if self._capsule is not None:
            try:
                found = _native_mod.cintia_overlaps(self._capsule, lo, hi)
            except (OverflowError, TypeError):
                found = None
            if found is not None:
                for i in found:
                    fn(i)
                return
        if self._cp_offsets is None:
            self._build_py_checkpoints()
        j = bisect.bisect_left(self.starts, hi)  # intervals with start < hi
        if j == 0:
            return
        # intervals containing lo (starts <= lo), via the checkpoint machinery
        jlo = bisect.bisect_right(self.starts, lo)
        if jlo > 0:
            cp = ((jlo - 1) // self._every) * self._every
            clo, chi = self._checkpoint_span(cp)
            for e in range(clo, chi):
                i = self._cp_entries[e]
                if self.ends[i] > lo:
                    fn(i)
            for i in range(cp, jlo):
                if self.ends[i] > lo:
                    fn(i)
        # intervals starting inside (lo, hi): indices [jlo, j); all have
        # end > start > lo, so all intersect
        for i in range(jlo, j):
            fn(i)

    @classmethod
    def brute(cls, starts: Sequence[int], ends: Sequence[int], point: int
              ) -> List[int]:
        """Reference oracle for tests."""
        return [i for i in range(len(starts))
                if starts[i] <= point < ends[i]]
