"""Sorted-array kernels (reference: accord/utils/SortedArrays.java:44).

The reference's workhorse tier: merge/intersect/subtract over sorted unique
arrays, and exponential+binary search with CEIL/FLOOR/FAST semantics. Host-side
(Python) implementations here operate on lists/tuples of comparable values.

A copy of the pure-Python tier of ``accord_tpu/utils/sorted_arrays.py``; the
JAX package binds C++ mirrors over it (pinned identical to this tier), which
the port does not carry.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence, TypeVar

T = TypeVar("T")


class Search(enum.Enum):
    FAST = 0   # any match position (first in our impl)
    CEIL = 1   # first element >= target
    FLOOR = 2  # last element <= target


def is_sorted_unique(xs: Sequence) -> bool:
    return all(xs[i] < xs[i + 1] for i in range(len(xs) - 1))


def binary_search(xs: Sequence, target, lo: int = 0, hi: Optional[int] = None,
                  mode: Search = Search.FAST) -> int:
    """Search sorted unique xs[lo:hi] for target.

    Returns index of match if found; otherwise -(insertion_point) - 1
    (the Java convention, so callers can recover the insertion point).
    For CEIL/FLOOR on a miss the insertion point encodes the ceil index /
    floor index + 1 respectively (identical maths, documented for clarity).
    """
    if hi is None:
        hi = len(xs)
    while lo < hi:
        mid = (lo + hi) // 2
        v = xs[mid]
        if v < target:
            lo = mid + 1
        elif target < v:
            hi = mid
        else:
            return mid
    return -(lo + 1)


def exponential_search(xs: Sequence, target, lo: int = 0, hi: Optional[int] = None,
                       mode: Search = Search.FAST) -> int:
    """Gallop from lo then binary search. Same return convention as binary_search.

    Reference uses this for merge loops where successive probes are nearby
    (SortedArrays.java exponentialSearch).
    """
    if hi is None:
        hi = len(xs)
    bound = 1
    prev = lo
    while lo + bound < hi:
        v = xs[lo + bound]
        if v < target:
            prev = lo + bound
            bound <<= 1
        elif target < v:
            return binary_search(xs, target, prev, lo + bound, mode)
        else:
            return lo + bound
    return binary_search(xs, target, prev, hi, mode)


def find_ceil(xs: Sequence, target, lo: int = 0, hi: Optional[int] = None) -> int:
    """Index of first element >= target, or hi/len if none."""
    i = binary_search(xs, target, lo, hi)
    return i if i >= 0 else -1 - i


def find_floor(xs: Sequence, target, lo: int = 0, hi: Optional[int] = None) -> int:
    """Index of last element <= target, or lo-1 if none."""
    i = binary_search(xs, target, lo, hi)
    return i if i >= 0 else (-1 - i) - 1


def find_next(xs: Sequence, from_idx: int, target) -> int:
    """Exponential-search ceil starting at from_idx (merge-loop helper)."""
    i = exponential_search(xs, target, from_idx)
    return i if i >= 0 else -1 - i


def linear_union(a: Sequence[T], b: Sequence[T]) -> list:
    """Union of two sorted unique sequences, sorted unique.

    Reference: SortedArrays.linearUnion (returns one input when it subsumes the
    other; we mirror that by returning the input object itself when possible so
    identity checks can skip copies).
    """
    if not a:
        return b if isinstance(b, list) else list(b)
    if not b:
        return a if isinstance(a, list) else list(a)
    out: list = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            out.append(x); i += 1
        elif y < x:
            out.append(y); j += 1
        else:
            out.append(x); i += 1; j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


def linear_merge_n(lists: Sequence[Sequence[T]]) -> list:
    """k-way union of sorted unique sequences (the id-pool union of
    RelationMultiMap.LinearMerger): iterative pairwise merge."""
    if not lists:
        return []
    acc = list(lists[0])
    for nxt in lists[1:]:
        acc = linear_union(acc, nxt)
    return acc


def linear_intersection(a: Sequence[T], b: Sequence[T]) -> list:
    out: list = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            i += 1
        elif y < x:
            j += 1
        else:
            out.append(x); i += 1; j += 1
    return out


def linear_subtract(a: Sequence[T], b: Sequence[T]) -> list:
    """a \\ b over sorted unique sequences."""
    out: list = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            out.append(x); i += 1
        elif y < x:
            j += 1
        else:
            i += 1; j += 1
    out.extend(a[i:])
    return out


def next_intersection(a: Sequence, ai: int, b: Sequence, bi: int):
    """Advance (ai, bi) to the next pair with a[ai] == b[bi]; None if exhausted.

    Reference: Routables.findNextIntersection-style merge stepping.
    """
    na, nb = len(a), len(b)
    while ai < na and bi < nb:
        x, y = a[ai], b[bi]
        if x < y:
            ai = find_next(a, ai + 1, y)
        elif y < x:
            bi = find_next(b, bi + 1, x)
        else:
            return ai, bi
    return None


def merge_sorted_unique(arrays: Sequence[Sequence[T]]) -> list:
    """N-way union (reference: RelationMultiMap.LinearMerger shape).
    Alias of linear_merge_n, kept for its established callers."""
    return linear_merge_n([a for a in arrays if a])


def fold_intersection(a: Sequence, b: Sequence, fn: Callable, acc):
    """foldl over the intersection of two sorted sequences."""
    pos = next_intersection(a, 0, b, 0)
    while pos is not None:
        ai, bi = pos
        acc = fn(acc, a[ai])
        pos = next_intersection(a, ai + 1, b, bi + 1)
    return acc
