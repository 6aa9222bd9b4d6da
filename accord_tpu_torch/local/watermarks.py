"""Per-store range-map watermarks: MaxConflicts, RedundantBefore, DurableBefore.

Reference: accord/local/MaxConflicts.java:28, RedundantBefore.java:37-120,
DurableBefore.java:39-180, all backed by ReducingRangeMap (SURVEY.md §2.3/§2.8).
"""

from __future__ import annotations

import enum
from bisect import bisect_left, insort
from typing import Optional, Tuple

from accord_tpu_torch.primitives.keys import Keys, Ranges, RoutingKey, _SortedKeyList
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TXNID_NONE
from accord_tpu_torch.utils.interval_map import ReducingRangeMap


class MaxConflicts:
    """token-range -> max conflict Timestamp; consulted for executeAt proposal
    (MaxConflicts.java:28).

    Split representation: single-key advances (every preaccept/commit of a
    key txn — the host hot path) land in a plain token -> max dict with a
    sorted-token sidecar for range folds, while range-shaped advances
    (range txns / sync points) keep the immutable ReducingRangeMap.  A
    query folds both; the old all-interval-map form rebuilt the whole
    boundary tuple per key per commit."""

    def __init__(self):
        self._map: ReducingRangeMap = ReducingRangeMap()
        self._points: dict = {}          # token -> max Timestamp
        self._point_toks: list = []      # sorted tokens (range-fold sidecar)

    def get(self, participants) -> Optional[Timestamp]:
        """Max conflict over a Keys/Ranges selection."""
        best: Optional[Timestamp] = None
        points = self._points
        if isinstance(participants, _SortedKeyList):
            for k in participants:
                v = points.get(k.token)
                if v is not None and (best is None or v > best):
                    best = v
                v = self._map.get(k.token)
                if v is not None and (best is None or v > best):
                    best = v
        else:
            toks = self._point_toks
            for r in participants:
                lo = bisect_left(toks, r.start)
                hi = bisect_left(toks, r.end, lo)
                for i in range(lo, hi):
                    v = points[toks[i]]
                    if best is None or v > best:
                        best = v
                v = self._map.fold_max(r.start, r.end)
                if v is not None and (best is None or v > best):
                    best = v
        return best

    def update(self, participants, ts: Timestamp) -> None:
        if isinstance(participants, _SortedKeyList):
            points = self._points
            toks = self._point_toks
            for k in participants:
                tok = k.token
                cur = points.get(tok)
                if cur is None:
                    points[tok] = ts
                    insort(toks, tok)
                elif ts > cur:
                    points[tok] = ts
        else:
            for r in participants:
                self._map = self._map.update(r.start, r.end, ts, max)


class PreBootstrapOrStale(enum.Enum):
    """Classification of a TxnId against a range's bootstrap/staleness state
    (RedundantBefore.PreBootstrapOrStale)."""

    FULLY = "FULLY"
    PARTIALLY = "PARTIALLY"
    POST_BOOTSTRAP = "POST_BOOTSTRAP"


class RedundantEntry:
    """Per-range redundancy facts (RedundantBefore.Entry)."""

    __slots__ = ("locally_applied_before", "shard_applied_before",
                 "bootstrapped_at", "stale_until_at_least")

    def __init__(self, locally_applied_before: TxnId = TXNID_NONE,
                 shard_applied_before: TxnId = TXNID_NONE,
                 bootstrapped_at: TxnId = TXNID_NONE,
                 stale_until_at_least: Optional[Timestamp] = None):
        self.locally_applied_before = locally_applied_before
        self.shard_applied_before = shard_applied_before
        self.bootstrapped_at = bootstrapped_at
        self.stale_until_at_least = stale_until_at_least

    @staticmethod
    def merge(a: "RedundantEntry", b: "RedundantEntry") -> "RedundantEntry":
        return RedundantEntry(
            max(a.locally_applied_before, b.locally_applied_before),
            max(a.shard_applied_before, b.shard_applied_before),
            max(a.bootstrapped_at, b.bootstrapped_at),
            Timestamp.non_null_or_max(a.stale_until_at_least,
                                      b.stale_until_at_least))

    def __eq__(self, other):
        return (isinstance(other, RedundantEntry)
                and self.locally_applied_before == other.locally_applied_before
                and self.shard_applied_before == other.shard_applied_before
                and self.bootstrapped_at == other.bootstrapped_at
                and self.stale_until_at_least == other.stale_until_at_least)

    def __repr__(self):
        return (f"RedundantEntry(local<{self.locally_applied_before!r}, "
                f"shard<{self.shard_applied_before!r}, "
                f"boot@{self.bootstrapped_at!r})")


class RedundantBefore:
    """Range map of RedundantEntry: classifies TxnIds as live / redundant /
    pre-bootstrap per range; prunes deps and gates GC (RedundantBefore.java)."""

    def __init__(self):
        self._map: ReducingRangeMap = ReducingRangeMap()

    def _entry_for_key(self, key: RoutingKey) -> Optional[RedundantEntry]:
        return self._map.get(key.token)

    def update_locally_applied(self, ranges: Ranges, before: TxnId) -> None:
        e = RedundantEntry(locally_applied_before=before)
        for r in ranges:
            self._map = self._map.update(r.start, r.end, e, RedundantEntry.merge)

    def update_shard_applied(self, ranges: Ranges, before: TxnId) -> None:
        e = RedundantEntry(shard_applied_before=before)
        for r in ranges:
            self._map = self._map.update(r.start, r.end, e, RedundantEntry.merge)

    def set_bootstrapped_at(self, ranges: Ranges, at: TxnId) -> None:
        e = RedundantEntry(bootstrapped_at=at)
        for r in ranges:
            self._map = self._map.update(r.start, r.end, e, RedundantEntry.merge)

    def set_stale_until(self, ranges: Ranges, until: Timestamp) -> None:
        e = RedundantEntry(stale_until_at_least=until)
        for r in ranges:
            self._map = self._map.update(r.start, r.end, e, RedundantEntry.merge)

    def is_redundant(self, txn_id: TxnId, key: RoutingKey) -> bool:
        e = self._entry_for_key(key)
        return e is not None and txn_id < max(e.locally_applied_before,
                                              e.bootstrapped_at)

    def is_shard_redundant(self, txn_id: TxnId, key: RoutingKey) -> bool:
        e = self._entry_for_key(key)
        return e is not None and txn_id < e.shard_applied_before

    def shard_applied_before(self, key: RoutingKey) -> TxnId:
        """The shard-applied fence at `key` (NONE when no fact recorded)."""
        e = self._entry_for_key(key)
        return e.shard_applied_before if e is not None else TXNID_NONE

    def is_any_shard_redundant(self, txn_id: TxnId, ranges: Ranges) -> bool:
        """Does ANY span intersecting `ranges` place txn_id below the
        shard-applied fence? Folds every intersecting map span — an interior
        fenced span must be seen even when the range endpoints are not fenced
        (RedundantBefore fold semantics, not endpoint probing)."""
        def f(acc, v):
            return acc or (v is not None and txn_id < v.shard_applied_before)

        return any(self._map.fold_intersecting(r.start, r.end, f, False)
                   for r in ranges)

    def is_all_redundant(self, txn_id: TxnId, ranges: Ranges) -> bool:
        """Is txn_id below the locally-applied/bootstrap watermark on EVERY
        span intersecting `ranges`? Uncovered (None) spans are NOT redundant:
        an interior sub-range with no bootstrap/applied fact must keep the
        dependency live there (ADVICE r1: endpoint probes missed interiors)."""
        if ranges.is_empty:
            return False

        def f(acc, v):
            return acc and v is not None and txn_id < max(
                v.locally_applied_before, v.bootstrapped_at)

        return all(self._map.fold_intersecting(r.start, r.end, f, True)
                   for r in ranges)

    def pre_bootstrap_or_stale(self, txn_id: TxnId, participants
                               ) -> PreBootstrapOrStale:
        """Is txn_id before the bootstrap fence / within a stale window for
        (some of) its participants?"""
        def probe(e: Optional[RedundantEntry]) -> bool:
            return e is not None and (
                txn_id < e.bootstrapped_at
                or (e.stale_until_at_least is not None
                    and txn_id < e.stale_until_at_least))

        pre = post = False
        if isinstance(participants, _SortedKeyList):
            probes = [probe(self._entry_for_key(k)) for k in participants]
        else:
            # evaluate every map span intersecting each range, so a fence
            # covering only part of the span is seen
            probes = []
            for r in participants:
                self._map.fold_intersecting(
                    r.start, r.end, lambda acc, v: probes.append(probe(v)), None)
        pre = any(probes)
        post = not all(probes) or not probes
        if pre and not post:
            return PreBootstrapOrStale.FULLY
        if pre:
            return PreBootstrapOrStale.PARTIALLY
        return PreBootstrapOrStale.POST_BOOTSTRAP

    def min_locally_applied_before(self, ranges: Ranges) -> TxnId:
        """Floor watermark across `ranges`: any uncovered span floors the
        result to NONE (for GC gating)."""
        def fold(acc, v):
            w = v.locally_applied_before if v is not None else TXNID_NONE
            return w if acc is None else min(acc, w)

        result: Optional[TxnId] = None
        for r in ranges:
            result = self._map.fold_intersecting(r.start, r.end, fold, result)
        return result if result is not None else TXNID_NONE

    def min_shard_applied_before(self, ranges: Ranges) -> TxnId:
        """Floor of the shard-applied fence across `ranges` (census gauge;
        uncovered spans floor to NONE like min_locally_applied_before)."""
        def fold(acc, v):
            w = v.shard_applied_before if v is not None else TXNID_NONE
            return w if acc is None else min(acc, w)

        result: Optional[TxnId] = None
        for r in ranges:
            result = self._map.fold_intersecting(r.start, r.end, fold, result)
        return result if result is not None else TXNID_NONE

    def audit_low_bound(self, ranges: Ranges) -> Timestamp:
        """The replica-state auditor's LOW digest bound for this replica
        over `ranges`: the max, over every intersecting span, of
        bootstrapped_at and any staleness fence.  Below it this replica's
        history may legitimately be a snapshot-shaped hole (bootstrap
        installed data, not command metadata; a stale span is mid-reacquire)
        — cross-replica digests must not cover it (local/audit.py)."""
        bound: Timestamp = TXNID_NONE

        def fold(acc, v):
            if v is None:
                return acc
            m = v.bootstrapped_at
            if v.stale_until_at_least is not None \
                    and v.stale_until_at_least > m:
                m = v.stale_until_at_least
            return m if m > acc else acc

        for r in ranges:
            bound = self._map.fold_intersecting(r.start, r.end, fold, bound)
        return bound


class DurableBefore:
    """Range map -> {majority_before, universal_before} TxnId durability bounds
    (DurableBefore.java:39-180): NotDurable / MajorityOrInvalidated /
    UniversalOrInvalidated classes for GC."""

    class Entry:
        __slots__ = ("majority_before", "universal_before")

        def __init__(self, majority_before: TxnId = TXNID_NONE,
                     universal_before: TxnId = TXNID_NONE):
            self.majority_before = majority_before
            self.universal_before = universal_before

        @staticmethod
        def merge_max(a: "DurableBefore.Entry", b: "DurableBefore.Entry"):
            return DurableBefore.Entry(
                max(a.majority_before, b.majority_before),
                max(a.universal_before, b.universal_before))

    def __init__(self):
        self._map: ReducingRangeMap = ReducingRangeMap()

    def update(self, ranges: Ranges, majority_before: TxnId,
               universal_before: TxnId = TXNID_NONE) -> None:
        e = DurableBefore.Entry(majority_before, universal_before)
        for r in ranges:
            self._map = self._map.update(r.start, r.end, e,
                                         DurableBefore.Entry.merge_max)

    def is_majority_durable(self, txn_id: TxnId, key: RoutingKey) -> bool:
        e = self._map.get(key.token)
        return e is not None and txn_id < e.majority_before

    def is_any_majority_durable(self, txn_id: TxnId, ranges: Ranges) -> bool:
        """Does some span of `ranges` hold a majority bound above txn_id?"""
        def fold(acc, _s, _e, v):
            return acc or txn_id < v.majority_before

        return any(self._map.fold(fold, False, start=r.start, end=r.end)
                   for r in ranges)

    def is_universally_durable(self, txn_id: TxnId, key: RoutingKey) -> bool:
        e = self._map.get(key.token)
        return e is not None and txn_id < e.universal_before

    def majority_before(self, key: RoutingKey) -> TxnId:
        e = self._map.get(key.token)
        return e.majority_before if e is not None else TXNID_NONE

    def universal_before(self, key: RoutingKey) -> TxnId:
        e = self._map.get(key.token)
        return e.universal_before if e is not None else TXNID_NONE

    def min_bounds(self, ranges: Ranges) -> Tuple[TxnId, TxnId]:
        """Floor (majority, universal) bounds across `ranges`; any uncovered
        span floors to NONE (the min-merge of DurableBefore.java's global
        aggregation)."""
        def fold(acc, v):
            maj = v.majority_before if v is not None else TXNID_NONE
            uni = v.universal_before if v is not None else TXNID_NONE
            if acc is None:
                return (maj, uni)
            return (min(acc[0], maj), min(acc[1], uni))

        result = None
        for r in ranges:
            result = self._map.fold_intersecting(r.start, r.end, fold, result)
        return result if result is not None else (TXNID_NONE, TXNID_NONE)
