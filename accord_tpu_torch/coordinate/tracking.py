"""Quorum trackers: per-shard vote accounting for coordination rounds.

Reference: accord/coordinate/tracking/ — AbstractTracker (per-shard
ShardTracker array folded over the Topologies epoch window), QuorumTracker,
FastPathTracker (electorate accept/reject counting, FastPathTracker.java:35-120),
ReadTracker (data+quorum split), RecoveryTracker (fast-path vote deciphering),
AppliedTracker, InvalidationTracker.

A response from node n counts toward every (epoch, shard) pair containing n —
coordinations spanning an epoch change must reach quorum in every epoch.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.utils import invariants


class RequestStatus(enum.Enum):
    NO_CHANGE = 0
    SUCCESS = 1
    FAILED = 2


class ShardTracker:
    __slots__ = ("shard", "successes", "failures")

    def __init__(self, shard: Shard):
        self.shard = shard
        self.successes: Set[int] = set()
        self.failures: Set[int] = set()

    def on_success(self, node: int) -> None:
        self.successes.add(node)

    def on_failure(self, node: int) -> None:
        self.failures.add(node)

    @property
    def has_reached_quorum(self) -> bool:
        return len(self.successes) >= self.shard.slow_path_quorum_size

    @property
    def has_failed(self) -> bool:
        """Quorum is unreachable: too many of this shard's replicas failed."""
        return len(self.failures) > self.shard.max_failures


class AbstractTracker:
    """Folds ShardTrackers over every epoch in the Topologies window."""

    tracker_factory: Callable[[Shard], ShardTracker] = ShardTracker

    def __init__(self, topologies: Topologies,
                 tracker_factory: Callable[[Shard], ShardTracker] = None):
        factory = tracker_factory or type(self).tracker_factory
        self.topologies = topologies
        self.trackers: List[ShardTracker] = []
        self._node_trackers: Dict[int, List[ShardTracker]] = {}
        for topology in topologies:
            for shard in topology.shards:
                t = factory(shard)
                self.trackers.append(t)
                for n in shard.nodes:
                    self._node_trackers.setdefault(n, []).append(t)

    def nodes(self) -> Iterable[int]:
        return self._node_trackers.keys()

    def trackers_for(self, node: int) -> List[ShardTracker]:
        return self._node_trackers.get(node, [])

    def _apply(self, node: int, fn: Callable[[ShardTracker, int], None]
               ) -> RequestStatus:
        for t in self.trackers_for(node):
            fn(t, node)
        return self._status()

    def _status(self) -> RequestStatus:
        if any(t.has_failed for t in self.trackers):
            return RequestStatus.FAILED
        if all(t.has_reached_quorum for t in self.trackers):
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    def record_success(self, node: int) -> RequestStatus:
        return self._apply(node, lambda t, n: t.on_success(n))

    def record_failure(self, node: int) -> RequestStatus:
        return self._apply(node, lambda t, n: t.on_failure(n))

    @property
    def has_failed(self) -> bool:
        return any(t.has_failed for t in self.trackers)

    @property
    def has_reached_quorum(self) -> bool:
        return all(t.has_reached_quorum for t in self.trackers)


class QuorumTracker(AbstractTracker):
    """Slow-path quorum in every shard of every epoch (QuorumTracker.java)."""


class FastPathShardTracker(ShardTracker):
    __slots__ = ("fast_path_accepts", "fast_path_rejects")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.fast_path_accepts: Set[int] = set()
        self.fast_path_rejects: Set[int] = set()

    def on_fast_path_accept(self, node: int) -> None:
        if self.shard.is_in_electorate(node):
            self.fast_path_accepts.add(node)

    def on_fast_path_reject(self, node: int) -> None:
        if self.shard.is_in_electorate(node):
            self.fast_path_rejects.add(node)

    @property
    def has_fast_path_accepted(self) -> bool:
        return len(self.fast_path_accepts) >= self.shard.fast_path_quorum_size

    @property
    def has_rejected_fast_path(self) -> bool:
        return self.shard.rejects_fast_path(len(self.fast_path_rejects))

    @property
    def has_decided_fast_path(self) -> bool:
        """Fast path accepted, or no longer achievable even if every
        outstanding electorate member votes accept (the PreAccept round must
        not complete before this is stable — FastPathTracker.java)."""
        if self.has_fast_path_accepted:
            return True
        outstanding = (len(self.shard.fast_path_electorate)
                       - len(self.fast_path_accepts)
                       - len(self.fast_path_rejects))
        return (len(self.fast_path_accepts) + outstanding
                < self.shard.fast_path_quorum_size)


class FastPathTracker(AbstractTracker):
    """PreAccept tracker: slow-path quorum overall + per-shard electorate
    accept counting for the fast path (FastPathTracker.java:35-120).

    A node's vote is a fast-path accept when it witnessed the txn at its
    original timestamp (no conflict forced a later executeAt).
    """

    tracker_factory = FastPathShardTracker

    def record_success(self, node: int, with_fast_path_accept: bool = False
                       ) -> RequestStatus:
        def fn(t: FastPathShardTracker, n: int):
            t.on_success(n)
            if with_fast_path_accept:
                t.on_fast_path_accept(n)
            else:
                t.on_fast_path_reject(n)
        return self._apply(node, fn)

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: FastPathShardTracker, n: int):
            t.on_failure(n)
            # a dead electorate member can never vote accept
            t.on_fast_path_reject(n)
        return self._apply(node, fn)

    def _status(self) -> RequestStatus:
        if any(t.has_failed for t in self.trackers):
            return RequestStatus.FAILED
        if all(t.has_reached_quorum and t.has_decided_fast_path
               for t in self.trackers):
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    @property
    def has_fast_path_accepted(self) -> bool:
        return all(t.has_fast_path_accepted for t in self.trackers)

    @property
    def has_rejected_fast_path(self) -> bool:
        return any(t.has_rejected_fast_path for t in self.trackers)


class ReadShardTracker(ShardTracker):
    __slots__ = ("data_success", "in_flight_reads")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.data_success = False
        self.in_flight_reads: Set[int] = set()

    @property
    def has_data(self) -> bool:
        return self.data_success


class ReadTracker(AbstractTracker):
    """Quorum-read machine: needs one data response per shard; retries slow or
    failed replicas against alternatives (ReadTracker.java).

    Usage: `initial_contacts` picks one replica per shard; on failure call
    `record_read_failure` which returns nodes to try next (TryAlternative).
    """

    tracker_factory = ReadShardTracker

    def __init__(self, topologies: Topologies):
        super().__init__(topologies)
        self.contacted: Set[int] = set()

    def initial_contacts(self, prefer: Optional[Sequence[int]] = None) -> List[int]:
        """One replica per shard, preferring `prefer` order (e.g. closest)."""
        chosen: List[int] = []
        order = list(prefer) if prefer else sorted(self._node_trackers.keys())
        for t in self.trackers:
            if any(n in t.shard.nodes for n in chosen):
                # reuse an already-chosen node covering this shard
                n = next(n for n in chosen if n in t.shard.nodes)
            else:
                n = next((c for c in order if c in t.shard.nodes),
                         t.shard.nodes[0])
                chosen.append(n)
            t.in_flight_reads.add(n)
            self.contacted.add(n)
        return sorted(set(chosen))

    def record_read_success(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            t.on_success(node)
            t.in_flight_reads.discard(node)
            if node in t.shard.nodes:
                t.data_success = True
        return self._read_status()

    def record_read_failure(self, node: int) -> Tuple[RequestStatus, List[int]]:
        """Returns (status, alternative nodes to contact)."""
        retry: List[int] = []
        for t in self.trackers_for(node):
            t.on_failure(node)
            t.in_flight_reads.discard(node)
            if not t.data_success and not t.in_flight_reads:
                alt = next((n for n in t.shard.nodes
                            if n not in t.failures and n not in t.in_flight_reads),
                           None)
                if alt is not None:
                    t.in_flight_reads.add(alt)
                    self.contacted.add(alt)
                    retry.append(alt)
        return self._read_status(), sorted(set(retry))

    def _read_status(self) -> RequestStatus:
        if all(t.has_data for t in self.trackers):
            return RequestStatus.SUCCESS
        if any(not t.has_data and not t.in_flight_reads
               and all(n in t.failures for n in t.shard.nodes)
               for t in self.trackers):
            return RequestStatus.FAILED
        return RequestStatus.NO_CHANGE


class RecoveryShardTracker(FastPathShardTracker):
    """Adds recovery fast-path vote deciphering: among electorate members that
    responded, did enough *not* witness the txn that the fast path cannot have
    succeeded? (RecoveryTracker.java)"""
    __slots__ = ()


class RecoveryTracker(AbstractTracker):
    tracker_factory = RecoveryShardTracker

    def record_success(self, node: int, rejects_fast_path: bool = False
                       ) -> RequestStatus:
        def fn(t: RecoveryShardTracker, n: int):
            t.on_success(n)
            if rejects_fast_path:
                t.on_fast_path_reject(n)
        return self._apply(node, fn)

    def rejects_fast_path(self) -> bool:
        """Fast path provably did not happen: in some shard, enough electorate
        members voted reject that a fast-path quorum cannot exist among the
        remainder (Recover.java vote math)."""
        return any(t.has_rejected_fast_path for t in self.trackers)


class AppliedTracker(QuorumTracker):
    """Waits for apply acks (durability rounds; AppliedTracker.java)."""


class InvalidationShardTracker(ShardTracker):
    """Per-shard invalidation vote state (InvalidationTracker.java:30-133).

    A promise counts toward this shard's slow-path quorum. An electorate
    member that replies *without* having witnessed the txn at its original
    timestamp is a fast-path reject — its promise also bars it from casting a
    late fast-path accept, so the rejection is decisive. A failed replica
    consumes electorate budget without rejecting (it may have voted accept
    before dying)."""

    __slots__ = ("promises", "rejects", "fast_path_rejects",
                 "fast_path_responded", "has_decision")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.promises: Set[int] = set()
        self.rejects: Set[int] = set()            # replied without promising
        self.fast_path_rejects: Set[int] = set()
        self.fast_path_responded: Set[int] = set()  # electorate heard from
        self.has_decision = False

    def on_reply(self, node: int, promised: bool, has_decision: bool,
                 accepted_fast_path: bool) -> None:
        if node in self.shard.fast_path_electorate:
            self.fast_path_responded.add(node)
            if not accepted_fast_path:
                self.fast_path_rejects.add(node)
        if promised:
            self.promises.add(node)
        else:
            self.rejects.add(node)
        if has_decision:
            self.has_decision = True

    def on_node_failure(self, node: int) -> None:
        # can no longer vote either way; not a rejection
        if node in self.shard.fast_path_electorate:
            self.fast_path_responded.add(node)
        self.failures.add(node)

    @property
    def is_promised(self) -> bool:
        return len(self.promises) >= self.shard.slow_path_quorum_size

    @property
    def is_promise_rejected(self) -> bool:
        """A promise quorum is no longer achievable in this shard."""
        outstanding = (self.shard.rf - len(self.promises) - len(self.rejects)
                       - len(self.failures))
        return (len(self.promises) + outstanding
                < self.shard.slow_path_quorum_size)

    @property
    def is_fast_path_rejected(self) -> bool:
        return self.shard.rejects_fast_path(len(self.fast_path_rejects))

    @property
    def can_fast_path_be_rejected(self) -> bool:
        inflight = (len(self.shard.fast_path_electorate)
                    - len(self.fast_path_responded))
        return self.shard.rejects_fast_path(
            len(self.fast_path_rejects) + inflight)

    @property
    def is_fast_path_decided(self) -> bool:
        return self.is_fast_path_rejected or not self.can_fast_path_be_rejected

    @property
    def is_final(self) -> bool:
        """No further reply can change this shard's contribution."""
        return self.has_decision or (
            self.is_fast_path_decided
            and (self.is_promised or self.is_promise_rejected))

    @property
    def is_promised_or_has_decision(self) -> bool:
        return self.is_promised or self.has_decision


class InvalidationTracker(AbstractTracker):
    """Vote accounting for the multi-shard BeginInvalidation round
    (InvalidationTracker.java).

    SUCCESS when EITHER some shard reached a promise quorum AND some shard
    proved the fast path impossible (safe to invalidate outright), OR every
    shard is final and each holds a promise quorum or a witnessed decision
    (recovery — or our invalidation — is guaranteed to resolve). FAILED when
    every shard is final and some shard neither promised nor saw a decision."""

    tracker_factory = InvalidationShardTracker

    def record_success(self, node: int, promised: bool, has_decision: bool,
                       accepted_fast_path: bool) -> RequestStatus:
        for t in self.trackers_for(node):
            t.on_reply(node, promised, has_decision, accepted_fast_path)
        return self._status()

    def record_failure(self, node: int) -> RequestStatus:
        for t in self.trackers_for(node):
            t.on_node_failure(node)
        return self._status()

    def _status(self) -> RequestStatus:
        if self.is_promised and self.is_safe_to_invalidate:
            return RequestStatus.SUCCESS
        if all(t.is_final for t in self.trackers):
            if all(t.is_promised_or_has_decision for t in self.trackers):
                return RequestStatus.SUCCESS
            return RequestStatus.FAILED
        return RequestStatus.NO_CHANGE

    @property
    def is_promised(self) -> bool:
        return any(t.is_promised for t in self.trackers)

    def promised_shard(self) -> Shard:
        return next(t.shard for t in self.trackers if t.is_promised)

    @property
    def is_safe_to_invalidate(self) -> bool:
        """Some shard decisively rejected the fast path: the txn cannot have
        been fast-path committed anywhere."""
        return any(t.is_fast_path_rejected for t in self.trackers)
