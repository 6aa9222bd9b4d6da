"""Sync points and barriers: deps-only pseudo-transactions over ranges.

Reference: accord/coordinate/CoordinateSyncPoint.java (inclusive SyncPoint /
ExclusiveSyncPoint coordination; ESP skips the fast path,
CoordinationAdapter.java:244-261), ExecuteSyncPoint.java (await quorum
application), Barrier.java:64-168 (BarrierType local / global_sync /
global_async). A sync point carries no reads or writes: it commits through
the standard pipeline and "executes" by its dependencies draining — after it
applies, every conflicting txn with a lower id on its ranges is stable on
that replica (the fencing primitive bootstrap and durability are built on).
"""

from __future__ import annotations

import enum
from typing import List, Optional

from accord_tpu_torch.coordinate.execute import ExecutePath
from accord_tpu_torch.coordinate.transaction import CoordinateTransaction
from accord_tpu_torch.messages.apply_msg import ApplyKind
from accord_tpu_torch.messages.commit import CommitKind
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Ranges, Route
from accord_tpu_torch.primitives.timestamp import Domain, Timestamp, TxnId, TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult


class SyncPoint:
    """The coordination outcome: enough to wait on it or fence with it
    (reference primitives/SyncPoint.java)."""

    __slots__ = ("txn_id", "route", "ranges", "execute_at")

    def __init__(self, txn_id: TxnId, route: Route, ranges: Ranges,
                 execute_at: Timestamp):
        self.txn_id = txn_id
        self.route = route
        self.ranges = ranges
        self.execute_at = execute_at

    def __repr__(self):
        return f"SyncPoint({self.txn_id!r} over {self.ranges!r})"


class CoordinateSyncPoint(CoordinateTransaction):
    """Coordinate a SyncPoint/ExclusiveSyncPoint over `ranges`.

    The client result resolves to a `SyncPoint` once the outcome is durable
    enough for the requested mode:
      await_applied=False — when the Apply round is dispatched (global_async);
      await_applied=True  — when a quorum per shard acks application
                            (global_sync / durability rounds).
    """

    def __init__(self, node, txn_id: TxnId, txn: Txn, result: AsyncResult,
                 await_applied: bool = False):
        invariants.check_argument(txn.kind.is_sync_point,
                                  "not a sync point kind")
        self._sp_result = result
        self._await_applied = await_applied
        self._inner: AsyncResult = AsyncResult()
        super().__init__(node, txn_id, txn, self._inner)

    permit_fast_path = False  # both kinds propose via Accept (ESP must;
    # inclusive follows for a single shared pipeline — one extra round on an
    # uncontended coordination-only txn)

    @classmethod
    def coordinate(cls, node, kind: TxnKind, ranges: Ranges,
                   await_applied: bool = False) -> AsyncResult:
        txn_id = node.next_txn_id(kind, Domain.RANGE)
        txn = Txn(kind, ranges)
        result: AsyncResult = AsyncResult()
        sp = cls(node, txn_id, txn, result, await_applied=await_applied)
        node.coordinating[txn_id] = result
        result.add_callback(lambda v, f: node.coordinating.pop(txn_id, None))
        node.with_epoch(txn_id.epoch, sp.start)
        return result

    def _execute(self, kind: CommitKind, execute_at: Timestamp, deps: Deps
                 ) -> None:
        sp = SyncPoint(self.txn_id, self.route, self.txn.keys, execute_at)
        applied: Optional[AsyncResult] = None
        if self._await_applied:
            applied = AsyncResult()
            applied.add_callback(
                lambda v, f: self._sp_result.try_failure(f) if f is not None
                else self._sp_result.try_success(sp))
            # a stable/read-round failure surfaces on the inner result and
            # must still fail the caller (the applied result would never fire)
            self._inner.add_callback(
                lambda v, f: self._sp_result.try_failure(f)
                if f is not None else None)
        else:
            self._inner.add_callback(
                lambda v, f: self._sp_result.try_failure(f) if f is not None
                else self._sp_result.try_success(sp))
        # Maximal apply: replicas that missed PreAccept can still apply the
        # (definition-light) sync point without a fetch round
        ExecutePath(self.node, self.txn_id, self.txn, self.route, execute_at,
                    deps, kind, ApplyKind.MAXIMAL, self._inner,
                    applied_result=applied).start()

    def _fail(self, failure: BaseException) -> None:
        super()._fail(failure)
        self._sp_result.try_failure(failure)


class BarrierType(enum.Enum):
    """Barrier.BarrierType (Barrier.java:64)."""
    LOCAL = "LOCAL"
    GLOBAL_ASYNC = "GLOBAL_ASYNC"
    GLOBAL_SYNC = "GLOBAL_SYNC"


def barrier(node, seekables, barrier_type: BarrierType) -> AsyncResult:
    """Wait until (at least) everything started before now on `seekables` has
    stably executed — locally, or at a quorum per shard (Barrier.java:64-168).
    Resolves to the fencing SyncPoint."""
    ranges = (seekables if isinstance(seekables, Ranges)
              else seekables.to_ranges())
    if barrier_type == BarrierType.GLOBAL_SYNC:
        # Apply acks only certify the outcome was recorded; a sync barrier
        # needs actual execution (deps drained).  await_applied=True makes
        # the persist round send the FUSED ApplyThenWaitUntilApplied, whose
        # ack arrives only once the sync point APPLIES at the replica — the
        # reference ExecuteSyncPoint semantics in one round instead of
        # Apply + a separate WaitUntilApplied quorum.
        return CoordinateSyncPoint.coordinate(
            node, TxnKind.SYNC_POINT, ranges, await_applied=True)
    if barrier_type == BarrierType.GLOBAL_ASYNC:
        return CoordinateSyncPoint.coordinate(
            node, TxnKind.SYNC_POINT, ranges, await_applied=False)

    # LOCAL: committed globally, applied locally
    result: AsyncResult = AsyncResult()
    sp_result = CoordinateSyncPoint.coordinate(
        node, TxnKind.SYNC_POINT, ranges, await_applied=False)

    def on_coordinated(sp: SyncPoint, failure):
        if failure is not None:
            result.try_failure(failure)
            return
        _await_local_apply(node, sp, result)

    sp_result.add_callback(on_coordinated)
    return result


def _await_local_apply(node, sp: SyncPoint, result: AsyncResult) -> None:
    """Fire `result` with `sp` once every local store covering its ranges has
    applied it (Barrier's local listener)."""
    from accord_tpu_torch.local.command import OnAppliedListener
    from accord_tpu_torch.local.store import PreLoadContext

    stores = node.command_stores.intersecting(sp.ranges)
    if not stores:
        result.try_success(sp)
        return
    remaining = {s.id for s in stores}

    def arm(safe_store):
        store_id = safe_store.store.id

        def fired(_command):
            remaining.discard(store_id)
            if not remaining:
                result.try_success(sp)

        OnAppliedListener.arm(safe_store.get(sp.txn_id), fired)

    for store in stores:
        store.execute(PreLoadContext.for_txn(sp.txn_id), arm)
