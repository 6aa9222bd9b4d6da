"""Durability rounds: shard-durable and globally-durable coordination, and
the rotating scheduler that drives them.

Reference: accord/coordinate/CoordinateShardDurable.java (fence a shard range
with an ExclusiveSyncPoint, wait for application at every replica, distribute
SetShardDurable), CoordinateGloballyDurable.java (min-merge QueryDurableBefore
over all nodes, distribute SetGloballyDurable), and
accord/impl/CoordinateDurabilityScheduling.java:55-95 (each node takes turns
coordinating sub-ranges on a wall-clock rotation).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Timeout
from accord_tpu_torch.coordinate.syncpoint import CoordinateSyncPoint, SyncPoint
from accord_tpu_torch.coordinate.tracking import QuorumTracker, RequestStatus
from accord_tpu_torch.messages.base import Callback, TxnRequest
from accord_tpu_torch.messages.durability import (QueryDurableBefore,
                                            QueryDurableBeforeOk,
                                            SetGloballyDurable,
                                            SetShardDurable)
from accord_tpu_torch.messages.wait import WaitUntilApplied
from accord_tpu_torch.primitives.keys import Ranges, Route, RoutingKey
from accord_tpu_torch.primitives.timestamp import TxnKind, TXNID_NONE
from accord_tpu_torch.utils.async_chains import AsyncResult


class CoordinateShardDurable(Callback):
    """ESP(ranges) -> WaitUntilApplied at every replica -> SetShardDurable.

    A quorum of applications licenses the majority bound; every replica
    answering licenses the universal bound (CoordinateShardDurable.java)."""

    def __init__(self, node, ranges: Ranges, result: AsyncResult):
        self.node = node
        self.ranges = ranges
        self.result = result
        self.sp: Optional[SyncPoint] = None
        self.tracker: Optional[QuorumTracker] = None
        self.contacted: List[int] = []
        self.acked: set = set()
        self.failed: set = set()
        self.majority_sent = False
        self.done = False

    @classmethod
    def coordinate(cls, node, ranges: Ranges) -> AsyncResult:
        result: AsyncResult = AsyncResult()
        csd = cls(node, ranges, result)
        CoordinateSyncPoint.coordinate(
            node, TxnKind.EXCLUSIVE_SYNC_POINT, ranges,
            await_applied=False).add_callback(csd._on_sync_point)
        return result

    def _on_sync_point(self, sp: Optional[SyncPoint], failure) -> None:
        if failure is not None:
            self.result.try_failure(failure)
            return
        self.sp = sp

        def make(to, scope):
            self.contacted.append(to)
            return WaitUntilApplied(sp.txn_id, scope)

        # trackers must come from the same Topologies the sends used
        topologies = self.node.topology.with_unsynced_epochs(
            sp.route.participants(), sp.txn_id.epoch, sp.execute_at.epoch)
        self.tracker = QuorumTracker(topologies)
        self.node.send_to_route(sp.route, sp.txn_id.epoch,
                                sp.execute_at.epoch, make, callback=self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        self.acked.add(from_id)
        status = self.tracker.record_success(from_id)
        if status == RequestStatus.SUCCESS and not self.majority_sent:
            self.majority_sent = True
            self._set_durable(universal=False)
        if len(self.acked) == len(self.contacted) and not self.failed:
            # EVERY contacted replica confirmed application — only then is
            # the universal bound (which licenses ERASE and poisons
            # stragglers) sound
            self.done = True
            self._set_durable(universal=True)
            self.result.try_success(self.sp)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        # a single unconfirmed replica forfeits the universal bound for this
        # round — it may not have applied the fenced txns, and erasing their
        # outcomes would strand it permanently
        self.failed.add(from_id)
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self.result.try_failure(failure if isinstance(failure, Timeout)
                                    else Exhausted(repr(failure)))
            return
        if self.majority_sent \
                and len(self.acked) + len(self.failed) == len(self.contacted):
            # settled: majority bound distributed, universal unavailable
            self.done = True
            self.result.try_success(self.sp)

    def _set_durable(self, universal: bool) -> None:
        sp = self.sp
        self.node.send_to_route(
            sp.route, sp.txn_id.epoch, sp.execute_at.epoch,
            lambda to, scope: SetShardDurable(sp.txn_id, scope, sp.ranges,
                                              universal))


class CoordinateGloballyDurable(Callback):
    """Min-merge every node's DurableBefore over `ranges`, then distribute
    (CoordinateGloballyDurable.java)."""

    def __init__(self, node, ranges: Ranges, result: AsyncResult):
        self.node = node
        self.ranges = ranges
        self.result = result
        self.tracker: Optional[QuorumTracker] = None
        self.merged: Optional[QueryDurableBeforeOk] = None
        self.route: Optional[Route] = None
        self.txn_id = None
        self.done = False

    @classmethod
    def coordinate(cls, node, ranges: Ranges) -> AsyncResult:
        result: AsyncResult = AsyncResult()
        cgd = cls(node, ranges, result)
        cgd.start()
        return result

    def start(self) -> None:
        from accord_tpu_torch.primitives.timestamp import Domain
        self.txn_id = self.node.next_txn_id(TxnKind.SYNC_POINT, Domain.RANGE)
        self.route = Route(RoutingKey(self.ranges[0].start),
                           ranges=self.ranges)
        topologies = self.node.topology.with_unsynced_epochs(
            self.ranges, self.node.epoch, self.node.epoch)
        self.tracker = QuorumTracker(topologies)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            self.node.send(to, QueryDurableBefore(self.txn_id, scope,
                                                  self.ranges),
                           callback=self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        assert isinstance(reply, QueryDurableBeforeOk)
        self.merged = reply if self.merged is None else QueryDurableBeforeOk(
            min(self.merged.majority, reply.majority),
            min(self.merged.universal, reply.universal))
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            self._distribute()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self.result.try_failure(failure if isinstance(failure, Timeout)
                                    else Exhausted(repr(failure)))

    def _distribute(self) -> None:
        # the bounds stay separate: min-merged majority harmonises the
        # majority view; only the min-merged UNIVERSAL bound (every replica
        # of every shard confirmed) licenses ERASE — promoting majority to
        # universal would erase outcomes lagging minority replicas still need
        maj, uni = self.merged.majority, self.merged.universal
        if maj == TXNID_NONE and uni == TXNID_NONE:
            self.result.try_success(None)
            return
        topologies = self.node.topology.with_unsynced_epochs(
            self.ranges, self.node.epoch, self.node.epoch)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            self.node.send(to, SetGloballyDurable(
                self.txn_id, scope, self.ranges, maj, uni))
        self.result.try_success(maj)


class CoordinateDurabilityScheduling:
    """Rotating durability rounds (CoordinateDurabilityScheduling.java:55-95):
    on each tick a node fences "its" shard slice with CoordinateShardDurable;
    periodically one node min-merges the global bounds. Node rotation comes
    from the node's index in the topology so coordinators rarely collide
    (collisions are harmless — sync points are just transactions)."""

    def __init__(self, node, shard_cycle_s: float = None,
                 global_cycle_every: int = None):
        self.node = node
        self.shard_cycle_s = (shard_cycle_s if shard_cycle_s is not None
                              else node.config.durability_shard_cycle_s)
        self.global_cycle_every = (
            global_cycle_every if global_cycle_every is not None
            else node.config.durability_global_cycle_every)
        self.counter = 0
        self._task = None

    def start(self) -> None:
        if self._task is None:
            self._task = self.node.scheduler.recurring(
                self.shard_cycle_s, self._run)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _run(self) -> None:
        topology = self.node.topology.current()
        nodes = sorted(topology.nodes())
        if self.node.id not in nodes:
            return
        my_index = nodes.index(self.node.id)
        shards = topology.shards
        if not shards:
            return
        self.counter += 1
        shard = shards[(my_index + self.counter) % len(shards)]
        if self.node.id in shard.nodes:
            CoordinateShardDurable.coordinate(
                self.node, Ranges([shard.range])).add_callback(
                lambda v, f: None)
        if self.counter % self.global_cycle_every == 0 \
                and self.counter // self.global_cycle_every % len(nodes) \
                == my_index:
            CoordinateGloballyDurable.coordinate(
                self.node, topology.ranges).add_callback(lambda v, f: None)
