"""Propose / ExecutePath: the shared coordination tail.

Reference: accord/coordinate/Propose.java (Accept round at a ballot),
ExecuteTxn.java:53-140 (Stable+Read via Commit.stableAndRead), PersistTxn /
CoordinationAdapter.persist (:188-206). Used by both CoordinateTransaction
(ballot 0, Apply.Minimal) and Recover (ballot > 0, Apply.Maximal — the
Step.InitiateRecovery adapter, CoordinationAdapter.java:196-206).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Invalidated, Preempted, Timeout
from accord_tpu_torch.coordinate.tracking import (AppliedTracker, QuorumTracker,
                                            RequestStatus)
from accord_tpu_torch.messages.accept import Accept, AcceptNack, AcceptOk
from accord_tpu_torch.messages.apply_msg import (Apply, ApplyKind, ApplyReply,
                                           ApplyThenWaitUntilApplied)
from accord_tpu_torch.messages.base import Callback, RoundCallback, TxnRequest
from accord_tpu_torch.messages.commit import Commit, CommitKind
from accord_tpu_torch.messages.read import ReadNack, ReadOk, ReadTxnData
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_chains import AsyncResult


class Propose(Callback):
    """Accept round at `ballot`; on quorum, hands the union of the freshly
    calculated per-replica deps to `on_accepted` (Propose.java; the deps for
    the commit round are the accept-round recalculations, Accept.java:84-130).
    """

    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 ballot: Ballot, execute_at: Timestamp, deps: Deps,
                 on_accepted, on_failed):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.ballot = ballot
        self.execute_at = execute_at
        self.deps = deps
        self._on_accepted = on_accepted
        self._on_failed = on_failed
        self.oks: Dict[int, AcceptOk] = {}
        self.tracker: Optional[QuorumTracker] = None
        self.done = False

    def start(self) -> None:
        def ready():
            self.node.obs.txn_phase(self.txn_id, "accept",
                                    ballot=repr(self.ballot))
            topologies = self.node.topology.with_unsynced_epochs(
                self.route.participants(), self.txn_id.epoch,
                self.execute_at.epoch)
            self.tracker = QuorumTracker(topologies)
            for to in topologies.nodes():
                scope = TxnRequest.compute_scope(to, topologies, self.route)
                if scope is None:
                    continue
                keys = self.txn.keys.slice(scope.covering())
                self.node.send(
                    to, Accept(self.txn_id, self.ballot, scope, keys,
                               self.execute_at, self.deps,
                               max_epoch=self.execute_at.epoch,
                               full_route=self.route),
                    callback=self)

        self.node.with_epoch(self.execute_at.epoch, ready)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, AcceptNack):
            self.done = True
            self._on_failed(Preempted(f"Accept nacked: {reply.reason.name}"))
            return
        self.oks[from_id] = reply
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            from accord_tpu_torch.utils.faults import FAULTS
            if FAULTS.unmerged_deps(self.txn_id.kind):
                # fault injection: drop the accept-round recalculations —
                # the pre-accept deps alone must still be safe
                self._on_accepted(self.deps)
            else:
                self._on_accepted(self.deps.with_(
                    Deps.merge([ok.deps for ok in self.oks.values()])))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self._on_failed(failure if isinstance(failure, Timeout)
                            else Exhausted(repr(failure)))


class Stabilise(Callback):
    """Pre-execution commit round (Stabilise.java:61 commitMinimal): sends
    Commit(COMMIT_SLOW_PATH) so (executeAt, deps) become Committed at a
    quorum BEFORE the Stable+Read round — recovery then finds a committed
    status and short-circuits instead of re-deciphering votes.  A
    strengthening, not a safety requirement: Faults.*_INSTABILITY skips it
    (CoordinationAdapter.java:172) and the burn must stay correct."""

    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 execute_at: Timestamp, deps: Deps, on_stabilised, on_failed):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.execute_at = execute_at
        self.deps = deps
        self._on_stabilised = on_stabilised
        self._on_failed = on_failed
        self.tracker: Optional[QuorumTracker] = None
        self.done = False

    @classmethod
    def then(cls, node, txn_id: TxnId, txn: Txn, route: Route,
             execute_at: Timestamp, deps: Deps, proceed, on_failed) -> None:
        """Run the stabilise round then `proceed()` — or skip straight to
        `proceed()` under the matching instability fault."""
        from accord_tpu_torch.utils.faults import FAULTS
        if FAULTS.instability(txn_id.kind):
            proceed()
            return
        cls(node, txn_id, txn, route, execute_at, deps, proceed,
            on_failed).start()

    def start(self) -> None:
        def ready():
            self.node.obs.txn_phase(self.txn_id, "commit")
            topologies = self.node.topology.with_unsynced_epochs(
                self.route.participants(), self.txn_id.epoch,
                self.execute_at.epoch)
            self.tracker = QuorumTracker(topologies)
            for to in topologies.nodes():
                scope = TxnRequest.compute_scope(to, topologies, self.route)
                if scope is None:
                    continue
                partial = self.txn.slice(scope.covering(),
                                         include_query=False)
                self.node.send(
                    to, Commit(CommitKind.COMMIT_SLOW_PATH, self.txn_id,
                               scope, partial, self.execute_at, self.deps,
                               full_route=self.route),
                    callback=self)

        self.node.with_epoch(self.execute_at.epoch, ready)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        from accord_tpu_torch.messages.base import SimpleReply
        if isinstance(reply, SimpleReply) and reply.outcome == SimpleReply.NACK:
            self.done = True
            self._on_failed(Preempted(
                f"{self.txn_id} commit nacked by {from_id}"))
            return
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            self._on_stabilised()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self._on_failed(failure if isinstance(failure, Timeout)
                            else Exhausted(repr(failure)))


class ExecutePath(Callback):
    """Stable(+Read piggyback) round, then compute the outcome, unblock the
    client, and send Apply (ExecuteTxn.java + PersistTxn)."""

    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 execute_at: Timestamp, deps: Deps, commit_kind: CommitKind,
                 apply_kind: ApplyKind, result: AsyncResult,
                 applied_result: Optional[AsyncResult] = None):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.execute_at = execute_at
        self.deps = deps
        self.commit_kind = commit_kind
        self.apply_kind = apply_kind
        self.result = result
        # non-None: additionally track Apply acks to a quorum per shard and
        # fire this result (ExecuteSyncPoint semantics / AppliedTracker)
        self.applied_result = applied_result
        self.applied_tracker: Optional[QuorumTracker] = None
        self.stable_tracker: Optional[QuorumTracker] = None
        self.reads = None  # ReadCoordinator when the txn has a read set
        self.read_nodes: List[int] = []
        self.read_data = None
        self.executed = False
        self.failed = False
        self.durable_sent = False

    def start(self) -> None:
        self.node.with_epoch(self.execute_at.epoch, self._start)

    def _start(self) -> None:
        from accord_tpu_torch.coordinate.read_coord import ReadCoordinator
        from accord_tpu_torch.topology.topologies import Topologies
        self.node.obs.txn_phase(self.txn_id, "stable")
        execute_epoch = self.execute_at.epoch
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch, execute_epoch)
        execute_topology = topologies.for_epoch(execute_epoch)
        self.stable_tracker = QuorumTracker(topologies)
        read_keys = (self.txn.read.keys() if self.txn.read is not None
                     else Keys(()))
        self.reads = (ReadCoordinator(
            self.node, Topologies([execute_topology]), self._send_retry_read,
            lambda: self._fail(Exhausted("read candidates exhausted")))
            if read_keys else None)
        self.read_nodes = (self.reads.initial_contacts()
                           if self.reads else [])
        maximal = self.commit_kind == CommitKind.STABLE_MAXIMAL
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            owned = scope.covering()
            partial = self.txn.slice(owned, include_query=maximal)
            to_read = (read_keys.slice(owned)
                       if to in self.read_nodes else None)
            self.node.send(
                to, Commit(self.commit_kind, self.txn_id, scope, partial,
                           self.execute_at, self.deps, read_keys=to_read,
                           full_route=self.route),
                callback=self)

    # -- apply acks arrive on their own round (RoundCallback "apply"), so a
    # late stable/read timeout can never be mis-credited to the apply quorum --
    def on_round_success(self, round_id, from_id: int, reply) -> None:
        if isinstance(reply, ApplyReply):
            self._on_apply_reply(from_id, reply)

    def on_round_failure(self, round_id, from_id: int,
                         failure: BaseException) -> None:
        if self.applied_tracker is None or self.durable_sent:
            return
        if self.applied_tracker.record_failure(from_id) == RequestStatus.FAILED \
                and self.applied_result is not None \
                and not self.applied_result.is_done:
            self.applied_result.try_failure(
                failure if isinstance(failure, Timeout)
                else Exhausted(repr(failure)))

    # -- stable/read replies --
    def on_success(self, from_id: int, reply) -> None:
        if self.failed or self.executed:
            return
        if isinstance(reply, ReadNack):
            if reply.reason == ReadNack.INVALID:
                self._fail(Invalidated("invalidated during execution"))
            elif reply.reason == ReadNack.REDUNDANT:
                # the txn already has a decided outcome elsewhere (a competing
                # coordinator/recovery persisted it): our read snapshot is
                # gone and the txn needs no further driving. Settle without a
                # locally computed result.
                self._obsolete()
            else:
                self._retry_read(from_id)
            return
        if isinstance(reply, ReadOk):
            if reply.data is not None:
                self.read_data = (reply.data if self.read_data is None
                                  else self.read_data.merge(reply.data))
            if self.reads is not None:
                self.reads.on_data(from_id)
        self.stable_tracker.record_success(from_id)
        self._maybe_finish()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.failed or self.executed:
            return
        if self.stable_tracker.record_failure(from_id) == RequestStatus.FAILED:
            self._fail(failure if isinstance(failure, Timeout)
                       else Exhausted(repr(failure)))
            return
        if self.reads is not None and from_id in self.reads.contacted:
            self._retry_read(from_id)

    def _retry_read(self, from_id: int) -> None:
        if self.reads is not None:
            self.reads.on_slow_or_failed(from_id)

    def _send_retry_read(self, to: int) -> None:
        read_keys = self.txn.read.keys()
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch,
            self.execute_at.epoch)
        scope = TxnRequest.compute_scope(to, topologies, self.route)
        if scope is None:
            # tracker and scope derive from the same snapshot so this should
            # be unreachable; treat as a failed read so the shard tries the
            # next alternative instead of waiting forever
            self.reads.on_slow_or_failed(to)
            return
        owned = scope.covering()
        self.node.send(
            to, ReadTxnData(self.txn_id, scope, read_keys.slice(owned),
                            self.execute_at.epoch),
            callback=self)

    def _maybe_finish(self) -> None:
        reads_done = self.reads is None or self.reads.has_all_data
        if reads_done and self.stable_tracker.has_reached_quorum \
                and not self.executed:
            self.executed = True
            self._persist()

    def _persist(self) -> None:
        self.node.obs.txn_phase(self.txn_id, "apply")
        writes = self.txn.execute(self.txn_id, self.execute_at, self.read_data)
        result = (self.txn.result(self.txn_id, self.execute_at, self.read_data)
                  if self.txn.query is not None else None)
        maximal = self.apply_kind == ApplyKind.MAXIMAL
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch, self.execute_at.epoch)
        # apply acks are always tracked: a quorum per shard makes the txn
        # majority-durable, which is gossiped via InformDurable so progress
        # logs stand down (the reference Persist round, Persist.java)
        self.applied_tracker = AppliedTracker(topologies)
        apply_cb = RoundCallback(self, "apply")
        # Sync points awaiting application use the fused verb: the replica
        # acks only once the sync point has APPLIED locally (its deps
        # drained), giving the applied_result the reference's
        # ExecuteSyncPoint semantics in ONE round instead of Apply +
        # WaitUntilApplied (ApplyThenWaitUntilApplied.java:37).  A plain
        # Apply ack only confirms the outcome was INSTALLED.
        fused = self.txn.kind.is_sync_point and self.applied_result is not None
        msg_cls = ApplyThenWaitUntilApplied if fused else Apply
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            partial = (self.txn.slice(scope.covering(), include_query=False)
                       if maximal else None)
            self.node.send(
                to, msg_cls(self.apply_kind, self.txn_id, scope,
                            self.execute_at, self.deps, writes, result,
                            partial_txn=partial, full_route=self.route),
                callback=apply_cb)
        self.result.try_success(result)

    # -- apply acks --
    def _on_apply_reply(self, from_id: int, reply: ApplyReply) -> None:
        if self.applied_tracker is None or self.durable_sent:
            return
        if reply.outcome == ApplyReply.INSUFFICIENT:
            if self.applied_tracker.record_failure(from_id) == RequestStatus.FAILED \
                    and self.applied_result is not None \
                    and not self.applied_result.is_done:
                self.applied_result.try_failure(
                    Exhausted("apply quorum unreachable"))
            return
        if self.applied_tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.durable_sent = True
            self._inform_durable()
            if self.applied_result is not None:
                self.applied_result.try_success(None)

    def _inform_durable(self) -> None:
        from accord_tpu_torch.local.status import Durability
        from accord_tpu_torch.messages.durability import InformDurable
        self.node.send_to_route(
            self.route, self.txn_id.epoch, self.execute_at.epoch,
            lambda to, scope: InformDurable(self.txn_id, scope,
                                            Durability.MAJORITY))

    def _obsolete(self) -> None:
        """A competing coordinator persisted the outcome first; our read
        snapshot is gone so we cannot compute the result. Report
        unknown-outcome rather than claiming success without data (proper fix
        is a CheckStatus fetch of the persisted outcome — future work)."""
        self.executed = True
        self.result.try_failure(Preempted(
            f"{self.txn_id} outcome persisted by a competing coordinator; "
            f"result not locally computable"))

    def _fail(self, failure: BaseException) -> None:
        self.failed = True
        if isinstance(failure, Timeout):
            self.node.events.on_timeout(self.txn_id)
        self.result.try_failure(failure)
