"""CoordinateTransaction: the client-side transaction pipeline.

Reference: accord/coordinate/CoordinateTransaction.java:60 (fast path :71-77,
slow path :79-101), AbstractCoordinatePreAccept.java:121 (contact round),
CoordinationAdapter.java:48-193 (propose/stabilise/execute/persist steps).
The Accept round and the Stable+Read/Apply tail are shared with recovery
(coordinate/execute.py: Propose / ExecutePath).

Round structure (matching the reference's message economy):
  fast path:  PreAccept (fast-path electorate quorum)  -> Stable+Read -> Apply*
  slow path:  PreAccept -> Accept (slow quorum)        -> Stable+Read -> Apply*
(*Apply is asynchronous; the client unblocks when the result is computed.)
"""

from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Invalidated, Preempted, Timeout
from accord_tpu_torch.coordinate.execute import ExecutePath, Propose
from accord_tpu_torch.coordinate.tracking import (FastPathTracker, QuorumTracker,
                                            RequestStatus)
from accord_tpu_torch.messages.apply_msg import ApplyKind
from accord_tpu_torch.messages.base import Callback, TxnRequest
from accord_tpu_torch.messages.commit import CommitKind
from accord_tpu_torch.messages.preaccept import PreAccept, PreAcceptNack, PreAcceptOk
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult


class CoordinateTransaction(Callback):
    # exclusive sync points suppress the fast path even on a unanimous
    # electorate (CoordinationAdapter.java:244-261); see CoordinateSyncPoint
    permit_fast_path = True

    def __init__(self, node, txn_id: TxnId, txn: Txn, result: AsyncResult):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.result = result
        self.route: Optional[Route] = None
        self.topologies = None
        self.tracker: Optional[FastPathTracker] = None
        self.oks: Dict[int, PreAcceptOk] = {}
        # replies from epoch-extension rounds, a LIST not a node-keyed dict:
        # a node owning shards in both the original and extended epochs
        # replies in both rounds (the second via preaccept's REDUNDANT arm —
        # same stored executeAt, but deps freshly calculated over its
        # newly-owned ranges), and both replies' deps must survive the merge
        self.extra_oks: list = []
        self.done = False

    # ------------------------------------------------------------ preaccept --
    def start(self) -> None:
        self.route = self.node.compute_route(self.txn)
        self.node.obs.txn_phase(self.txn_id, "preaccept")
        self.topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch, self.txn_id.epoch)
        self.tracker = FastPathTracker(self.topologies)
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, self.route)
            if scope is None:
                continue
            owned = scope.covering()
            partial = self.txn.slice(owned, include_query=(to == self.node.id))
            self.node.send(
                to, PreAccept(self.txn_id, partial, scope,
                              self.topologies.current_epoch,
                              full_route=self.route),
                callback=self,
                timeout_s=self.node.agent.pre_accept_timeout())

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, PreAcceptNack):
            # a competing ballot holds a promise: another coordinator/recovery
            self._fail(Preempted(f"PreAccept nacked by {from_id}"))
            return
        invariants.check_state(isinstance(reply, PreAcceptOk),
                               "unexpected reply %s", reply)
        self.oks[from_id] = reply
        status = self.tracker.record_success(
            from_id, with_fast_path_accept=reply.is_fast_path_vote)
        if status == RequestStatus.SUCCESS:
            self._on_preaccepted()
        elif status == RequestStatus.FAILED:
            self._fail(Exhausted("preaccept quorum unreachable"))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        status = self.tracker.record_failure(from_id)
        if status == RequestStatus.FAILED:
            self._fail(failure if isinstance(failure, Timeout)
                       else Exhausted(repr(failure)))
        elif status == RequestStatus.SUCCESS:
            # the lost vote decided fast-path impossibility; round complete
            self._on_preaccepted()

    def _on_preaccepted(self) -> None:
        """Quorum of PreAcceptOks (CoordinateTransaction.onPreAccepted)."""
        self.done = True
        self._decide(list(self.oks.values()))

    def _decide(self, oks) -> None:
        if self.permit_fast_path and self.tracker.has_fast_path_accepted:
            # fast path: execute at the original timestamp (fast-path votes
            # are witnessed_at == txnId, so no epoch extension can apply)
            self.node.events.on_fast_path_taken(self.txn_id)
            self.node.obs.txn_path(self.txn_id, "fast")
            self._execute(CommitKind.STABLE_FAST_PATH,
                          self.txn_id.as_timestamp(),
                          Deps.merge([ok.deps for ok in oks]))
        else:
            max_witnessed = max(ok.witnessed_at for ok in oks)
            if max_witnessed.is_rejected:
                self._fail(Invalidated("preaccept rejected"))
                return
            if max_witnessed.epoch > self.topologies.current_epoch:
                # the epoch we will accept in is LATER than the epochs that
                # informed this proposal: it may have moved ahead — a new
                # owner can hold committed conflicts above our timestamp, so
                # deciding now could order us beneath writes it already
                # applied. PreAccept at the later epochs first (non-voting
                # for the fast path; they witness us and inform the
                # timestamp) — AbstractCoordinatePreAccept.onNewEpoch
                # :200-236.
                self._extend_epochs(max_witnessed.epoch)
                return
            self.node.events.on_slow_path_taken(self.txn_id)
            self.node.obs.txn_path(self.txn_id, "slow")
            merged_deps = Deps.merge([ok.deps for ok in oks])
            Propose(self.node, self.txn_id, self.txn, self.route, Ballot.ZERO,
                    max_witnessed, merged_deps,
                    lambda stable_deps: self._stabilise_then_execute(
                        max_witnessed, stable_deps),
                    self._fail).start()

    def _extend_epochs(self, latest: int) -> None:
        prev = self.topologies

        def ready():
            new_tops = self.node.topology.with_unsynced_epochs(
                self.route.participants(), self.txn_id.epoch, latest)
            extra = new_tops.for_epochs(prev.current_epoch + 1, latest)
            self.topologies = new_tops
            # equivalent-shards shortcut (reference :224-230): if ownership
            # did not move, the original quorum already covers every future
            # owner — no extra round needed
            if all(t.shards == prev.current().shards for t in extra):
                self._decide(list(self.oks.values()) + self.extra_oks)
                return
            _ExtraEpochRound(self, extra).start()

        self.node.with_epoch(latest, ready)

    def _stabilise_then_execute(self, execute_at: Timestamp, deps: Deps
                                ) -> None:
        """Slow-path tail: commit round (skipped under the instability
        fault), then Stable+Read (CoordinationAdapter stabilise/execute)."""
        from accord_tpu_torch.coordinate.execute import Stabilise
        Stabilise.then(self.node, self.txn_id, self.txn, self.route,
                       execute_at, deps,
                       lambda: self._execute(CommitKind.STABLE_SLOW_PATH,
                                             execute_at, deps),
                       self._fail)

    # ----------------------------------------------------- execute (stable) --
    def _execute(self, kind: CommitKind, execute_at: Timestamp, deps: Deps
                 ) -> None:
        ExecutePath(self.node, self.txn_id, self.txn, self.route, execute_at,
                    deps, kind, ApplyKind.MINIMAL, self.result).start()

    def _fail(self, failure: BaseException) -> None:
        self.done = True
        if isinstance(failure, Timeout):
            self.node.events.on_timeout(self.txn_id)
        self.result.try_failure(failure)


class _ExtraEpochRound(Callback):
    """Non-voting PreAccept round against the epochs between the original
    coordination topologies and the proposed executeAt's epoch (reference
    AbstractCoordinatePreAccept.ExtraEpochs): the later epochs' owners
    witness the txn and their proposals inform the final timestamp, so a
    moved-ahead epoch cannot leave the decision beneath conflicts its new
    owners already committed. Votes here never count toward the fast path
    (the replicas' epoch exceeds txnId's, so they propose fresh HLC
    stamps)."""

    def __init__(self, parent: CoordinateTransaction, topologies):
        self.parent = parent
        self.topologies = topologies
        self.tracker = QuorumTracker(topologies)
        self.done = False

    def start(self) -> None:
        p = self.parent
        p.node.obs.txn_phase(p.txn_id, "preaccept_extend")
        for to in self.topologies.nodes():
            scope = TxnRequest.compute_scope(to, self.topologies, p.route)
            if scope is None:
                continue
            partial = p.txn.slice(scope.covering(), include_query=False)
            p.node.send(
                to, PreAccept(p.txn_id, partial, scope,
                              self.topologies.current_epoch,
                              full_route=p.route),
                callback=self,
                timeout_s=p.node.agent.pre_accept_timeout())

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, PreAcceptNack):
            self.done = True
            self.parent._fail(
                Preempted(f"extension PreAccept nacked by {from_id}"))
            return
        invariants.check_state(isinstance(reply, PreAcceptOk),
                               "unexpected reply %s", reply)
        self.parent.extra_oks.append(reply)
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            # recurses through _decide if the extended proposal crosses yet
            # another epoch
            self.parent._decide(list(self.parent.oks.values())
                                + self.parent.extra_oks)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self.parent._fail(failure if isinstance(failure, Timeout)
                              else Exhausted(repr(failure)))
