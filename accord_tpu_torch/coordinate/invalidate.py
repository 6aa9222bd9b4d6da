"""Invalidation coordination.

Reference: accord/coordinate/Invalidate.java — a two-phase machine. Phase 1
(`Invalidate`) sends BeginInvalidation to every shard the txn may touch and
folds the votes through InvalidationTracker: a promise quorum in some shard
plus a decisive fast-path rejection in some shard makes invalidation safe;
any witnessed Accepted-or-later state instead escalates to recovery with the
route discovered in the replies. Phase 2 (`ProposeInvalidate`,
Invalidate.proposeInvalidate / Propose.Invalidate) is the classic ballot
promise quorum in a single shard, followed by a CommitInvalidate broadcast
(Commit.Invalidate.commitInvalidate).

Recovery calls phase 2 directly once its own ballot round has proved the
transaction undecidable (Recover.java:361-376); knowledge-acquisition paths
that hold only a partial route (MaybeRecover.java:98, FetchData.java:113)
start at phase 1.
"""

from __future__ import annotations

from typing import List, Optional

from accord_tpu_torch.coordinate.errors import (Exhausted, Invalidated, Preempted,
                                          Timeout)
from accord_tpu_torch.coordinate.tracking import InvalidationTracker, RequestStatus
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.accept import AcceptInvalidate, AcceptNack
from accord_tpu_torch.messages.base import Callback, TxnRequest
from accord_tpu_torch.messages.commit import CommitInvalidate
from accord_tpu_torch.messages.invalidate_msg import BeginInvalidation, InvalidateReply
from accord_tpu_torch.primitives.keys import Ranges, Route
from accord_tpu_torch.primitives.timestamp import Ballot, TxnId
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult


class Invalidate(Callback):
    """Multi-shard invalidation round (Invalidate.java:52-280).

    `invalidate_with` is whatever (possibly partial) route knowledge we hold;
    the round doubles as route discovery — if any replica witnessed the
    definition we learn the full route and can recover instead."""

    def __init__(self, node, txn_id: TxnId, invalidate_with: Route,
                 result: AsyncResult, transitively_invoked: bool = False,
                 ballot: Optional[Ballot] = None):
        self.node = node
        self.txn_id = txn_id
        self.invalidate_with = invalidate_with
        self.result = result
        self.transitively_invoked = transitively_invoked
        if ballot is None:
            now = node.unique_now()
            ballot = Ballot(now.epoch, now.hlc, 0, node.id)
        self.ballot = ballot
        self.tracker: Optional[InvalidationTracker] = None
        self.replies: List[InvalidateReply] = []
        self.prepare_done = False
        self.done = False
        self.failure: Optional[BaseException] = None

    def start(self) -> None:
        # precisely the txnId epoch (reference Invalidate.java:76 forEpoch):
        # like recovery, the fast-path vote math must consult exactly the
        # electorate that could have ratified the fast path, not an
        # unsynced-extended older epoch's
        topologies = self.node.topology.precise_epochs(
            self.invalidate_with.participants(), self.txn_id.epoch,
            self.txn_id.epoch)
        self.tracker = InvalidationTracker(topologies)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies,
                                             self.invalidate_with)
            if scope is None:
                continue
            self.node.send(to, BeginInvalidation(self.txn_id, scope,
                                                 self.ballot),
                           callback=self)

    # ------------------------------------------------------------- callbacks --
    def on_success(self, from_id: int, reply) -> None:
        if self.done or self.prepare_done:
            return
        self.replies.append(reply)
        self._handle(self.tracker.record_success(
            from_id, reply.is_promised, reply.has_decision,
            reply.accepted_fast_path))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done or self.prepare_done:
            return
        if self.failure is None:
            self.failure = failure
        self._handle(self.tracker.record_failure(from_id))

    def _handle(self, status: RequestStatus) -> None:
        if status == RequestStatus.SUCCESS:
            self._decide()
        elif status == RequestStatus.FAILED:
            self.done = self.prepare_done = True
            superseding = [r.superseded_by for r in self.replies
                           if r.superseded_by is not None]
            if superseding:
                # bump our HLC past the superseding promise so a retry mints
                # a higher ballot even against a fast remote clock (mirrors
                # Recover's RecoverNack handling)
                self.node.on_remote_timestamp(max(superseding))
                self.node.events.on_preempted(self.txn_id)
            self.result.try_failure(
                self.failure if self.failure is not None
                else Preempted(f"invalidation of {self.txn_id} could not "
                               f"obtain promises"))

    # -------------------------------------------------------------- decision --
    def _decide(self) -> None:
        """Votes are in (Invalidate.java:146-242): if anything decided or
        Accepted-or-later was witnessed, recovery must finish the txn; a bare
        PreAccept may still race with its own fast path unless some shard
        decisively rejected it; otherwise invalidate outright."""
        invariants.check_state(not self.prepare_done,
                               "invalidation decided twice")
        self.prepare_done = True

        full_route = InvalidateReply.find_full_route(self.replies)
        max_reply = InvalidateReply.max(self.replies)
        status = max_reply.status

        if status.is_truncated:
            # durably applied (and shed) or erased: nothing left to decide
            self.done = True
            self.result.try_success(None)
            return
        if status == SaveStatus.INVALIDATED:
            self._commit_invalidate()
            return

        racy_preaccept = (status == SaveStatus.PRE_ACCEPTED
                          and not (self.tracker.is_safe_to_invalidate
                                   or self.transitively_invoked))
        if status >= SaveStatus.ACCEPTED or racy_preaccept:
            # someone may have (or provably could have) decided: recover.
            # preaccept/accept/commit all piggyback the full route, but a
            # replica may know a decision only through a partial-route
            # Propagate (precommit) — then nobody we reached has the full
            # route and we must retreat and let the progress log retry once
            # knowledge spreads
            if full_route is None:
                self.done = True
                self.result.try_failure(Exhausted(
                    f"{self.txn_id} witnessed at {status.name} but no "
                    f"reachable replica knows the full route"))
                return
            from accord_tpu_torch.coordinate.recover import Recover
            Recover(self.node, self.txn_id, full_route, self.result,
                    ballot=self.ballot).start()
            return

        # NOT_DEFINED / ACCEPTED_INVALIDATE / provably-unfast PRE_ACCEPTED:
        # finish the invalidation in the shard that promised us
        shard = self.tracker.promised_shard()
        ProposeInvalidate(self.node, self.ballot, self.txn_id,
                          self.invalidate_with, self._commit_invalidate,
                          self._fail, shard=shard).start()

    def _commit_invalidate(self) -> None:
        self.done = True
        merged = InvalidateReply.merge_routes(self.replies)
        commit_to = (merged.with_(self.invalidate_with) if merged is not None
                     else self.invalidate_with)
        commit_invalidate(self.node, self.txn_id, commit_to)
        self.node.events.on_invalidated(self.txn_id)
        self.result.try_failure(
            Invalidated(f"{self.txn_id} invalidated"))

    def _fail(self, failure: BaseException) -> None:
        self.done = True
        self.result.try_failure(failure)


class ProposeInvalidate(Callback):
    """Promise `ballot` to invalidate at a quorum of a single shard owning
    part of the route (Invalidate.proposeInvalidate). Defaults to the home
    shard; the multi-shard round passes whichever shard promised it."""

    def __init__(self, node, ballot: Ballot, txn_id: TxnId, route: Route,
                 on_done, on_failed, shard=None):
        self.node = node
        self.ballot = ballot
        self.txn_id = txn_id
        self.route = route
        self._on_done = on_done
        self._on_failed = on_failed
        self.shard = shard
        self.promises = set()
        self.failures = set()
        self.done = False

    def start(self) -> None:
        if self.shard is None:
            topology = self.node.topology.for_epoch(self.txn_id.epoch)
            self.shard = topology.shard_for_key(self.route.home_key)
        scope = self.route.slice(Ranges([self.shard.range]))
        for to in self.shard.nodes:
            self.node.send(to, AcceptInvalidate(self.txn_id, self.ballot,
                                                scope),
                           callback=self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, AcceptNack):
            self.done = True
            self._on_failed(Preempted(f"invalidate preempted: {reply.reason.name}"))
            return
        self.promises.add(from_id)
        if len(self.promises) >= self.shard.slow_path_quorum_size:
            self.done = True
            self._on_done()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        self.failures.add(from_id)
        if len(self.failures) > self.shard.max_failures:
            self.done = True
            self._on_failed(failure if isinstance(failure, Timeout)
                            else Exhausted(repr(failure)))


def commit_invalidate(node, txn_id: TxnId, route: Route) -> None:
    """Broadcast CommitInvalidate to every replica of the route
    (Commit.Invalidate.commitInvalidate)."""
    topologies = node.topology.with_unsynced_epochs(
        route.participants(), txn_id.epoch, max(txn_id.epoch, node.epoch))
    for to in topologies.nodes():
        scope = TxnRequest.compute_scope(to, topologies, route)
        if scope is None:
            continue
        node.send(to, CommitInvalidate(txn_id, scope))
