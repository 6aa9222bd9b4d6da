"""FetchData / FindRoute / MaybeRecover: knowledge acquisition.

Reference: accord/coordinate/FetchData.java (pull status/definition/deps/
outcome for a txn by contacting its shards with CheckStatus ALL, then apply
locally via Propagate), FindRoute.java / FindSomeRoute.java (discover the
route of a txn known only by id), MaybeRecover.java (home-shard check: has
anyone progressed? if yes propagate, else escalate to Recover).
"""

from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Timeout
from accord_tpu_torch.coordinate.tracking import QuorumTracker, RequestStatus
from accord_tpu_torch.local.status import Durability, ProgressToken, SaveStatus
from accord_tpu_torch.messages.base import Callback, TxnRequest
from accord_tpu_torch.messages.checkstatus import (CheckStatus, CheckStatusNack,
                                             CheckStatusOk, IncludeInfo)
from accord_tpu_torch.messages.propagate import Propagate
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import NONE as TS_NONE
from accord_tpu_torch.primitives.timestamp import Ballot, TxnId
from accord_tpu_torch.utils.async_chains import AsyncResult


class _CheckShards(Callback):
    """Quorum of CheckStatus over the route's shards, merged
    (coordinate/CheckShards.java).  A second tracker over the same
    topologies folds the per-reply InvalidIf evidence: when it reaches a
    quorum in every contacted shard, the merged reply is stamped
    `quorum_invalid_evidence` — the reference's Infer.inferInvalidWithQuorum
    precondition, consumed by infer.infer_invalid_with_quorum."""

    def __init__(self, node, txn_id: TxnId, route: Route,
                 include_info: IncludeInfo, result: AsyncResult):
        self.node = node
        self.txn_id = txn_id
        self.route = route
        self.include_info = include_info
        self.result = result
        self.merged: Optional[CheckStatusOk] = None
        self.tracker: Optional[QuorumTracker] = None
        self.evidence_tracker: Optional[QuorumTracker] = None
        self.done = False
        # Infer price counters: which contacted replicas attached
        # durability-derived invalidation evidence
        self._contacted = 0
        self._evidence_replies = 0
        self._evidence_quorum = False

    def start(self) -> None:
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch,
            max(self.txn_id.epoch, self.node.epoch))
        self.tracker = QuorumTracker(topologies)
        self.evidence_tracker = QuorumTracker(topologies)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            self._contacted += 1
            self.node.send(to, CheckStatus(self.txn_id, scope,
                                           self.include_info),
                           callback=self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, CheckStatusOk):
            from accord_tpu_torch.local.status import InvalidIf
            if reply.invalid_if >= InvalidIf.IF_UNDECIDED:
                self._evidence_replies += 1
                # evidence only ever attaches to an undecided local state
                # (messages/checkstatus.py), so an evidence quorum is also
                # an undecided quorum — the inferInvalidWithQuorum input
                if self.evidence_tracker.record_success(from_id) \
                        == RequestStatus.SUCCESS:
                    self._evidence_quorum = True
            self.merged = (reply if self.merged is None
                           else self.merged.merge(reply))
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            if self._evidence_replies:
                stats = self.node.infer_stats
                stats["evidence"] += 1
                if self._evidence_quorum:
                    # per-shard quorum of evidence (the exact
                    # Infer.inferInvalidWithQuorum test, replacing the r5
                    # majority-of-contacted proxy): resolvable with NO
                    # extra round under the full ladder
                    stats["quorum_evidence"] += 1
                    obs = getattr(self.node, "obs", None)
                    if obs is not None:
                        obs.flight.record(
                            "infer_evidence", repr(self.txn_id),
                            (self._evidence_replies, self._contacted))
            if self.merged is not None:
                self.merged.quorum_invalid_evidence = self._evidence_quorum
            self.result.try_success(self.merged)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            if self.merged is not None:
                # partial knowledge beats none (FetchData tolerates < quorum)
                self.result.try_success(self.merged)
            else:
                self.result.try_failure(
                    failure if isinstance(failure, Timeout)
                    else Exhausted(repr(failure)))


def check_shards(node, txn_id: TxnId, route: Route,
                 include_info: IncludeInfo) -> AsyncResult:
    result: AsyncResult = AsyncResult()
    _CheckShards(node, txn_id, route, include_info, result).start()
    return result


def fetch_data(node, txn_id: TxnId, route: Route) -> AsyncResult:
    """Fetch the maximum available knowledge for txn_id from its shards and
    apply it locally; resolves to the merged CheckStatusOk
    (coordinate/FetchData.java).  When the reply quorum itself proves the
    txn invalid (per-shard InvalidIf evidence, coordinate/infer.py), the
    invalidation is committed right here with no further round — the
    blocked-dependency chase that drove this fetch unblocks on the
    CommitInvalidate instead of escalating to recovery."""
    result: AsyncResult = AsyncResult()

    def on_checked(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.try_failure(failure)
            return
        from accord_tpu_torch.coordinate.infer import infer_invalid_with_quorum
        if merged is not None \
                and merged.save_status < SaveStatus.PRE_COMMITTED \
                and infer_invalid_with_quorum(node, txn_id, route, merged):
            result.try_success(merged)
            return
        if merged is not None and merged.save_status > SaveStatus.NOT_DEFINED:
            full = merged.route if merged.route is not None else route
            node.local_request(Propagate(txn_id, full, merged))
        result.try_success(merged)

    check_shards(node, txn_id, route, IncludeInfo.ALL).add_callback(on_checked)
    return result


def find_route(node, txn_id: TxnId, some_participants) -> AsyncResult:
    """Discover a txn's route by asking the shards of whatever participants
    we learned of it through (FindRoute/FindSomeRoute — `someUnseekables`).
    Resolves to the merged CheckStatusOk (whose .route may still be None)."""
    return check_shards(node, txn_id, Route.probe(some_participants),
                        IncludeInfo.ALL)


class _FetchMaxConflict(Callback):
    """Quorum-per-shard max-conflict fetch (coordinate/FetchMaxConflict.java).
    If any replica reports a later epoch than we queried at, the ownership of
    `route` may have moved — re-run against the newer topology so the answer
    covers every possible witness."""

    def __init__(self, node, route: Route, participants, execution_epoch: int,
                 result: AsyncResult, seen_conflict=TS_NONE):
        self.node = node
        self.route = route
        self.participants = participants
        self.execution_epoch = execution_epoch
        self.result = result
        self.tracker: Optional[QuorumTracker] = None
        # carry conflicts witnessed by earlier rounds across epoch-chase
        # retries — the old owners a later round no longer contacts may be
        # the only replicas that ever saw them (max is monotone, so stale
        # first-round answers remain sound)
        self.max_conflict = seen_conflict
        self.latest_epoch = execution_epoch
        self.done = False

    def start(self) -> None:
        from accord_tpu_torch.messages.maxconflict import GetMaxConflict
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.execution_epoch,
            self.execution_epoch)
        self.tracker = QuorumTracker(topologies)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            sliced = self.participants.slice(scope.covering())
            self.node.send(to, GetMaxConflict(scope, sliced,
                                              self.execution_epoch),
                           callback=self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        self.max_conflict = max(self.max_conflict, reply.max_conflict)
        self.latest_epoch = max(self.latest_epoch, reply.latest_epoch)
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.done = True
            if self.latest_epoch > self.execution_epoch:
                retry_epoch = self.latest_epoch
                seen = self.max_conflict
                self.node.with_epoch(
                    retry_epoch,
                    lambda: _FetchMaxConflict(self.node, self.route,
                                              self.participants, retry_epoch,
                                              self.result,
                                              seen_conflict=seen).start())
                return
            self.result.try_success(self.max_conflict)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self.result.try_failure(failure if isinstance(failure, Timeout)
                                    else Exhausted(repr(failure)))


def fetch_max_conflict(node, route: Route, participants) -> AsyncResult:
    """Highest conflicting timestamp any quorum witnessed over `participants`
    (Keys or Ranges), chasing epoch bumps; resolves to a Timestamp
    (FetchMaxConflict.fetchMaxConflict). Bootstrap uses this to fence reads
    of newly-owned ranges above every pre-handoff conflict."""
    result: AsyncResult = AsyncResult()
    _FetchMaxConflict(node, route, participants, node.epoch, result).start()
    return result


def maybe_recover(node, txn_id: TxnId, route: Route,
                  prev_progress) -> AsyncResult:
    """Home-shard liveness check: if anyone has moved the txn past
    `prev_progress` (a ProgressToken; None means no prior knowledge, i.e.
    ProgressToken.NONE; a bare SaveStatus is widened with zero ballots —
    durability/ballot movement counts as progress even when the status has
    not advanced, MaybeRecover.hasMadeProgress), absorb that knowledge;
    otherwise drive Recover — or, when nobody we can reach knows the full
    route and the outcome is still undecidable, the multi-shard Invalidate
    round, which either kills the txn or discovers the route and recovers
    (coordinate/MaybeRecover.java:95-105).

    Single-call contract: "progressed" means the merged remote state exceeds
    the BASELINE the caller passed — so a remote recovery ballot the caller
    did not know about counts, by design.  A persistent monitor re-probing
    the same txn must therefore pass a full ProgressToken and absorb the
    observed token between probes (SimpleProgressLog._done_home does), or an
    unchanged dead-recoverer ballot would read as fresh progress forever."""
    if prev_progress is None:
        prev_progress = ProgressToken.NONE
    elif isinstance(prev_progress, SaveStatus):
        # widen with the SAME rule token sources use (ProgressToken.of);
        # zero ballots: the caller claims no ballot knowledge, so any
        # outstanding promise reads as progress (see contract above)
        prev_progress = ProgressToken.of(Durability.NOT_DURABLE,
                                         prev_progress, Ballot.ZERO,
                                         Ballot.ZERO)
    result: AsyncResult = AsyncResult()

    def on_checked(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.try_failure(failure)
            return
        progressed = merged is not None and (
            merged.to_progress_token() > prev_progress
            or merged.is_coordinating)
        if progressed:
            if merged.save_status > SaveStatus.NOT_DEFINED:
                full = merged.route if merged.route is not None else route
                node.local_request(Propagate(txn_id, full, merged))
            result.try_success(merged)
            return
        best = route
        if merged is not None and merged.route is not None:
            # union the route fragments (Route.with_ keeps is_full if either
            # side covers the txn) — replacing would drop participants the
            # reply happens not to know
            best = route.with_(merged.route)
        undecided = merged is None \
            or merged.save_status < SaveStatus.PRE_COMMITTED
        # durability-derived evidence (coordinate/infer.py): an undecided
        # txn below the majority-durability bound is headed for invalidation
        if undecided:
            from accord_tpu_torch.coordinate.infer import infer_invalid_with_quorum
            from accord_tpu_torch.coordinate.errors import Invalidated
            if infer_invalid_with_quorum(node, txn_id, best, merged):
                # full ladder: a per-shard quorum of InvalidIf evidence
                # commits the invalidation with ZERO extra rounds
                # (Infer.inferInvalidWithQuorum) — no ballot needed, the
                # fence-refusal rule blocks any competing decision quorum
                result.try_failure(Invalidated(
                    f"{txn_id} invalidated by quorum inference"))
                return
        inferred_invalid = (undecided and merged is not None
                            and merged.invalid_if_undecided)
        if inferred_invalid:
            # evidence without a full quorum of it (or the =0 escape
            # hatch): pay a ballot-protected Invalidate round where the
            # full ladder may commit-invalidate with none
            node.infer_stats["inferred_rounds"] += 1
        chase = (node.invalidate
                 if undecided and (inferred_invalid or not best.is_full)
                 else node.recover)
        chase(txn_id, best).add_callback(
            lambda v, f: result.try_failure(f) if f is not None
            else result.try_success(v))

    check_shards(node, txn_id, route, IncludeInfo.ALL).add_callback(on_checked)
    return result
