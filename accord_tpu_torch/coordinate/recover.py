"""Recover: leaderless recovery of a (possibly abandoned) transaction.

Reference: accord/coordinate/Recover.java:76-405 — quorum of BeginRecovery at
a fresh ballot; if anything Accepted-or-later is found, complete it; otherwise
decipher whether the fast path could have been taken (RecoveryTracker vote
math + per-replica rejectsFastPath predicates), invalidating when provably
not, completing at the original timestamp when it may have been. Earlier
accepted-without-witness txns must commit before the decision is sound
(awaitCommits -> retry). Recovered txns persist with Apply.Maximal
(CoordinationAdapter Step.InitiateRecovery, CoordinationAdapter.java:196-206).
"""

from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Invalidated, Preempted, Timeout
from accord_tpu_torch.coordinate.execute import ExecutePath, Propose
from accord_tpu_torch.coordinate.invalidate import ProposeInvalidate, commit_invalidate
from accord_tpu_torch.coordinate.tracking import QuorumTracker, RecoveryTracker, RequestStatus
from accord_tpu_torch.messages.apply_msg import Apply, ApplyKind
from accord_tpu_torch.messages.base import Callback, TxnRequest
from accord_tpu_torch.messages.commit import CommitKind
from accord_tpu_torch.messages.getdeps import GetDeps, GetDepsOk
from accord_tpu_torch.messages.recover import BeginRecovery, RecoverNack, RecoverOk
from accord_tpu_torch.messages.wait import WaitOnCommit
from accord_tpu_torch.local.status import InvalidIf, SaveStatus
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult


class Recover(Callback):
    def __init__(self, node, txn_id: TxnId, route: Route, result: AsyncResult,
                 ballot: Optional[Ballot] = None):
        self.node = node
        self.txn_id = txn_id
        self.route = route
        self.result = result
        if ballot is None:
            now = node.unique_now()
            ballot = Ballot(now.epoch, now.hlc, 0, node.id)
        self.ballot = ballot
        self.tracker: Optional[RecoveryTracker] = None
        # per-shard quorum of InvalidIf evidence (coordinate/infer.py):
        # when it fills, the decipher's invalidate decision commits off the
        # BeginRecovery promise quorum itself — no ProposeInvalidate round
        self.evidence_tracker: Optional[QuorumTracker] = None
        self.evidence_quorum = False
        self.oks: Dict[int, RecoverOk] = {}
        self.ballot_promised = False
        self.done = False

    # ------------------------------------------------------- recovery round --
    def start(self) -> None:
        # PRECISELY the txnId epoch (reference Recover.java:163 asserts
        # oldestEpoch == currentEpoch == txnId.epoch, via forEpoch): the
        # unsynced-extension would pull OLDER epochs' electorates into the
        # fast-path vote math, and a non-witness there can veto a fast path
        # that was never required to consult that electorate — recovery then
        # invalidates a committed transaction (found by a 2000-op soak burn
        # under loss + topology churn).
        self.node.obs.txn_phase(self.txn_id, "begin_recover",
                                ballot=repr(self.ballot))
        topologies = self.node.topology.precise_epochs(
            self.route.participants(), self.txn_id.epoch, self.txn_id.epoch)
        self.tracker = RecoveryTracker(topologies)
        self.evidence_tracker = QuorumTracker(topologies)
        sent = 0
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            self.node.send(to, BeginRecovery(self.txn_id, scope, self.ballot,
                                             full_route=self.route),
                           callback=self)
            sent += 1
        if sent == 0:
            # never leave the round incomplete: the result is deduplicated
            # through Node.coordinating, so a silent no-op wedges all future
            # recovery of this txn
            self._fail(Exhausted(
                f"recovery of {self.txn_id} found no reachable participants"))

    def on_success(self, from_id: int, reply) -> None:
        if self.done or self.ballot_promised:
            return
        if isinstance(reply, RecoverNack):
            # bump our HLC past the superseding promise so a later retry
            # mints a higher ballot
            self.node.on_remote_timestamp(reply.superseded_by)
            self.node.events.on_preempted(self.txn_id)
            self._fail(Preempted(f"recovery of {self.txn_id} superseded by "
                                 f"{reply.superseded_by}"))
            return
        invariants.check_state(isinstance(reply, RecoverOk),
                               "unexpected reply %s", reply)
        self.oks[from_id] = reply
        if getattr(reply, "invalid_if", InvalidIf.NOT_KNOWN_TO_BE_INVALID) \
                >= InvalidIf.IF_UNDECIDED \
                and self.evidence_tracker.record_success(from_id) \
                == RequestStatus.SUCCESS:
            self.evidence_quorum = True
        # this replica could only have cast a fast-path accept if it had
        # witnessed the txn at its original timestamp (Recover.onSuccess:
        # fastPath = ok.executeAt == txnId)
        if self.tracker.record_success(
                from_id, rejects_fast_path=not reply.witnessed_at_original) \
                == RequestStatus.SUCCESS:
            self._recover()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done or self.ballot_promised:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self._fail(failure if isinstance(failure, Timeout)
                       else Exhausted(repr(failure)))

    # ----------------------------------------------------------- deciphering --
    def _recover(self) -> None:
        self.ballot_promised = True
        oks = list(self.oks.values())
        merged = oks[0]
        for ok in oks[1:]:
            merged = merged.merge(ok)

        status = merged.status
        if status.is_truncated:
            # durably applied and shed everywhere that matters
            self._succeed(None)
            return
        if status == SaveStatus.INVALIDATED:
            self._commit_invalidate(merged)
            return
        if status >= SaveStatus.PRE_APPLIED:
            self._persist_outcome(merged)
            return
        if status.is_at_least_committed or status == SaveStatus.PRE_COMMITTED:
            self._with_committed_deps(
                merged, lambda deps: self._execute(merged, merged.execute_at,
                                                   deps))
            return
        if status == SaveStatus.ACCEPTED:
            # re-propose the highest-ballot accepted executeAt with the
            # range-wise proposal merge (max-ballot proposals where they
            # exist, unioned local calculations elsewhere)
            self._propose(merged, merged.execute_at,
                          merged.latest_deps.merge_proposal())
            return
        if status == SaveStatus.ACCEPTED_INVALIDATE:
            self._invalidate(merged)
            return

        # nothing accepted anywhere: decipher the fast path
        if self.tracker.rejects_fast_path() or merged.rejects_fast_path:
            self._invalidate(merged)
            return
        # the fast path may have been taken; earlier accepted txns that never
        # witnessed us must commit before that is sound (Recover.java:322-336).
        # Unresolved elision covers join the same await: a replica reported
        # omission evidence it could not classify because the would-be cover
        # write is not decided locally (CommandsForKey.omission_covers) —
        # once the cover commits, the retried round reads the omission as
        # either legal elision or genuine reject evidence.
        blocking = merged.earlier_no_witness
        if not merged.unresolved_covers.is_empty:
            blocking = blocking.with_(merged.unresolved_covers)
        if not blocking.is_empty:
            self._await_commits(blocking)
            return
        self._propose(merged, self.txn_id.as_timestamp(),
                      merged.latest_deps.merge_proposal())

    # --------------------------------------------------------- continuations --
    def _reconstitute(self, merged: RecoverOk) -> Txn:
        invariants.check_state(
            merged.partial_txn is not None,
            "recovery of %s reached a completion path without a definition",
            self.txn_id)
        return merged.partial_txn.reconstitute(self.route)

    def _require_definition(self, merged: RecoverOk, cont) -> bool:
        """Completion paths need the txn body, but the recovery quorum may
        hold only definition-less knowledge (Accept carries keys, not the
        txn; Propagate can install PreCommitted without it).  Fetch it from
        whoever has it; if nobody reachable does, retreat — the progress
        log retries once partitions heal.  Returns True when the
        continuation was taken over (deferred or failed)."""
        if merged.partial_txn is not None:
            return False
        from accord_tpu_torch.coordinate.fetch import fetch_data

        def fetched(ok, failure):
            if self.done:
                return
            pt = getattr(ok, "partial_txn", None) if failure is None else None
            # a slice that does not cover the route must NOT be promoted to
            # the whole txn — completing with it would silently drop other
            # shards' reads/updates; retreat and retry when more knowledge
            # is reachable.  For key-domain routes the definitive test is
            # key-set containment (the route lists exactly the txn's
            # participating keys; PartialTxn.covers is range-only).
            if pt is not None and self._definition_covers_route(pt):
                merged.partial_txn = pt
                cont()
            else:
                self._fail(Exhausted(
                    f"recovery of {self.txn_id} could not obtain a "
                    f"route-covering txn definition from any reachable "
                    f"replica"))

        fetch_data(self.node, self.txn_id, self.route).add_callback(fetched)
        return True

    def _definition_covers_route(self, pt) -> bool:
        from accord_tpu_torch.primitives.keys import Keys
        if self.route.is_key_domain and isinstance(pt.keys, Keys):
            want = set(self.route.participant_keys())
            return want <= set(pt.keys)
        return pt.covers(self.route.covering())

    def _propose(self, merged: RecoverOk, execute_at: Timestamp, deps: Deps
                 ) -> None:
        if self._require_definition(
                merged, lambda: self._propose(merged, execute_at, deps)):
            return
        txn = self._reconstitute(merged)

        def accepted(stable_deps: Deps):
            if self.done:
                return
            from accord_tpu_torch.coordinate.execute import Stabilise
            Stabilise.then(
                self.node, self.txn_id, txn, self.route, execute_at,
                stable_deps,
                lambda: self._execute(merged, execute_at, stable_deps,
                                      txn=txn),
                self._fail)

        Propose(self.node, self.txn_id, txn, self.route, self.ballot,
                execute_at, deps, accepted, self._fail).start()

    def _execute(self, merged: RecoverOk, execute_at: Timestamp, deps: Deps,
                 txn: Optional[Txn] = None) -> None:
        if self.done:
            return
        if txn is None and self._require_definition(
                merged, lambda: self._execute(merged, execute_at, deps)):
            return
        txn = txn if txn is not None else self._reconstitute(merged)
        path = ExecutePath(self.node, self.txn_id, txn, self.route, execute_at,
                           deps, CommitKind.STABLE_MAXIMAL, ApplyKind.MAXIMAL,
                           self.result)
        self.done = True
        self.node.events.on_recover(self.txn_id, "execute")
        path.start()

    def _persist_outcome(self, merged: RecoverOk) -> None:
        """Outcome already known: re-broadcast Apply.Maximal
        (Recover.java Applied/PreApplied arm)."""
        if self._require_definition(
                merged, lambda: self._persist_outcome(merged)):
            return
        txn = self._reconstitute(merged)

        # replicas store writes with `keys` sliced to their ranges but the
        # full effect payload intact (Apply.apply -> Writes.slice), so any
        # single recovered copy can be re-expanded to full coverage — without
        # this, shards whose replicas never applied would slice the partial
        # key set to empty and lose the acked write
        writes = merged.writes
        if writes is not None and txn.update is not None:
            from accord_tpu_torch.primitives.writes import Writes
            writes = Writes(writes.txn_id, writes.execute_at,
                            txn.update.keys(), writes.write)

        def with_deps(deps: Deps):
            if self.done:
                return
            self.done = True
            topologies = self.node.topology.with_unsynced_epochs(
                self.route.participants(), self.txn_id.epoch,
                merged.execute_at.epoch)
            for to in topologies.nodes():
                scope = TxnRequest.compute_scope(to, topologies, self.route)
                if scope is None:
                    continue
                partial = txn.slice(scope.covering(), include_query=False)
                self.node.send(
                    to, Apply(ApplyKind.MAXIMAL, self.txn_id, scope,
                              merged.execute_at, deps, writes,
                              merged.result, partial_txn=partial,
                              full_route=self.route))
            self.node.events.on_recover(self.txn_id, "persist")
            self.result.try_success(merged.result)

        self._with_committed_deps(merged, with_deps)

    def _with_committed_deps(self, merged: RecoverOk, with_deps) -> None:
        """Range-wise merge of the quorum's committed deps
        (Recover.withCommittedDeps over LatestDeps.mergeCommit): ranges with
        committed knowledge — or, for a fast-path decision
        (executeAt == txnId), with locally-calculated equivalents — are
        sufficient as-is; only the remainder needs a fresh CollectDeps round
        bounded by executeAt."""
        use_local = merged.execute_at == self.txn_id.as_timestamp()
        deps, sufficient = merged.latest_deps.merge_commit(use_local)
        missing = self._route_not_covered_by(sufficient)
        if missing is None:
            with_deps(deps)
            return
        collect = CollectDeps(self.node, self.txn_id, missing,
                              merged.execute_at)

        def collected(fresh: Deps, failure: BaseException = None):
            if failure is not None:
                self._fail(failure)
                return
            with_deps(deps.with_(fresh))

        collect.start(collected)

    def _route_not_covered_by(self, sufficient) -> Optional[Route]:
        """The slice of our route with no sufficient deps, or None."""
        if self.route.is_key_domain:
            from accord_tpu_torch.primitives.keys import RoutingKeys
            keys = RoutingKeys([k for k in self.route.keys
                                if not sufficient.contains(k)])
            if len(keys) == 0:
                return None
            return Route(self.route.home_key, keys=keys, is_full=False)
        remainder = self.route.ranges.subtract(sufficient)
        if remainder.is_empty:
            return None
        return Route(self.route.home_key, ranges=remainder, is_full=False)

    def _await_commits(self, waiting_on: Deps) -> None:
        """WaitOnCommit each blocking dep at a quorum of the shards it
        participates in at THIS key range (its own route may be wider, but
        only the intersection with ours gates our decision).

        Deps here span BOTH domains: a key-domain recovery can be gated on an
        earlier accepted RANGE transaction (earlier_no_witness range arm,
        store._earlier_accepted_no_witness_ranges) — route each dep through
        the participants of its own domain.  A dep that yields no reachable
        destinations must fail the round rather than leave it forever
        incomplete: recovery futures are deduplicated through
        Node.coordinating, so a never-settling round permanently wedges ALL
        future recovery of this txn (seed-15003 soak: an acked write was
        lost exactly this way)."""
        dep_ids = waiting_on.sorted_txn_ids()
        remaining = [len(dep_ids)]

        def one_done(v=None, failure=None):
            if self.done:
                return
            if failure is not None:
                self._fail(failure)
                return
            remaining[0] -= 1
            if remaining[0] == 0:
                self._retry()

        for dep_id in dep_ids:
            key_parts, range_parts = waiting_on.participants(dep_id)
            if len(key_parts) > 0:
                participants = key_parts
                dep_route = Route(self.route.home_key,
                                  keys=key_parts.as_routing(), is_full=False)
            else:
                participants = range_parts
                dep_route = Route(self.route.home_key, ranges=range_parts,
                                  is_full=False)
            sent = 0
            if len(participants) > 0:
                topologies = self.node.topology.with_unsynced_epochs(
                    participants, self.txn_id.epoch, self.txn_id.epoch)
                tracker = QuorumTracker(topologies)
                waiter = _AwaitCommit(tracker, one_done)
                for to in topologies.nodes():
                    scope = TxnRequest.compute_scope(to, topologies, dep_route)
                    if scope is None:
                        continue
                    self.node.send(to, WaitOnCommit(dep_id, scope),
                                   callback=waiter)
                    sent += 1
            if sent == 0:
                one_done(failure=Exhausted(
                    f"await-commits of {dep_id} for recovery of "
                    f"{self.txn_id} found no reachable participants"))
                return

    def _retry(self) -> None:
        """Re-run the recovery round at the same ballot with a FRESH instance
        so stale replies and armed timeouts from this round cannot pollute the
        new tracker (Recover.retry constructs a new Recover)."""
        if self.done:
            return
        self.done = True
        Recover(self.node, self.txn_id, self.route, self.result,
                ballot=self.ballot).start()

    def _invalidate(self, merged: RecoverOk) -> None:
        from accord_tpu_torch.coordinate.infer import full_infer_enabled
        if full_infer_enabled() and self.evidence_quorum \
                and merged.status < SaveStatus.ACCEPTED:
            # full Infer ladder (Infer.inferInvalidWithQuorum in the
            # recovery path): a per-shard quorum of undecided replies
            # carried durability evidence, and that same quorum already
            # holds promises at self.ballot from the BeginRecovery round —
            # a ProposeInvalidate round would only re-collect the promises
            # we have.  The fence-refusal rule (Commands.is_durably_fenced)
            # blocks any competing accept quorum below the fence, so the
            # direct commit cannot race a late decision.
            obs = getattr(self.node, "obs", None)
            if obs is not None:
                obs.flight.record("infer_invalidate", repr(self.txn_id),
                                  ("recovery_quorum_evidence",
                                   merged.status.name))
            self.node.infer_stats["no_round_commits"] += 1
            self._commit_invalidate(merged)
            return

        def promised():
            if not self.done:
                self._commit_invalidate(merged)

        ProposeInvalidate(self.node, self.ballot, self.txn_id, self.route,
                          promised, self._fail).start()

    def _commit_invalidate(self, merged: RecoverOk) -> None:
        self.done = True
        commit_invalidate(self.node, self.txn_id, self.route)
        self.node.events.on_invalidated(self.txn_id)
        self.result.try_failure(Invalidated(f"{self.txn_id} invalidated by recovery"))

    def _succeed(self, result) -> None:
        self.done = True
        self.result.try_success(result)

    def _fail(self, failure: BaseException) -> None:
        self.done = True
        if isinstance(failure, Timeout):
            self.node.events.on_timeout(self.txn_id)
        self.result.try_failure(failure)


class _AwaitCommit(Callback):
    def __init__(self, tracker: QuorumTracker, on_done):
        self.tracker = tracker
        self.on_done = on_done
        self.fired = False

    def on_success(self, from_id: int, reply) -> None:
        if not self.fired and self.tracker.record_success(from_id) \
                == RequestStatus.SUCCESS:
            self.fired = True
            self.on_done()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if not self.fired and self.tracker.record_failure(from_id) \
                == RequestStatus.FAILED:
            self.fired = True
            self.on_done(failure=failure)


class CollectDeps(Callback):
    """Collect fresh deps bounded by `before` from a quorum per shard
    (coordinate/CollectDeps.java over GET_DEPS_REQ)."""

    def __init__(self, node, txn_id: TxnId, route: Route, before: Timestamp):
        self.node = node
        self.txn_id = txn_id
        self.route = route
        self.before = before
        self.tracker: Optional[QuorumTracker] = None
        self.oks: Dict[int, GetDepsOk] = {}
        self.on_done = None
        self.fired = False

    def start(self, on_done) -> None:
        self.on_done = on_done
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch, self.before.epoch)
        self.tracker = QuorumTracker(topologies)
        sent = 0
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            participants = (scope.participant_keys() if scope.is_key_domain
                            else scope.ranges)
            self.node.send(
                to, GetDeps(self.txn_id, scope, participants, self.before),
                callback=self)
            sent += 1
        if sent == 0:
            self.fired = True
            self.on_done(None, failure=Exhausted(
                f"collect-deps for {self.txn_id} found no reachable "
                f"participants"))

    def on_success(self, from_id: int, reply) -> None:
        if self.fired:
            return
        self.oks[from_id] = reply
        if self.tracker.record_success(from_id) == RequestStatus.SUCCESS:
            self.fired = True
            self.on_done(Deps.merge([ok.deps for ok in self.oks.values()]))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.fired:
            return
        if self.tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.fired = True
            self.on_done(None, failure=failure
                         if isinstance(failure, Timeout)
                         else Exhausted(repr(failure)))
