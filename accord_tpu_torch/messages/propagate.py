"""Propagate: apply knowledge learned remotely to the local stores.

Reference: accord/messages/Propagate.java:62 — a LOCAL request (never crosses
the network) that walks a merged CheckStatusOk into the local command state:
invalidation first, then outcome (apply), then stable deps (commit), then
executeAt (precommit), then the definition (preaccept). Each tier only fires
if the remote knowledge actually exceeds what this store already has; the
regular transition functions enforce monotonicity.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.local.status import KnownDefinition, KnownDeps, SaveStatus
from accord_tpu_torch.messages.base import MessageType, Reply, SimpleReply, TxnRequest
from accord_tpu_torch.messages.checkstatus import CheckStatusOk
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import TxnId


class Propagate(TxnRequest):
    type = MessageType.PROPAGATE_OTHER_MSG

    def __init__(self, txn_id: TxnId, scope: Route, known: CheckStatusOk):
        super().__init__(txn_id, scope)
        self.known = known

    def process(self, node, from_id, reply_context) -> None:
        node.map_reduce_consume_local(self, from_id, None)

    def apply(self, safe_store) -> Reply:
        k = self.known
        cmd = safe_store.get(self.txn_id)
        route = k.route if k.route is not None else self.route

        if k.save_status == SaveStatus.INVALIDATED:
            C.commit_invalidate(safe_store, self.txn_id)
            return SimpleReply(SimpleReply.OK)
        from accord_tpu_torch.coordinate.infer import full_infer_enabled
        if k.save_status.is_truncated \
                and (k.writes is None or k.execute_at is None
                     or (full_infer_enabled()
                         and self.txn_id.kind.is_read)):
            # remote state is durably decided+applied and SHED, with no
            # outcome this store could still need: an erased write, or a
            # read — whose retained Writes object is vacuous, yet used to
            # route it into the apply tier where its erased deps struck
            # endless INSUFFICIENT catch-ups (a read below the fence can
            # never execute here and has nothing to install).  Full Infer
            # ladder: install the truncation locally (Infer.safeToCleanup
            # via Propagate in the reference) so local waiters stop
            # chasing it — the fence-refusal rule means our undecided
            # copy can never decide it either.  Under ACCORD_INFER_FULL=0
            # this stays the documented narrowing: nothing to learn from
            # an outcome-less truncation, and truncated reads keep
            # routing through the apply tier's INSUFFICIENT staleness
            # strikes.
            if full_infer_enabled() and not cmd.save_status.is_decided:
                C.set_truncated_remotely(safe_store, self.txn_id,
                                         k.execute_at)
            return SimpleReply(SimpleReply.OK)

        # what the merged reply actually justifies for THIS store's slice of
        # the route (CheckStatus.FoundKnownMap.knownFor): a partial-quorum
        # merge may carry a high global save_status whose definition/deps
        # fields cover only the shards that replied — slicing those to our
        # ranges would silently yield under-covering deps/bodies, so each
        # per-range tier below also requires the per-range knowledge
        owned = route.owned_participants(safe_store.ranges)
        knows = k.known_for(owned)

        local = k.partial_txn.slice(safe_store.ranges, include_query=False) \
            if k.partial_txn is not None and not safe_store.ranges.is_empty \
            else k.partial_txn
        deps = k.stable_deps.slice(safe_store.ranges) \
            if k.stable_deps is not None and not safe_store.ranges.is_empty \
            else k.stable_deps
        if knows.deps < KnownDeps.STABLE:
            # not justified for every owned range: let each tier's
            # deps-required path degrade (apply falls to INSUFFICIENT
            # catch-up + staleness escalation, commit tiers are skipped)
            deps = None
        if knows.definition < KnownDefinition.YES:
            local = None

        if k.save_status >= SaveStatus.PRE_APPLIED and k.writes is not None \
                and k.execute_at is not None:
            outcome = C.apply(safe_store, self.txn_id, route, k.execute_at,
                              deps, k.writes, k.result, partial_txn=local)
            if outcome != C.ApplyOutcome.INSUFFICIENT:
                safe_store.store.insufficient_catchups.pop(self.txn_id, None)
            elif knows.deps == KnownDeps.ERASED:
                # truncated-with-outcome source (deps purged, gone forever)
                # and we are below STABLE: per-txn catch-up cannot order
                # this write safely — applying here with fabricated deps
                # could reorder writes under the data plane's executeAt
                # guard. After repeated failures, declare the owning ranges
                # stale and re-acquire them wholesale (reference
                # markShardStale -> bootstrap; ADVICE r1: nothing else
                # triggers bootstrap outside topology changes, so the
                # replica wedged forever).
                self._maybe_escalate_staleness(safe_store, route)
            # else: deps merely unfetched (partial quorum, partition) — a
            # later fetch can still supply them, so no escalation strike
            return SimpleReply(SimpleReply.OK)
        if k.save_status >= SaveStatus.STABLE and k.execute_at is not None \
                and deps is not None and not cmd.has_been(SaveStatus.STABLE):
            C.commit(safe_store, self.txn_id, route, local, k.execute_at,
                     deps, stable=True)
            return SimpleReply(SimpleReply.OK)
        if k.save_status >= SaveStatus.COMMITTED and k.execute_at is not None \
                and deps is not None and not cmd.has_been(SaveStatus.COMMITTED):
            C.commit(safe_store, self.txn_id, route, local, k.execute_at,
                     deps, stable=False)
            return SimpleReply(SimpleReply.OK)
        if k.save_status >= SaveStatus.PRE_COMMITTED \
                and k.execute_at is not None \
                and not cmd.has_been(SaveStatus.PRE_COMMITTED):
            C.precommit(safe_store, self.txn_id, k.execute_at)
            return SimpleReply(SimpleReply.OK)
        if k.save_status >= SaveStatus.PRE_ACCEPTED and local is not None \
                and not cmd.has_been(SaveStatus.PRE_ACCEPTED):
            C.preaccept(safe_store, self.txn_id, local, route)
            return SimpleReply(SimpleReply.OK)
        return SimpleReply(SimpleReply.OK)

    STALE_AFTER_ATTEMPTS = 3

    def _maybe_escalate_staleness(self, safe_store, route: Route) -> None:
        """After repeated INSUFFICIENT catch-ups, mark the owning ranges stale
        and drive a bootstrap fetch for them (Agent.onStale / markShardStale
        -> Bootstrap in the reference)."""
        store = safe_store.store
        count = store.insufficient_catchups.get(self.txn_id, 0) + 1
        store.insufficient_catchups[self.txn_id] = count
        if count < self.STALE_AFTER_ATTEMPTS:
            return
        store.insufficient_catchups.pop(self.txn_id, None)
        covering = route.covering() if route is not None else None
        if covering is None or covering.is_empty:
            return
        owned = covering.slice(store.ranges) \
            if not store.ranges.is_empty else covering
        if owned.is_empty:
            return
        stale_until = self.known.execute_at if self.known.execute_at \
            is not None else self.txn_id
        store.redundant_before.set_stale_until(owned, stale_until)
        # a stale span must nack reads immediately (coordinator retries a
        # healthy peer) rather than let them hang on never-applying deps;
        # Bootstrap._finish restores safe_to_read once the snapshot lands
        store.safe_to_read = store.safe_to_read.subtract(owned)
        safe_store.node.mark_stale_and_bootstrap(owned)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return f"Propagate({self.txn_id!r}, {self.known.save_status.name})"
