"""Apply: deliver the outcome (writes + result) for asynchronous persistence.

Reference: accord/messages/Apply.java:47 — Kinds Minimal/Maximal (:72);
Commands.apply then reply Applied/Redundant/Insufficient (:146-210).
"""

from __future__ import annotations

import enum
from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes


class ApplyReply(Reply):
    type = MessageType.APPLY_RSP

    APPLIED = "Applied"
    REDUNDANT = "Redundant"
    INSUFFICIENT = "Insufficient"

    def __init__(self, outcome: str):
        self.outcome = outcome

    def __eq__(self, other):
        return isinstance(other, ApplyReply) and self.outcome == other.outcome

    def __repr__(self):
        return f"ApplyReply({self.outcome})"


class ApplyKind(enum.Enum):
    MINIMAL = MessageType.APPLY_MINIMAL_REQ
    MAXIMAL = MessageType.APPLY_MAXIMAL_REQ


class Apply(TxnRequest):
    def __init__(self, kind: ApplyKind, txn_id: TxnId, scope: Route,
                 execute_at: Timestamp, deps: Optional[Deps],
                 writes: Optional[Writes], result,
                 partial_txn: Optional[PartialTxn] = None,
                 full_route: Route = None):
        super().__init__(txn_id, scope, wait_for_epoch=execute_at.epoch,
                         full_route=full_route)
        self.kind = kind
        self.type = kind.value
        self.execute_at = execute_at
        self.deps = deps
        self.writes = writes
        self.result = result
        self.partial_txn = partial_txn  # Maximal only

    def apply(self, safe_store):
        deps = self.deps
        if deps is not None and not safe_store.ranges.is_empty:
            deps = deps.slice(safe_store.ranges)
        # store the FULL writes (reference keeps command.writes() unsliced;
        # execution slices per store via Writes.apply(within)): outcome
        # knowledge is then legitimately global — any replica that knows the
        # outcome can hand every store the whole effect, so CheckStatus
        # merges need no per-range writes provenance
        outcome = C.apply(safe_store, self.txn_id, self.route, self.execute_at,
                          deps, self.writes, self.result,
                          partial_txn=self.partial_txn)
        return ApplyReply({
            C.ApplyOutcome.SUCCESS: ApplyReply.APPLIED,
            C.ApplyOutcome.REDUNDANT: ApplyReply.REDUNDANT,
            C.ApplyOutcome.INSUFFICIENT: ApplyReply.INSUFFICIENT,
        }[outcome])

    def reduce(self, a: ApplyReply, b: ApplyReply) -> ApplyReply:
        order = [ApplyReply.INSUFFICIENT, ApplyReply.APPLIED, ApplyReply.REDUNDANT]
        return a if order.index(a.outcome) <= order.index(b.outcome) else b

    def execute_probe(self):
        """The execution this Apply delivers, for the device store's
        in-window wavefront scheduler (reference execution ordering:
        Commands.maybeExecute :656 + NotifyWaitingOn :1011 walk one
        command at a time; the device plans the whole window's order in
        one kernel dispatch)."""
        if not self.scope.is_key_domain:
            return None  # range-domain executions stay on the scalar walk
        return (self.txn_id, self.execute_at, self.scope.participant_keys())

    def __repr__(self):
        return f"Apply({self.kind.name}, {self.txn_id!r}@{self.execute_at!r})"


class ApplyThenWaitUntilApplied(Apply):
    """Apply the outcome AND reply only once the command has applied
    locally — commit, (trivial) execute, and apply fused into one
    request/response (reference accord/messages/
    ApplyThenWaitUntilApplied.java:37, used by sync-point execution,
    coordinate/ExecuteSyncPoint.java:66).

    A sync point carries no writes; it reaches APPLIED exactly when its
    dependencies drain on this replica, so acking at APPLIED is the
    reference's "return when the dependencies are Applied" — and it saves
    the separate WaitUntilApplied round the unfused path pays (reference
    impl/AbstractFetchCoordinator.java:215 uses the same fusion on the
    bootstrap path).  An INSUFFICIENT outcome still nacks immediately so
    the coordinator can escalate to a maximal apply."""

    def __init__(self, kind: ApplyKind, txn_id: TxnId, scope: Route,
                 execute_at: Timestamp, deps: Optional[Deps],
                 writes: Optional[Writes], result,
                 partial_txn: Optional[PartialTxn] = None,
                 full_route: Route = None):
        super().__init__(kind, txn_id, scope, execute_at, deps, writes,
                         result, partial_txn=partial_txn,
                         full_route=full_route)
        self.type = MessageType.APPLY_THEN_WAIT_UNTIL_APPLIED_REQ

    def apply(self, safe_store):
        from accord_tpu_torch.messages.wait import await_applied

        reply = super().apply(safe_store)
        if reply.outcome == ApplyReply.INSUFFICIENT:
            return reply
        return await_applied(safe_store, self.txn_id,
                             self.scope.participants(), reply)

    def __repr__(self):
        return (f"ApplyThenWaitUntilApplied({self.kind.name}, "
                f"{self.txn_id!r}@{self.execute_at!r})")
