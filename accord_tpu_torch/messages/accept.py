"""Accept: slow-path ballot acceptance of (executeAt, deps).

Reference: accord/messages/Accept.java:50 — Commands.accept then a fresh deps
calculation bounded by executeAt, returned for the commit round (:84-130);
inner Accept.Invalidate.
"""

from __future__ import annotations

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId


class AcceptOk(Reply):
    type = MessageType.ACCEPT_RSP

    def __init__(self, txn_id: TxnId, deps: Deps):
        self.txn_id = txn_id
        self.deps = deps

    def __repr__(self):
        return f"AcceptOk({self.txn_id!r})"


class AcceptNack(Reply):
    type = MessageType.ACCEPT_RSP

    def __init__(self, reason: C.AcceptOutcome):
        self.reason = reason

    def __repr__(self):
        return f"AcceptNack({self.reason.name})"


class Accept(TxnRequest):
    type = MessageType.ACCEPT_REQ

    def __init__(self, txn_id: TxnId, ballot: Ballot, scope: Route,
                 participating_keys, execute_at: Timestamp, deps: Deps,
                 max_epoch: int = 0, full_route: Route = None):
        super().__init__(txn_id, scope,
                         wait_for_epoch=max_epoch or execute_at.epoch,
                         full_route=full_route)
        self.ballot = ballot
        self.participating_keys = participating_keys
        self.execute_at = execute_at
        self.deps = deps

    def apply(self, safe_store) -> Reply:
        owned_keys = self.participating_keys.slice(safe_store.ranges) \
            if not safe_store.ranges.is_empty else self.participating_keys
        outcome = C.accept(safe_store, self.txn_id, self.ballot, self.route,
                           owned_keys, self.execute_at,
                           self.deps.slice(safe_store.ranges))
        if outcome in (C.AcceptOutcome.SUCCESS, C.AcceptOutcome.REDUNDANT):
            # deps freshly calculated up to executeAt for the commit round.
            # The REDUNDANT (already PRE_COMMITTED+) arm must ALSO report its
            # known conflicts: this reply still counts toward the accept
            # quorum, and a conflict known only to this replica would
            # otherwise be missing from the stable-deps union
            deps = C.calculate_deps(safe_store, self.txn_id, owned_keys,
                                    before=self.execute_at)
            return AcceptOk(self.txn_id, deps)
        return AcceptNack(outcome)

    def deps_probe(self):
        return (self.execute_at, self.txn_id.kind.witnesses(),
                self.participating_keys)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        if isinstance(a, AcceptNack):
            return a
        if isinstance(b, AcceptNack):
            return b
        assert isinstance(a, AcceptOk) and isinstance(b, AcceptOk)
        return AcceptOk(self.txn_id, a.deps.with_(b.deps))

    def __repr__(self):
        return f"Accept({self.txn_id!r}@{self.execute_at!r}, b={self.ballot!r})"


class AcceptInvalidate(TxnRequest):
    """Accept.Invalidate: promise at `ballot` to invalidate txn_id."""

    type = MessageType.ACCEPT_INVALIDATE_REQ

    def __init__(self, txn_id: TxnId, ballot: Ballot, scope: Route):
        super().__init__(txn_id, scope)
        self.ballot = ballot

    def apply(self, safe_store) -> Reply:
        outcome = C.accept_invalidate(safe_store, self.txn_id, self.ballot)
        if outcome in (C.AcceptOutcome.SUCCESS, C.AcceptOutcome.REDUNDANT):
            return AcceptOk(self.txn_id, Deps.NONE)
        return AcceptNack(outcome)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        if isinstance(a, AcceptNack):
            return a
        return b
