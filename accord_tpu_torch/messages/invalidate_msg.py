"""BeginInvalidation: the multi-shard invalidation voting round.

Reference: accord/messages/BeginInvalidation.java — each replica promises the
invalidation ballot (Commands.preacceptInvalidate) and reports everything it
knows: promise outcome, accepted ballot, status, whether it witnessed the txn
at its original timestamp (a fast-path accept), and any route fragment. The
coordinator (coordinate/invalidate.Invalidate) combines the per-shard votes
through InvalidationTracker to decide between invalidating outright and
escalating to recovery with the discovered route.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import Ballot, TxnId


class BeginInvalidation(TxnRequest):
    """Ask each replica to promise `ballot` toward invalidating txn_id and
    report its knowledge (BeginInvalidation.java:35-112)."""

    type = MessageType.BEGIN_INVALIDATE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, ballot: Ballot):
        super().__init__(txn_id, scope)
        self.ballot = ballot

    def apply(self, safe_store) -> "InvalidateReply":
        promised = C.preaccept_invalidate(safe_store, self.txn_id, self.ballot)
        cmd = safe_store.get(self.txn_id)
        # this replica could only have cast a fast-path vote if it witnessed
        # the txn at its original timestamp (BeginInvalidation.java:66)
        accepted_fast_path = (cmd.execute_at is not None
                              and cmd.execute_at == self.txn_id.as_timestamp())
        superseded_by = None if promised else cmd.promised
        return InvalidateReply(superseded_by, cmd.accepted_ballot,
                               cmd.save_status, accepted_fast_path, cmd.route)

    def reduce(self, a: "InvalidateReply", b: "InvalidateReply"
               ) -> "InvalidateReply":
        """Collapse per-store replies into one pan-node answer: the node
        promises only if every store promised (a single store's reject means
        a competing ballot is live on this node), fast-path accept only if
        every store witnessed at original (BeginInvalidation.java:72-85)."""
        is_ok = a.is_promised and b.is_promised
        superseded_by = None
        if not is_ok:
            cands = [r.superseded_by for r in (a, b)
                     if r.superseded_by is not None]
            superseded_by = max(cands) if cands else None
        hi = a if (a.status, a.accepted) >= (b.status, b.accepted) else b
        route = (a.route.with_(b.route) if a.route is not None
                 and b.route is not None else a.route or b.route)
        return InvalidateReply(superseded_by, hi.accepted, hi.status,
                               a.accepted_fast_path and b.accepted_fast_path,
                               route)

    def __repr__(self):
        return f"BeginInvalidation({self.txn_id!r}, b={self.ballot!r})"


class InvalidateReply(Reply):
    """BeginInvalidation.InvalidateReply."""

    type = MessageType.BEGIN_INVALIDATE_RSP

    __slots__ = ("superseded_by", "accepted", "status", "accepted_fast_path",
                 "route")

    def __init__(self, superseded_by: Optional[Ballot], accepted: Ballot,
                 status: SaveStatus, accepted_fast_path: bool,
                 route: Optional[Route]):
        self.superseded_by = superseded_by
        self.accepted = accepted
        self.status = status
        self.accepted_fast_path = accepted_fast_path
        self.route = route

    @property
    def is_promised(self) -> bool:
        return self.superseded_by is None

    @property
    def has_decision(self) -> bool:
        """The txn is decided — executeAt (or invalidation) is durable."""
        return self.status >= SaveStatus.PRE_COMMITTED

    def __repr__(self):
        tag = "Promised" if self.is_promised else f"NotPromised({self.superseded_by!r})"
        return f"InvalidateReply({tag}, {self.status.name})"

    @staticmethod
    def find_full_route(replies) -> Optional[Route]:
        for r in replies:
            if r.route is not None and r.route.is_full:
                return r.route
        return None

    @staticmethod
    def merge_routes(replies) -> Optional[Route]:
        merged: Optional[Route] = None
        for r in replies:
            if r.route is None:
                continue
            merged = r.route if merged is None else merged.with_(r.route)
        return merged

    @staticmethod
    def max(replies) -> "InvalidateReply":
        return max(replies, key=lambda r: (r.status, r.accepted))
