"""GetMaxConflict: query the highest conflicting timestamp over a selection.

Reference: accord/messages/GetMaxConflict.java — a txn-less TxnRequest that
map-reduces `MaxConflicts` over the receiving node's command stores and
reports the store's view of the latest epoch, so the coordinator
(coordinate/fetch.fetch_max_conflict, reference FetchMaxConflict.java) can
chase topology changes that race with the query.
"""

from __future__ import annotations

from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import NONE as TS_NONE
from accord_tpu_torch.primitives.timestamp import TXNID_NONE, Timestamp


class GetMaxConflict(TxnRequest):
    """Ask each replica for max(MaxConflicts) over `participants`
    (GetMaxConflict.java:35-85)."""

    type = MessageType.GET_MAX_CONFLICT_REQ

    def __init__(self, scope: Route, participants, execution_epoch: int):
        super().__init__(TXNID_NONE, scope, wait_for_epoch=execution_epoch,
                         min_epoch=execution_epoch)
        # Keys or Ranges, pre-sliced to the destination's scope
        self.query_participants = participants
        self.execution_epoch = execution_epoch

    def apply(self, safe_store) -> "GetMaxConflictOk":
        mc = safe_store.max_conflict(self.query_participants)
        return GetMaxConflictOk(mc if mc is not None else TS_NONE,
                                max(safe_store.node.epoch,
                                    self.execution_epoch))

    def reduce(self, a: "GetMaxConflictOk", b: "GetMaxConflictOk"
               ) -> "GetMaxConflictOk":
        return GetMaxConflictOk(max(a.max_conflict, b.max_conflict),
                                max(a.latest_epoch, b.latest_epoch))

    def __repr__(self):
        return (f"GetMaxConflict({self.query_participants!r}, "
                f"epoch={self.execution_epoch})")


class GetMaxConflictOk(Reply):
    type = MessageType.GET_MAX_CONFLICT_RSP

    __slots__ = ("max_conflict", "latest_epoch")

    def __init__(self, max_conflict: Timestamp, latest_epoch: int):
        self.max_conflict = max_conflict
        self.latest_epoch = latest_epoch

    def __repr__(self):
        return f"GetMaxConflictOk({self.max_conflict!r}, e={self.latest_epoch})"
