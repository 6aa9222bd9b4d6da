"""Durability gossip verbs.

Reference: accord/messages/InformDurable.java, SetShardDurable.java,
SetGloballyDurable.java, QueryDurableBefore.java, InformOfTxnId.java —
distribute per-txn durability class and the DurableBefore watermarks that
license truncation (SURVEY.md §2.4 registry).
"""

from __future__ import annotations

from typing import Optional, Tuple

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.local.status import Durability
from accord_tpu_torch.messages.base import (MessageType, Reply, Request,
                                      SimpleReply, TxnRequest)
from accord_tpu_torch.primitives.keys import Ranges, Route
from accord_tpu_torch.primitives.timestamp import TxnId, TXNID_NONE


class InformDurable(TxnRequest):
    """Mark a txn's durability class on its participants
    (InformDurable.java; sent by the Persist tail once a quorum per shard
    acked Apply)."""

    type = MessageType.INFORM_DURABLE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, durability: Durability):
        super().__init__(txn_id, scope)
        self.durability = durability

    def apply(self, safe_store) -> Reply:
        C.set_durability(safe_store, self.txn_id, self.durability)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return f"InformDurable({self.txn_id!r}, {self.durability.name})"


class InformHomeDurable(TxnRequest):
    """Tell the HOME shard a txn is durable so its progress-log monitor
    stands down without waiting to observe durability itself (reference
    accord/messages/InformHomeDurable.java:30: set the durability class at
    the home key's store, skipping truncated commands).  Sent by a
    non-home replica whose blocked-state chase learns a durable outcome
    (impl/progress_log.py) — the home-specific short-circuit on top of the
    participant-wide InformDurable the Persist tail broadcasts."""

    type = MessageType.INFORM_HOME_DURABLE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, execute_at,
                 durability: Durability):
        super().__init__(txn_id, scope)
        self.execute_at = execute_at
        self.durability = durability

    def apply(self, safe_store) -> Reply:
        cmd = safe_store.get(self.txn_id)
        if cmd.is_truncated:
            return SimpleReply(SimpleReply.OK)
        C.set_durability(safe_store, self.txn_id, self.durability)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return f"InformHomeDurable({self.txn_id!r}, {self.durability.name})"


class InformOfTxnId(TxnRequest):
    """Make sure the home shard knows a txn exists, so its progress log
    monitors it (InformOfTxnId.java / InformHomeOfTxn)."""

    type = MessageType.INFORM_OF_TXN_REQ

    def __init__(self, txn_id: TxnId, scope: Route):
        super().__init__(txn_id, scope)

    def apply(self, safe_store) -> Reply:
        cmd = safe_store.get(self.txn_id)
        cmd.update_route(self.route)
        safe_store.progress_log.update(safe_store.store, self.txn_id, cmd)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return f"InformOfTxnId({self.txn_id!r})"


class SetShardDurable(TxnRequest):
    """An exclusive sync point's fence is durable: everything on its ranges
    below it is decided+applied at (majority | every) replica — advance the
    DurableBefore watermark and sweep (SetShardDurable.java)."""

    type = MessageType.SET_SHARD_DURABLE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, ranges: Ranges,
                 universal: bool):
        super().__init__(txn_id, scope)
        self.ranges = ranges
        self.universal = universal

    def apply(self, safe_store) -> Reply:
        from accord_tpu_torch.local import cleanup
        store = safe_store.store
        owned = self.ranges.slice(store.ranges) \
            if not store.ranges.is_empty else self.ranges
        if self.universal:
            store.durable_before.update(owned, self.txn_id, self.txn_id)
            # every replica applied the fence: undecided stragglers below it
            # can never commit — poison them (shardAppliedBefore gating)
            store.redundant_before.update_shard_applied(owned, self.txn_id)
        else:
            store.durable_before.update(owned, self.txn_id)
        cleanup.sweep(store)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return (f"SetShardDurable({self.txn_id!r} over {self.ranges!r}, "
                f"universal={self.universal})")


class QueryDurableBeforeOk(Reply):
    type = MessageType.QUERY_DURABLE_BEFORE_RSP

    def __init__(self, majority: TxnId, universal: TxnId):
        self.majority = majority
        self.universal = universal

    def __repr__(self):
        return f"QueryDurableBeforeOk(maj<{self.majority!r}, uni<{self.universal!r})"


class QueryDurableBefore(TxnRequest):
    """Report this node's floor DurableBefore bounds over `ranges`
    (QueryDurableBefore.java; min-merged by CoordinateGloballyDurable)."""

    type = MessageType.QUERY_DURABLE_BEFORE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, ranges: Ranges):
        super().__init__(txn_id, scope)
        self.ranges = ranges

    def apply(self, safe_store) -> Reply:
        store = safe_store.store
        owned = self.ranges.slice(store.ranges) \
            if not store.ranges.is_empty else self.ranges
        if owned.is_empty:
            return QueryDurableBeforeOk(TXNID_NONE, TXNID_NONE)
        maj, uni = store.durable_before.min_bounds(owned)
        return QueryDurableBeforeOk(maj, uni)

    def reduce(self, a: QueryDurableBeforeOk, b: QueryDurableBeforeOk):
        return QueryDurableBeforeOk(min(a.majority, b.majority),
                                    min(a.universal, b.universal))

    def __repr__(self):
        return f"QueryDurableBefore({self.ranges!r})"


class SetGloballyDurable(TxnRequest):
    """Adopt a globally min-merged DurableBefore over `ranges`
    (SetGloballyDurable.java) — licenses ERASE."""

    type = MessageType.SET_GLOBALLY_DURABLE_REQ

    def __init__(self, txn_id: TxnId, scope: Route, ranges: Ranges,
                 majority: TxnId, universal: TxnId):
        super().__init__(txn_id, scope)
        self.ranges = ranges
        self.majority = majority
        self.universal = universal

    def apply(self, safe_store) -> Reply:
        from accord_tpu_torch.local import cleanup
        store = safe_store.store
        owned = self.ranges.slice(store.ranges) \
            if not store.ranges.is_empty else self.ranges
        if not owned.is_empty and (self.majority > TXNID_NONE
                                   or self.universal > TXNID_NONE):
            store.durable_before.update(owned, self.majority, self.universal)
            cleanup.sweep(store)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return a

    def __repr__(self):
        return f"SetGloballyDurable({self.ranges!r} maj<{self.majority!r})"
