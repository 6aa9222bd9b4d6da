"""Commit / Stable: fix (executeAt, deps) — optionally piggybacking the read.

Reference: accord/messages/Commit.java:61 — Kinds CommitSlowPath/CommitMaximal/
StableFastPath/StableSlowPath/StableMaximal (:84-96); `stableAndRead`
piggybacks ReadTxnData onto Stable for read-set members (:175); inner
Commit.Invalidate.
"""

from __future__ import annotations

import enum
from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.messages.base import MessageType, Reply, Request, SimpleReply, TxnRequest
from accord_tpu_torch.messages.read import execute_read_when_ready
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.utils.async_chains import AsyncResult, success


class CommitKind(enum.Enum):
    COMMIT_SLOW_PATH = MessageType.COMMIT_SLOW_PATH_REQ
    COMMIT_MAXIMAL = MessageType.COMMIT_MAXIMAL_REQ
    STABLE_FAST_PATH = MessageType.STABLE_FAST_PATH_REQ
    STABLE_SLOW_PATH = MessageType.STABLE_SLOW_PATH_REQ
    STABLE_MAXIMAL = MessageType.STABLE_MAXIMAL_REQ

    @property
    def is_stable(self) -> bool:
        return self in (CommitKind.STABLE_FAST_PATH, CommitKind.STABLE_SLOW_PATH,
                        CommitKind.STABLE_MAXIMAL)


class Commit(TxnRequest):
    def __init__(self, kind: CommitKind, txn_id: TxnId, scope: Route,
                 partial_txn: Optional[PartialTxn], execute_at: Timestamp,
                 deps: Deps, read_keys: Optional[Keys] = None,
                 full_route: Route = None):
        super().__init__(txn_id, scope, wait_for_epoch=execute_at.epoch,
                         full_route=full_route)
        self.kind = kind
        self.type = kind.value
        self.partial_txn = partial_txn
        self.execute_at = execute_at
        self.deps = deps
        self.read_keys = read_keys  # non-None: stableAndRead piggyback

    def apply(self, safe_store):
        outcome = C.commit(
            safe_store, self.txn_id, self.route, self.partial_txn,
            self.execute_at, self.deps.slice(safe_store.ranges)
            if not safe_store.ranges.is_empty else self.deps,
            stable=self.kind.is_stable)
        if outcome == C.AcceptOutcome.TRUNCATED:
            return SimpleReply(SimpleReply.NACK)
        if self.read_keys is not None and self.kind.is_stable:
            return execute_read_when_ready(safe_store, self.txn_id,
                                           self.read_keys)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        from accord_tpu_torch.messages.read import ReadNack, ReadOk
        if isinstance(a, ReadNack):
            return a
        if isinstance(b, ReadNack):
            return b
        if isinstance(a, ReadOk) and isinstance(b, ReadOk):
            return a.merge(b)
        if isinstance(a, ReadOk):
            return a
        if isinstance(b, ReadOk):
            return b
        if isinstance(a, SimpleReply) and a.outcome == SimpleReply.NACK:
            return a
        return b

    def __repr__(self):
        return f"Commit({self.kind.name}, {self.txn_id!r}@{self.execute_at!r})"


class CommitInvalidate(TxnRequest):
    type = MessageType.COMMIT_INVALIDATE_REQ

    def __init__(self, txn_id: TxnId, scope: Route):
        super().__init__(txn_id, scope)

    def apply(self, safe_store):
        C.commit_invalidate(safe_store, self.txn_id)
        return SimpleReply(SimpleReply.OK)

    def reduce(self, a, b):
        return b
