"""PreAccept: witness a txn and vote on its executeAt (the fast-path round).

Reference: accord/messages/PreAccept.java:37 — per-shard Commands.preaccept +
calculatePartialDeps (:107-138, 245-266); cross-shard reduce merges max
witnessedAt + union deps (:141-156).
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn


class PreAcceptOk(Reply):
    type = MessageType.PRE_ACCEPT_RSP

    def __init__(self, txn_id: TxnId, witnessed_at: Timestamp, deps: Deps):
        self.txn_id = txn_id
        self.witnessed_at = witnessed_at
        self.deps = deps

    @property
    def is_fast_path_vote(self) -> bool:
        return self.witnessed_at == self.txn_id

    def __repr__(self):
        return f"PreAcceptOk({self.txn_id!r}@{self.witnessed_at!r})"


class PreAcceptNack(Reply):
    type = MessageType.PRE_ACCEPT_RSP

    def __repr__(self):
        return "PreAcceptNack"


class PreAccept(TxnRequest):
    type = MessageType.PRE_ACCEPT_REQ

    def __init__(self, txn_id: TxnId, partial_txn: PartialTxn, scope: Route,
                 max_epoch: int, full_route: Route = None):
        super().__init__(txn_id, scope, wait_for_epoch=max_epoch,
                         full_route=full_route)
        self.partial_txn = partial_txn
        self.max_epoch = max_epoch

    def apply(self, safe_store) -> Reply:
        outcome, witnessed_at = C.preaccept(
            safe_store, self.txn_id, self.partial_txn, self.route)
        if outcome in (C.AcceptOutcome.SUCCESS, C.AcceptOutcome.REDUNDANT):
            deps = C.calculate_deps(
                safe_store, self.txn_id, self.partial_txn.keys,
                before=self.txn_id)
            return PreAcceptOk(self.txn_id, witnessed_at, deps)
        return PreAcceptNack()

    def deps_probe(self):
        # Keys OR Ranges: the key tier serves Keys probes from the batched
        # CFK kernel; the range-stab tier (ops/range_kernel.py) serves the
        # range-command arm for both domains
        return (self.txn_id, self.txn_id.kind.witnesses(),
                self.partial_txn.keys)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        if isinstance(a, PreAcceptNack):
            return a
        if isinstance(b, PreAcceptNack):
            return b
        assert isinstance(a, PreAcceptOk) and isinstance(b, PreAcceptOk)
        return PreAcceptOk(self.txn_id,
                           Timestamp.max(a.witnessed_at, b.witnessed_at),
                           a.deps.with_(b.deps))

    def __repr__(self):
        return f"PreAccept({self.txn_id!r})"
