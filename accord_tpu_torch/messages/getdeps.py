"""GetDeps: standalone dependency collection.

Reference: accord/messages/GetDeps.java — calculates deps for `keys` bounded
by `before` (an executeAt), as the Accept round does; used by recovery
(CollectDeps) to fill deps for shards whose committed deps were unreachable,
and by sync points.
"""

from __future__ import annotations

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Key, Keys, Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class GetDepsOk(Reply):
    type = MessageType.GET_DEPS_RSP

    def __init__(self, deps: Deps):
        self.deps = deps

    def __repr__(self):
        return f"GetDepsOk({self.deps!r})"


class GetDeps(TxnRequest):
    type = MessageType.GET_DEPS_REQ

    def __init__(self, txn_id: TxnId, scope: Route, keys: Keys,
                 before: Timestamp):
        super().__init__(txn_id, scope)
        self.keys = keys
        self.before = before

    def deps_probe(self):
        return (self.before, self.txn_id.kind.witnesses(), self.keys)

    def apply(self, safe_store) -> Reply:
        deps = C.calculate_deps(safe_store, self.txn_id, self.keys,
                                before=self.before)
        return GetDepsOk(deps)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        return GetDepsOk(a.deps.with_(b.deps))

    def __repr__(self):
        return f"GetDeps({self.txn_id!r} before {self.before!r})"
