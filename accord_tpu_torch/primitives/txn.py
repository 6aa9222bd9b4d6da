"""Txn / PartialTxn: the transaction payload (reference: accord/primitives/Txn.java:267-411,
PartialTxn.java).

A Txn = kind + keys (or ranges) + data-plane ports (Read, Query, Update). The
protocol slices it to per-shard PartialTxns and drives read/execute through the
opaque ports.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.api.data import Data, Query, Read, Result, Update, Write
from accord_tpu_torch.primitives.keys import Keys, Ranges, Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TxnKind
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult, all_of, success


class Txn:
    __slots__ = ("kind", "keys", "read", "query", "update")

    def __init__(self, kind: TxnKind, keys, read: Optional[Read] = None,
                 query: Optional[Query] = None, update: Optional[Update] = None):
        self.kind = kind
        self.keys = keys  # Keys (key-domain) or Ranges (range-domain)
        self.read = read
        self.query = query
        self.update = update

    # -- shape queries --
    @property
    def is_key_domain(self) -> bool:
        return isinstance(self.keys, Keys)

    @property
    def is_write(self) -> bool:
        return self.kind.is_write

    def covering(self) -> Ranges:
        if isinstance(self.keys, Ranges):
            return self.keys
        return self.keys.to_ranges()

    # -- slicing (per-shard partials; Txn.slice) --
    def slice(self, ranges: Ranges, include_query: bool) -> "PartialTxn":
        keys = self.keys.slice(ranges)
        if keys is self.keys and include_query \
                and type(self) is PartialTxn:
            # fully covered (Keys.slice returns the same object): the
            # read/update key sets are subsets, so their slices are full
            # too — reuse the immutable whole.  (A full Txn must still
            # downgrade to a PartialTxn: callers merge partials via with_.)
            return self
        return PartialTxn(
            self.kind, keys,
            read=self.read.slice(ranges) if self.read is not None else None,
            query=self.query if include_query else None,
            update=self.update.slice(ranges) if self.update is not None else None,
        )

    def intersects(self, ranges: Ranges) -> bool:
        if isinstance(self.keys, Ranges):
            return self.keys.intersects(ranges)
        return self.keys.intersects_ranges(ranges)

    # -- execution (Txn.java read()/execute()/result()) --
    def read_data(self, execute_at: Timestamp, store, on_keys: Keys = None
                  ) -> AsyncResult[Optional[Data]]:
        """Execute the read over `on_keys` (default: read.keys()) against the
        host DataStore; merges per-key Data fragments."""
        if self.read is None:
            return success(None)
        keys = on_keys if on_keys is not None else self.read.keys()
        reads = [self.read.read(k, execute_at, store) for k in keys]
        if not reads:
            return success(None)

        def merge_all(datas):
            acc = None
            for d in datas:
                if d is None:
                    continue
                acc = d if acc is None else acc.merge(d)
            return acc

        return all_of(reads).map(merge_all)

    def execute(self, txn_id: TxnId, execute_at: Timestamp,
                data: Optional[Data]) -> "Writes":
        """Compute Writes from read Data via Update (Txn.execute)."""
        from accord_tpu_torch.primitives.writes import Writes
        if self.update is None:
            return Writes(txn_id, execute_at, Keys(()), None)
        write = self.update.apply(execute_at, data)
        return Writes(txn_id, execute_at, self.update.keys(), write)

    def result(self, txn_id: TxnId, execute_at: Timestamp,
               data: Optional[Data]) -> Result:
        invariants.non_null(self.query, "txn has no query")
        return self.query.compute(txn_id, execute_at, data, self.read, self.update)

    def __eq__(self, other):
        return (isinstance(other, Txn) and self.kind == other.kind
                and self.keys == other.keys and self.read == other.read
                and self.query == other.query and self.update == other.update)

    def __hash__(self):
        return hash((self.kind, self.keys))

    def __repr__(self):
        return f"Txn({self.kind.name}, {self.keys!r})"


class PartialTxn(Txn):
    """A Txn sliced to a shard's ranges (reference PartialTxn.java). Queries are
    retained only on the home shard's slice."""

    __slots__ = ()

    def covers(self, ranges: Ranges) -> bool:
        if isinstance(self.keys, Ranges):
            return self.keys.contains_all_ranges(ranges)
        # key-domain partial covers `ranges` iff it retains every key in them
        return True  # key slices retain exactly the keys in range; coverage checked at merge

    def with_(self, other: "PartialTxn") -> "PartialTxn":
        if self == other:
            return self
        keys = (self.keys.union(other.keys) if isinstance(self.keys, Ranges)
                else self.keys.with_(other.keys))
        return PartialTxn(
            self.kind, keys,
            read=(self.read.merge(other.read) if self.read and other.read
                  else self.read or other.read),
            query=self.query or other.query,
            update=(self.update.merge(other.update) if self.update and other.update
                    else self.update or other.update),
        )

    def reconstitute(self, route: Route) -> Txn:
        """Promote to a full Txn if this slice covers the whole route."""
        return Txn(self.kind, self.keys, self.read, self.query, self.update)
