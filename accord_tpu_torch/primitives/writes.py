"""Writes: the applied effect set of a transaction (reference:
accord/primitives/Writes.java:32)."""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.api.data import Write
from accord_tpu_torch.primitives.keys import Keys, Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.utils.async_chains import AsyncResult, all_of, success


class Writes:
    __slots__ = ("txn_id", "execute_at", "keys", "write")

    def __init__(self, txn_id: TxnId, execute_at: Timestamp, keys: Keys,
                 write: Optional[Write]):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.keys = keys
        self.write = write

    @property
    def is_empty(self) -> bool:
        return self.write is None or not self.keys

    def apply(self, store, within: Ranges = None) -> AsyncResult[None]:
        """Apply per-key writes to the DataStore (chained async, Writes.apply)."""
        if self.is_empty:
            return success(None)
        keys = self.keys if within is None else self.keys.slice(within)
        pending = [self.write.apply(k, self.execute_at, store) for k in keys]
        if not pending:
            return success(None)
        return all_of(pending).map(lambda _: None)

    def slice(self, ranges: Ranges) -> "Writes":
        return Writes(self.txn_id, self.execute_at, self.keys.slice(ranges),
                      self.write)

    def merge(self, other: "Writes") -> "Writes":
        """Reunite per-shard slices (the `write` payload is the full effect
        object on every replica; only `keys` is sliced)."""
        if other is None or other.keys == self.keys:
            return self
        return Writes(self.txn_id, self.execute_at,
                      self.keys.with_(other.keys),
                      self.write if self.write is not None else other.write)

    def __repr__(self):
        return f"Writes({self.txn_id!r}@{self.execute_at!r}, {self.keys!r})"
