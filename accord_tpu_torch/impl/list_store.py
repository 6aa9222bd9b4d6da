"""Append-only list-register data plane — the reference workload implementation.

Reference: the maelstrom data plane (accord-maelstrom Maelstrom{Read,Write,
Update,Query,Result,Data}, Datum.java:30, MaelstromUpdate.java:40-47): a
multi-key KV where each key holds an append-only list of ints; reads return
the list, updates append. This is the workload the burn test's strict
serializability verifier checks (monotonic per-key append sequences).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.api.data import Data, Query, Read, Result, Update, Write
from accord_tpu_torch.api.spi import DataStore
from accord_tpu_torch.primitives.keys import Key, Keys, Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.utils.async_chains import AsyncResult, success


class ListStore(DataStore):
    """key -> executeAt-ordered list of (timestamp, value) appends.

    Values carry their executeAt so replay is exactly idempotent and
    bootstrap snapshots MERGE rather than replace: a rejoining replica that
    missed one mid-history write still heals it even when its latest write
    matches the source's (a last-timestamp guard would skip the whole key
    and silently lose the gap)."""

    def __init__(self, node_id: int = 0):
        self.node_id = node_id
        self.data: Dict[Key, List[Tuple[Timestamp, int]]] = {}

    def get(self, key: Key) -> Tuple[int, ...]:
        return tuple(v for _, v in self.data.get(key, ()))

    def append(self, key: Key, value: int, at: Timestamp) -> None:
        entries = self.data.setdefault(key, [])
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if entries[mid][0] < at:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(entries) and entries[lo][0] == at:
            return  # replay
        entries.insert(lo, (at, value))

    def keys_in(self, ranges: Ranges) -> List[Key]:
        """Data keys present within `ranges` (range-scan support; the
        reference's maelstrom store is a sorted TreeMap serving the same
        query, MaelstromStore)."""
        return sorted(k for k in self.data if ranges.contains(k))

    def snapshot(self) -> Dict[int, Tuple[int, ...]]:
        return {k.token: self.get(k) for k in self.data}

    # -- bootstrap snapshot transfer --
    def snapshot_ranges(self, ranges: Ranges):
        return {k: tuple(self.data[k]) for k in self.keys_in(ranges)}

    def install_snapshot(self, snapshot) -> None:
        for k, entries in snapshot.items():
            for at, value in entries:
                self.append(k, value, at)


class ListData(Data):
    def __init__(self, values: Dict[Key, Tuple[int, ...]]):
        self.values = dict(values)

    def merge(self, other: "Data") -> "Data":
        merged = dict(self.values)
        merged.update(other.values)  # type: ignore[attr-defined]
        return ListData(merged)

    def __eq__(self, other):
        return isinstance(other, ListData) and self.values == other.values

    def __repr__(self):
        return f"ListData({ {k.token: v for k, v in self.values.items()} })"


class ListRead(Read):
    def __init__(self, keys: Keys):
        self._keys = keys

    def keys(self) -> Keys:
        return self._keys

    def read(self, key: Key, execute_at: Timestamp, store: ListStore
             ) -> AsyncResult[Data]:
        return success(ListData({key: store.get(key)}))

    def slice(self, ranges: Ranges) -> "ListRead":
        return ListRead(self._keys.slice(ranges))

    def merge(self, other: "ListRead") -> "ListRead":
        return ListRead(self._keys.with_(other._keys))

    def __eq__(self, other):
        return isinstance(other, ListRead) and self._keys == other._keys

    def __repr__(self):
        return f"ListRead({self._keys!r})"


class ListRangeRead(Read):
    """Range-domain read: scans every key present in the ranges at execute
    time (the reference's range queries through the same Read port — Read.java
    read(Seekable, ...) where the Seekable is a Range)."""

    def __init__(self, ranges: Ranges):
        self._ranges = ranges

    def keys(self) -> Ranges:
        return self._ranges

    def read(self, rng, execute_at: Timestamp, store: ListStore
             ) -> AsyncResult[Data]:
        covered = Ranges([rng]) if not isinstance(rng, Ranges) else rng
        return success(ListData({k: store.get(k)
                                 for k in store.keys_in(covered)}))

    def slice(self, ranges: Ranges) -> "ListRangeRead":
        return ListRangeRead(self._ranges.slice(ranges))

    def merge(self, other: "ListRangeRead") -> "ListRangeRead":
        return ListRangeRead(self._ranges.union(other._ranges))

    def __eq__(self, other):
        return isinstance(other, ListRangeRead) and self._ranges == other._ranges

    def __repr__(self):
        return f"ListRangeRead({self._ranges!r})"


class ListWrite(Write):
    def __init__(self, appends: Dict[Key, int]):
        self.appends = dict(appends)

    def apply(self, key: Key, execute_at: Timestamp, store: ListStore
              ) -> AsyncResult[None]:
        if key in self.appends:
            store.append(key, self.appends[key], execute_at)
        return success(None)

    def __repr__(self):
        return f"ListWrite({ {k.token: v for k, v in self.appends.items()} })"


class ListUpdate(Update):
    def __init__(self, appends: Dict[Key, int]):
        self.appends = dict(appends)

    def keys(self) -> Keys:
        return Keys(self.appends.keys())

    def apply(self, execute_at: Timestamp, data: Optional[Data]) -> Write:
        return ListWrite(self.appends)

    def slice(self, ranges: Ranges) -> "ListUpdate":
        return ListUpdate({k: v for k, v in self.appends.items()
                           if ranges.contains(k)})

    def merge(self, other: "ListUpdate") -> "ListUpdate":
        merged = dict(self.appends)
        merged.update(other.appends)
        return ListUpdate(merged)

    def __eq__(self, other):
        return isinstance(other, ListUpdate) and self.appends == other.appends

    def __repr__(self):
        return f"ListUpdate({ {k.token: v for k, v in self.appends.items()} })"


class ListResult(Result):
    def __init__(self, txn_id: TxnId, execute_at: Timestamp,
                 read_values: Dict[Key, Tuple[int, ...]],
                 appends: Dict[Key, int]):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.read_values = dict(read_values)
        self.appends = dict(appends)

    def __eq__(self, other):
        return (isinstance(other, ListResult) and self.txn_id == other.txn_id
                and self.read_values == other.read_values
                and self.appends == other.appends)

    def __repr__(self):
        return (f"ListResult({self.txn_id!r}: "
                f"read={ {k.token: v for k, v in self.read_values.items()} }, "
                f"appended={ {k.token: v for k, v in self.appends.items()} })")


class ListQuery(Query):
    def __eq__(self, other):
        return isinstance(other, ListQuery)  # stateless

    def __hash__(self):
        return hash(ListQuery)

    def compute(self, txn_id: TxnId, execute_at: Timestamp,
                data: Optional[Data], read: Optional[Read],
                update: Optional[Update]) -> Result:
        values = data.values if isinstance(data, ListData) else {}
        appends = update.appends if isinstance(update, ListUpdate) else {}
        return ListResult(txn_id, execute_at, values, appends)
