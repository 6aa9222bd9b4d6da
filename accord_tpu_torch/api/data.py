"""Opaque transaction data plane — the query-language ports.

Reference: accord/api/Read.java:31, Update.java:32, Query.java:31, Write.java,
Data.java, Result.java. The protocol never inspects these; it only sequences
them. Hosts provide concrete implementations (see accord_tpu_torch.impl.list_store
for the reference append-register implementation used by tests/maelstrom).
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Optional

from accord_tpu_torch.utils.async_chains import AsyncResult

if TYPE_CHECKING:
    from accord_tpu_torch.primitives.keys import Key, Keys, Ranges
    from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class Data(abc.ABC):
    """Result fragment of reads; mergeable across keys/shards (Data.merge)."""

    @abc.abstractmethod
    def merge(self, other: "Data") -> "Data":
        ...


class Read(abc.ABC):
    """Per-key async read of the data store at an execution timestamp."""

    @abc.abstractmethod
    def keys(self) -> "Keys":
        ...

    @abc.abstractmethod
    def read(self, key: "Key", execute_at: "Timestamp", store) -> AsyncResult[Data]:
        """Read one key; `store` is the host DataStore."""

    @abc.abstractmethod
    def slice(self, ranges: "Ranges") -> "Read":
        ...

    @abc.abstractmethod
    def merge(self, other: "Read") -> "Read":
        ...


class Write(abc.ABC):
    """Computed effects of an update, applied per key at executeAt."""

    @abc.abstractmethod
    def apply(self, key: "Key", execute_at: "Timestamp", store) -> AsyncResult[None]:
        ...


class Update(abc.ABC):
    """The write intent: given read Data, produce a Write (Update.apply)."""

    @abc.abstractmethod
    def keys(self) -> "Keys":
        ...

    @abc.abstractmethod
    def apply(self, execute_at: "Timestamp", data: Optional[Data]) -> Write:
        ...

    @abc.abstractmethod
    def slice(self, ranges: "Ranges") -> "Update":
        ...

    @abc.abstractmethod
    def merge(self, other: "Update") -> "Update":
        ...


class Query(abc.ABC):
    """Computes the client-visible Result from read Data (Query.compute)."""

    @abc.abstractmethod
    def compute(self, txn_id: "TxnId", execute_at: "Timestamp",
                data: Optional[Data], read: Optional[Read],
                update: Optional[Update]) -> "Result":
        ...


class Result(abc.ABC):
    """Opaque client-visible outcome."""
