"""The execution-epoch read path.

Reference: accord/messages/ReadData.java:52-370 — registers as a transient
listener on the command until ReadyToExecute/Applied, then executes txn.read
against the DataStore and replies ReadOk{data, unavailable}; obsolescence
handling via commit/invalidate transitions.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.api.data import Data
from accord_tpu_torch.local.command import Command, TransientListener
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.keys import Keys, Ranges, Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.utils.async_chains import AsyncResult


class ReadOk(Reply):
    type = MessageType.READ_RSP

    def __init__(self, data: Optional[Data], unavailable: Optional[Ranges] = None):
        self.data = data
        self.unavailable = unavailable

    def merge(self, other: "ReadOk") -> "ReadOk":
        data = (self.data.merge(other.data)
                if self.data is not None and other.data is not None
                else self.data or other.data)
        unavailable = self.unavailable or other.unavailable
        return ReadOk(data, unavailable)

    def __repr__(self):
        return f"ReadOk({self.data!r})"


class ReadNack(Reply):
    type = MessageType.READ_RSP

    INVALID = "Invalid"       # command invalidated
    REDUNDANT = "Redundant"   # already applied/truncated elsewhere
    NOT_COMMITTED = "NotCommitted"
    UNAVAILABLE = "Unavailable"  # data not yet bootstrapped locally

    def __init__(self, reason: str):
        self.reason = reason

    def __repr__(self):
        return f"ReadNack({self.reason})"


class _ReadWhenReady(TransientListener):
    """Wait for ReadyToExecute (deps applied), then read at executeAt."""

    def __init__(self, safe_store, txn_id: TxnId, keys: Keys,
                 result: AsyncResult):
        self.txn_id = txn_id
        self.keys = keys
        self.result = result
        self.done = False

    def on_change(self, safe_store, command: Command) -> None:
        self.maybe_read(safe_store, command)

    def maybe_read(self, safe_store, command: Command) -> None:
        if self.done:
            return
        status = command.save_status
        if status == SaveStatus.INVALIDATED:
            self._finish(command, ReadNack(ReadNack.INVALID))
        elif status.is_truncated or status >= SaveStatus.PRE_APPLIED:
            # obsolete: the outcome is already known (possibly applied) — the
            # pre-write snapshot no longer exists here (ReadData.java
            # obsolescence; reading post-apply state would violate
            # serializability)
            self._finish(command, ReadNack(ReadNack.REDUNDANT))
        elif status == SaveStatus.READY_TO_EXECUTE:
            self._do_read(safe_store, command)

    def _do_read(self, safe_store, command: Command) -> None:
        txn = command.partial_txn
        owned = self.keys.slice(safe_store.ranges) \
            if not safe_store.ranges.is_empty else self.keys
        if txn is None or txn.read is None or not owned:
            self._finish(command, ReadOk(None))
            return
        if not safe_store.is_safe_to_read(owned):
            self._finish(command, ReadNack(ReadNack.UNAVAILABLE))
            return
        from accord_tpu_torch.local.watermarks import PreBootstrapOrStale
        if safe_store.store.redundant_before.pre_bootstrap_or_stale(
                self.txn_id, owned) != PreBootstrapOrStale.POST_BOOTSTRAP:
            # our bootstrap snapshot may already embed this txn's own writes
            # (and its successors'): the pre-execution snapshot no longer
            # exists here — another replica must serve it
            self._finish(command, ReadNack(ReadNack.UNAVAILABLE))
            return
        self.done = True
        command.remove_transient_listener(self)
        txn.read_data(command.execute_at, safe_store.data_store,
                      on_keys=owned).add_callback(
            lambda data, failure: self.result.try_failure(failure)
            if failure is not None else self.result.try_success(ReadOk(data)))

    def _finish(self, command: Command, reply: Reply) -> None:
        self.done = True
        command.remove_transient_listener(self)
        self.result.try_success(reply)


def execute_read_when_ready(safe_store, txn_id: TxnId, keys: Keys
                            ) -> AsyncResult:
    """Arrange for the local read of `keys` once txn is ready; returns
    AsyncResult[ReadOk|ReadNack]."""
    result: AsyncResult = AsyncResult()
    command = safe_store.get(txn_id)
    listener = _ReadWhenReady(safe_store, txn_id, keys, result)
    command.add_transient_listener(listener)
    listener.maybe_read(safe_store, command)
    return result


class ReadTxnData(TxnRequest):
    """Standalone read request (READ_REQ): used when the read set differs from
    the stable set or on retry (ReadData.java / ReadTxnData)."""

    type = MessageType.READ_REQ

    def __init__(self, txn_id: TxnId, scope: Route, read_keys: Keys,
                 execute_at_epoch: int):
        super().__init__(txn_id, scope, wait_for_epoch=execute_at_epoch)
        self.read_keys = read_keys

    def apply(self, safe_store):
        command = safe_store.get(self.txn_id)
        if not command.has_been(SaveStatus.STABLE):
            return ReadNack(ReadNack.NOT_COMMITTED)
        return execute_read_when_ready(safe_store, self.txn_id, self.read_keys)

    def reduce(self, a, b):
        if isinstance(a, ReadNack):
            return a
        if isinstance(b, ReadNack):
            return b
        return a.merge(b)
