"""Ephemeral reads: the single-round, never-witnessed read path.

Reference: accord/messages/GetEphemeralReadDeps.java (collect the write deps
an invisible read must wait for) and ReadData.java's ReadEphemeralTxnData
variant (wait for the supplied deps to apply locally, then read). The txn is
never recorded as a Command anywhere — EphemeralRead witnesses writes but is
witnessed by nothing (Txn.Kind matrix, Txn.java:220-260) — so there is no
recovery; the coordinator simply retries elsewhere on timeout.
"""

from __future__ import annotations

from typing import List, Optional, Set

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.local.command import TransientListener
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.messages.read import ReadNack, ReadOk
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Keys, Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.utils.async_chains import AsyncResult


class GetEphemeralReadDepsOk(Reply):
    type = MessageType.GET_EPHEMERAL_READ_DEPS_RSP

    def __init__(self, deps: Deps, latest_epoch: int):
        self.deps = deps
        self.latest_epoch = latest_epoch

    def __repr__(self):
        return f"GetEphemeralReadDepsOk({self.deps!r}, epoch={self.latest_epoch})"


class GetEphemeralReadDeps(TxnRequest):
    """Collect every active write the read must order itself after
    (GetEphemeralReadDeps.java: unbounded `before` — the read has no
    executeAt of its own)."""

    type = MessageType.GET_EPHEMERAL_READ_DEPS_REQ

    def __init__(self, txn_id: TxnId, scope: Route, keys: Keys):
        super().__init__(txn_id, scope)
        self.keys = keys

    def deps_probe(self):
        return (Timestamp.max_value(), self.txn_id.kind.witnesses(),
                self.keys)

    def apply(self, safe_store) -> Reply:
        deps = C.calculate_deps(safe_store, self.txn_id, self.keys,
                                before=Timestamp.max_value())
        return GetEphemeralReadDepsOk(deps, safe_store.node.epoch)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        return GetEphemeralReadDepsOk(a.deps.with_(b.deps),
                                      max(a.latest_epoch, b.latest_epoch))

    def __repr__(self):
        return f"GetEphemeralReadDeps({self.txn_id!r})"


class _DepsAppliedWaiter(TransientListener):
    """Fires `on_ready` once every dep command is applied / invalidated /
    truncated locally (the ephemeral analogue of WaitingOn, without a
    Command record to hang it on)."""

    def __init__(self, safe_store, dep_ids: List[TxnId], on_ready,
                 deps: "Deps" = None):
        # on_ready(safe_store) receives the safe store of the task it FIRES
        # in — a deferred fire happens in a later store task, and using the
        # arming task's (released) safe store is a leak the Debug store
        # variant rejects
        self.on_ready = on_ready
        self.pending: Set[TxnId] = set()
        self.fired = False
        # deps this wait created empty NOT_DEFINED records for — removed
        # again once the wait resolves, so the store is not polluted by
        # commands that exist purely to hang a listener on
        self.created: Set[TxnId] = set()
        for dep_id in dep_ids:
            existing = safe_store.if_present(dep_id)
            cmd = existing if existing is not None else safe_store.get(dep_id)
            if not self._cleared(safe_store, cmd):
                if existing is None:
                    self.created.add(dep_id)
                self.pending.add(dep_id)
                cmd.add_transient_listener(self)
                # a dep this replica hasn't committed/applied may never
                # arrive on its own (the Apply could be lost): register a
                # progress-log chase so the missing state is fetched rather
                # than the read hanging until the coordinator times out
                # (the reference ReadData registers the same waiting intent)
                if not cmd.has_been(SaveStatus.PRE_APPLIED):
                    participants = None
                    if deps is not None:
                        key_parts, range_parts = deps.participants(dep_id)
                        participants = key_parts if len(key_parts) > 0 \
                            else range_parts
                    safe_store.progress_log.waiting(
                        dep_id, safe_store.store, "Applied", cmd.route,
                        participants)
        if not self.pending:
            self.fired = True
            on_ready(safe_store)

    @staticmethod
    def _cleared(safe_store, cmd) -> bool:
        if cmd.is_applied_or_gone or cmd.is_truncated:
            return True
        rb = safe_store.store.redundant_before
        if cmd.route is not None and cmd.route.is_key_domain:
            parts = cmd.route.participants()
            if len(parts) > 0 and all(rb.is_redundant(cmd.txn_id, k)
                                      for k in parts):
                return True
        return False

    def on_change(self, safe_store, command) -> None:
        if self.fired or command.txn_id not in self.pending:
            return
        if self._cleared(safe_store, command):
            self.pending.discard(command.txn_id)
            command.remove_transient_listener(self)
            self._maybe_drop_created(safe_store, command)
            if not self.pending:
                self.fired = True
                self.on_ready(safe_store)

    def _maybe_drop_created(self, safe_store, command) -> None:
        """Remove a record that exists purely because this wait created it:
        still NOT_DEFINED (it cleared via truncation/redundancy watermarks,
        not by progressing) and nothing else is listening."""
        if command.txn_id in self.created \
                and command.save_status == SaveStatus.NOT_DEFINED \
                and not command.transient_listeners \
                and not command.listeners:
            safe_store.store.commands.pop(command.txn_id, None)
            # the chase existed for this wait; the store forgot the record,
            # so stop fetching it too
            safe_store.progress_log.clear(command.txn_id)


def wait_for_deps_applied(safe_store, deps: Deps, on_ready) -> None:
    """Arrange `on_ready(live_safe_store)` once every locally-owned dep in
    `deps` has applied — the callback receives the safe store of the task it
    fires in (deferred fires happen in later store tasks)."""
    local = deps.slice(safe_store.ranges) if not safe_store.ranges.is_empty \
        else deps
    _DepsAppliedWaiter(safe_store, local.sorted_txn_ids(), on_ready,
                       deps=local)


class ReadEphemeralTxnData(TxnRequest):
    """Execute the read once `deps` have applied locally
    (READ_EPHEMERAL_REQ; ReadData.java ReadEphemeralTxnData)."""

    type = MessageType.READ_EPHEMERAL_REQ

    def __init__(self, txn_id: TxnId, scope: Route, read_keys: Keys,
                 partial_txn: PartialTxn, deps: Deps, execute_at_epoch: int):
        super().__init__(txn_id, scope, wait_for_epoch=execute_at_epoch)
        self.read_keys = read_keys
        self.partial_txn = partial_txn
        self.deps = deps

    def apply(self, safe_store):
        result: AsyncResult = AsyncResult()
        txn = self.partial_txn
        owned = self.read_keys.slice(safe_store.ranges) \
            if not safe_store.ranges.is_empty else self.read_keys
        if txn.read is None or not owned:
            return ReadOk(None)
        if not safe_store.is_safe_to_read(owned):
            return ReadNack(ReadNack.UNAVAILABLE)

        def do_read(live_safe_store):
            # read "now": the snapshot after every collected write dep — the
            # read mints no timestamp of its own (it is invisible).  Uses
            # the FIRING task's safe store: the arming one is released.
            txn.read_data(live_safe_store.time_now(),
                          live_safe_store.data_store,
                          on_keys=owned).add_callback(
                lambda data, failure: result.try_failure(failure)
                if failure is not None else result.try_success(ReadOk(data)))

        wait_for_deps_applied(safe_store, self.deps, do_read)
        return result

    def reduce(self, a, b):
        if isinstance(a, ReadNack):
            return a
        if isinstance(b, ReadNack):
            return b
        return a.merge(b)

    def __repr__(self):
        return f"ReadEphemeralTxnData({self.txn_id!r})"
