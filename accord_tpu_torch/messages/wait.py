"""WaitOnCommit: block until a txn is committed locally, then ack.

Reference: accord/messages/WaitOnCommit.java — registers a listener until the
command reaches Committed (or is invalidated/truncated), nudging the progress
log so the replica itself chases the missing commit. Used by recovery to await
`earlierAcceptedNoWitness` transactions before deciphering the fast path.
"""

from __future__ import annotations

from accord_tpu_torch.local.command import Command, TransientListener
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.base import MessageType, SimpleReply, TxnRequest
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils.async_chains import AsyncResult


class _NotifyOnCommit(TransientListener):
    def __init__(self, result: AsyncResult):
        self.result = result
        self.done = False

    def on_change(self, safe_store, command: Command) -> None:
        self.maybe_fire(command)

    def maybe_fire(self, command: Command) -> None:
        if self.done:
            return
        if command.has_been(SaveStatus.COMMITTED) or command.is_invalidated \
                or command.is_truncated:
            self.done = True
            command.remove_transient_listener(self)
            self.result.try_success(SimpleReply(SimpleReply.OK))


def await_applied(safe_store, txn_id: TxnId, participants, reply):
    """Shared wait tail: resolve with `reply` once txn_id has APPLIED
    locally, nudging the progress log if it isn't even STABLE yet.  Used
    by WaitUntilApplied and the fused ApplyThenWaitUntilApplied."""
    from accord_tpu_torch.local.command import OnAppliedListener
    command = safe_store.get(txn_id)
    result: AsyncResult = AsyncResult()
    listener = OnAppliedListener.arm(
        command, lambda c: result.try_success(reply))
    if not listener.fired and not command.has_been(SaveStatus.STABLE):
        safe_store.progress_log.waiting(
            txn_id, safe_store.store, "Applied", command.route, participants)
    return result


class WaitUntilApplied(TxnRequest):
    """Block until the txn has applied locally, then ack
    (accord/messages/WaitUntilApplied — WAIT_UNTIL_APPLIED_REQ). Used by
    durability rounds to confirm a sync point's dependencies drained on this
    replica."""

    type = MessageType.WAIT_UNTIL_APPLIED_REQ

    def __init__(self, txn_id: TxnId, scope: Route):
        super().__init__(txn_id, scope)

    def apply(self, safe_store):
        return await_applied(safe_store, self.txn_id,
                             self.scope.participants(),
                             SimpleReply(SimpleReply.OK))

    def reduce(self, a, b):
        return b

    def __repr__(self):
        return f"WaitUntilApplied({self.txn_id!r})"


class WaitOnCommit(TxnRequest):
    type = MessageType.WAIT_ON_COMMIT_REQ

    def __init__(self, txn_id: TxnId, scope: Route):
        super().__init__(txn_id, scope)

    def apply(self, safe_store):
        command = safe_store.get(self.txn_id)
        result: AsyncResult = AsyncResult()
        listener = _NotifyOnCommit(result)
        command.add_transient_listener(listener)
        listener.maybe_fire(command)
        if not listener.done:
            # chase the commit: the progress log fetches/recovers it
            safe_store.progress_log.waiting(
                self.txn_id, safe_store.store, "Committed", command.route,
                self.scope.participants())
        return result

    def reduce(self, a, b):
        return b

    def __repr__(self):
        return f"WaitOnCommit({self.txn_id!r})"
