"""Command: one transaction's replica-local record, and WaitingOn — the
execution-order resolver state.

Reference: accord/local/Command.java (record hierarchy :681-1216, WaitingOn
:1294-1643, listeners :72-90). The reference uses immutable records swapped
via SafeCommand; our stores are single-threaded (enforced by CommandStore), so
Command is a mutable record whose every transition flows through the static
functions in accord_tpu_torch.local.commands — the moral equivalent of the
reference's update() chain, with the same transition invariants.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from accord_tpu_torch.local.status import Durability, Known, SaveStatus
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.bitset import SimpleBitSet
from accord_tpu_torch.utils.sorted_arrays import find_ceil

# flight-recorder hook: local.store rebinds this to CommandStore.current at
# import time (command.py cannot import store.py — circular).  Transitions
# always run inside a store task, so the current store's node carries the
# ring; bare Command objects (unit tests) record nothing.
_current_store: Callable[[], Optional[object]] = lambda: None


# enum .name goes through DynamicClassAttribute per access; transitions
# record two names each, so resolve them once
_STATUS_NAME = {s: s.name for s in SaveStatus}


def note_status_transition(txn_id: TxnId, prev: SaveStatus,
                           new: SaveStatus) -> None:
    """Record a command status transition on the owning node's flight ring
    (obs/flight.py).  Shared by Command.set_status and the few direct
    save_status assignments in local.commands (supersession/truncation
    paths that legally bypass the monotonicity check)."""
    store = _current_store()
    if store is None:
        return
    flight = getattr(store, "flight", None)
    if flight is not None:
        flight.record("status", repr(txn_id),
                      (store.id, _STATUS_NAME[prev], _STATUS_NAME[new]))


class WaitingOn:
    """Bitsets over the stable deps AND the participating keys this command
    must see cleared before it can execute (Command.java:1294-1643 — the
    reference bitset spans txnIds ∪ keys).

    A dep blocks until it is (a) committed with executeAt AFTER ours — then it
    is ordered after us and removed; or (b) applied / invalidated / truncated.
    A key blocks until the CommandsForKey certifies every earlier-executing
    entry at that key applied (the per-key execution gate that holds even for
    conflicts the deps happen to omit).
    """

    __slots__ = ("txn_ids", "waiting", "applied_or_invalidated", "keys",
                 "waiting_keys")

    def __init__(self, txn_ids: Tuple[TxnId, ...], keys: Tuple = ()):
        self.txn_ids = txn_ids
        self.waiting = SimpleBitSet.full(len(txn_ids)) if txn_ids else SimpleBitSet(0)
        self.applied_or_invalidated = SimpleBitSet(len(txn_ids))
        self.keys = keys
        self.waiting_keys = (SimpleBitSet.full(len(keys)) if keys
                             else SimpleBitSet(0))

    @classmethod
    def from_deps(cls, deps: Deps, keys: Tuple = ()) -> "WaitingOn":
        return cls(tuple(deps.sorted_txn_ids()), keys)

    @property
    def is_waiting(self) -> bool:
        return not self.waiting.is_empty() \
            or not self.waiting_keys.is_empty()

    @property
    def is_waiting_on_key(self) -> bool:
        return not self.waiting_keys.is_empty()

    def key_index_of(self, key) -> int:
        try:
            return self.keys.index(key)
        except ValueError:
            return -1

    def is_waiting_on_key_at(self, key) -> bool:
        i = self.key_index_of(key)
        return i >= 0 and self.waiting_keys.get(i)

    def remove_waiting_on_key(self, key) -> bool:
        i = self.key_index_of(key)
        return i >= 0 and self.waiting_keys.unset(i)

    def waiting_key_list(self):
        return [self.keys[i] for i in self.waiting_keys]

    def index_of(self, txn_id: TxnId) -> int:
        i = find_ceil(self.txn_ids, txn_id)
        if i < len(self.txn_ids) and self.txn_ids[i] == txn_id:
            return i
        return -1

    def is_waiting_on(self, txn_id: TxnId) -> bool:
        i = self.index_of(txn_id)
        return i >= 0 and self.waiting.get(i)

    def remove_waiting_on(self, txn_id: TxnId) -> bool:
        i = self.index_of(txn_id)
        return i >= 0 and self.waiting.unset(i)

    def set_applied_or_invalidated(self, txn_id: TxnId) -> bool:
        i = self.index_of(txn_id)
        if i < 0:
            return False
        self.applied_or_invalidated.set(i)
        return self.waiting.unset(i)

    def next_waiting(self) -> Optional[TxnId]:
        """Lowest still-waiting dep (the NotifyWaitingOn walker chases this)."""
        i = self.waiting.first_set()
        return self.txn_ids[i] if i >= 0 else None

    def waiting_ids(self) -> List[TxnId]:
        return [self.txn_ids[i] for i in self.waiting]

    def __repr__(self):
        return (f"WaitingOn({self.waiting_ids()!r}"
                + (f", keys={self.waiting_key_list()!r}"
                   if self.is_waiting_on_key else "") + ")")


class TransientListener:
    """Non-durable callback registered on a command (e.g. ReadData waiting for
    ReadyToExecute). Reference Command.TransientListener (Command.java:72-90)."""

    def on_change(self, safe_store, command: "Command") -> None:
        raise NotImplementedError


class OnAppliedListener(TransientListener):
    """Fire `on_fired(command)` once the command is applied / invalidated /
    truncated — the shared termination predicate behind WaitUntilApplied,
    local barriers, and ephemeral dep waits."""

    __slots__ = ("on_fired", "fired")

    def __init__(self, on_fired):
        self.on_fired = on_fired
        self.fired = False

    @classmethod
    def arm(cls, command: "Command", on_fired) -> "OnAppliedListener":
        listener = cls(on_fired)
        command.add_transient_listener(listener)
        listener.maybe_fire(command)
        return listener

    def on_change(self, safe_store, command: "Command") -> None:
        self.maybe_fire(command)

    def maybe_fire(self, command: "Command") -> None:
        if self.fired:
            return
        if command.is_applied_or_gone or command.is_truncated:
            self.fired = True
            command.remove_transient_listener(self)
            self.on_fired(command)


class Command:
    __slots__ = (
        "txn_id", "save_status", "durability",
        "route", "partial_txn", "execute_at", "execute_at_least",
        "promised", "accepted_ballot",
        "partial_deps", "stable_deps", "waiting_on",
        "writes", "result",
        "listeners", "transient_listeners",
        "owned_keys_memo",
    )

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id
        self.save_status = SaveStatus.NOT_DEFINED
        self.durability = Durability.NOT_DURABLE
        self.route: Optional[Route] = None
        self.partial_txn: Optional[PartialTxn] = None
        self.execute_at: Optional[Timestamp] = None
        self.execute_at_least: Optional[Timestamp] = None
        self.promised: Ballot = Ballot.ZERO
        self.accepted_ballot: Ballot = Ballot.ZERO
        self.partial_deps: Optional[Deps] = None   # proposed (Accept round)
        self.stable_deps: Optional[Deps] = None    # stable (Commit round)
        self.waiting_on: Optional[WaitingOn] = None
        self.writes: Optional[Writes] = None
        self.result = None
        self.listeners: Set[TxnId] = set()         # durable: commands waiting on us
        self.transient_listeners: List[TransientListener] = []
        # (keys, ranges, owned-slice) identity memo for owned_keys_of: the
        # slice is recomputed per CFK registration (every transition), but
        # partial_txn.keys and the store's Ranges are both immutable objects
        # replaced wholesale on change — identity captures staleness exactly
        self.owned_keys_memo: Optional[Tuple] = None

    # -- status predicates --
    @property
    def status(self) -> SaveStatus:
        return self.save_status

    def has_been(self, status: SaveStatus) -> bool:
        return self.save_status >= status

    @property
    def is_defined(self) -> bool:
        return self.save_status.is_defined and self.partial_txn is not None

    @property
    def is_stable(self) -> bool:
        return self.save_status.is_at_least_stable

    @property
    def is_applied_or_gone(self) -> bool:
        return (self.save_status.is_applied_or_gone
                or self.save_status == SaveStatus.INVALIDATED)

    @property
    def is_truncated(self) -> bool:
        return self.save_status.is_truncated

    @property
    def is_invalidated(self) -> bool:
        return self.save_status == SaveStatus.INVALIDATED

    def known(self) -> Known:
        return self.save_status.known()

    def execute_at_or_txn_id(self) -> Timestamp:
        return self.execute_at if self.execute_at is not None else self.txn_id

    # -- ballot gates (promise protocol; Command.java preacceptedOrLater etc.) --
    def may_accept(self, ballot: Ballot) -> bool:
        return self.promised <= ballot

    def may_promise(self, ballot: Ballot) -> bool:
        return self.promised < ballot or (self.promised == ballot)

    def set_promised(self, ballot: Ballot) -> None:
        invariants.check_state(ballot >= self.promised,
                               "promise may only advance")
        self.promised = ballot

    # -- status transition (called only from local.commands) --
    def set_status(self, status: SaveStatus) -> None:
        if status < self.save_status:
            # regressions are only legal into cleanup states
            invariants.check_state(
                status.is_truncated,
                "illegal status regression %s -> %s for %s",
                self.save_status.name, status.name, self.txn_id)
        prev = self.save_status
        self.save_status = status
        if status is not prev:
            note_status_transition(self.txn_id, prev, status)

    def update_route(self, route: Optional[Route]) -> None:
        if route is None:
            return
        if self.route is None:
            self.route = route
        elif route.is_full and not self.route.is_full:
            self.route = route

    # -- listeners --
    def add_listener(self, waiter: TxnId) -> None:
        self.listeners.add(waiter)

    def remove_listener(self, waiter: TxnId) -> None:
        self.listeners.discard(waiter)

    def add_transient_listener(self, listener: TransientListener) -> None:
        self.transient_listeners.append(listener)

    def remove_transient_listener(self, listener: TransientListener) -> None:
        try:
            self.transient_listeners.remove(listener)
        except ValueError:
            pass

    def __repr__(self):
        return (f"Command({self.txn_id!r}, {self.save_status.name}, "
                f"at={self.execute_at!r})")
