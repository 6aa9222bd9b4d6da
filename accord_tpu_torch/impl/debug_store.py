"""Debug command store: store-affinity and safe-store-leak detection.

Reference: accord/impl/InMemoryCommandStore.java:1191 (the Debug variant
asserting every access runs on the owning store's executor and detecting
SafeCommandStore references cached past their operation) and the
CommandStore.current() thread-affinity contract (CommandStore.java:228).

Python has no data-race detector to lean on (the reference treats this
variant as its TSan stand-in, SURVEY §5.2), so the Debug store checks the
two invariants that matter in a logically single-threaded-shard design:

* store affinity — every state access happens while THIS store's task is
  the one running (CommandStore.current() is the owner); a callback that
  closes over another shard's safe store trips it immediately;
* use-after-release — a SafeCommandStore reference cached beyond its task
  (the reference's "leaked safe store") fails on next use instead of
  silently mutating state outside the executor.
"""

from __future__ import annotations

from accord_tpu_torch.local.store import (CommandStore, PreLoadContext,
                                    SafeCommandStore)
from accord_tpu_torch.utils import invariants


class DebugSafeCommandStore(SafeCommandStore):
    """Every state access in SafeCommandStore — commands, CFKs, watermarks,
    the conflict-query/recovery scans, progress log, data store — goes
    through `self.store`, so intercepting that ONE attribute covers the
    whole surface (including entry points added later) without per-method
    wrappers."""

    def _check(self) -> None:
        invariants.check_state(
            not getattr(self, "released", False),
            "safe store for %s used after its task completed (leaked "
            "reference)", self._store)
        invariants.check_state(
            CommandStore.current() is self._store,
            "cross-store access: safe store of %s used while %s is current",
            self._store, CommandStore.current())

    @property
    def store(self) -> CommandStore:
        self._check()
        return self._store

    @store.setter
    def store(self, value: CommandStore) -> None:
        self._store = value


class DebugCommandStore(CommandStore):
    """Drop-in store variant for tests/burns: behaviourally identical, with
    the Debug assertions armed on every safe-store access."""

    def _make_safe(self, context: PreLoadContext) -> SafeCommandStore:
        return DebugSafeCommandStore(self, context)
