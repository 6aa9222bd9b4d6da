"""Fault-injection flags: deliberately weaken protocol strengthenings.

Reference: accord/utils/Faults.java — four booleans consumed at coordination
seams (CoordinationAdapter.java:172 skips the Stabilise round;
ProposeTxn.java:48 / ProposeSyncPoint.java:55 skip folding the accept-round
deps recalculations into the commit deps).  Everything these flags disable
is a STRENGTHENING, not a safety requirement: the protocol must stay
strict-serializable with any combination enabled — recovery just works
harder.  The burn suite runs with each flag on to prove exactly that
(tests/test_faults.py).

Flags live on a module-level instance so hosts flip them at startup and
tests scope them with `injected(...)`.
"""

from __future__ import annotations

from contextlib import contextmanager


class Faults:
    """The four protocol-weakening switches (Faults.java)."""

    __slots__ = ("transaction_instability", "syncpoint_instability",
                 "transaction_unmerged_deps", "syncpoint_unmerged_deps")

    def __init__(self, transaction_instability: bool = False,
                 syncpoint_instability: bool = False,
                 transaction_unmerged_deps: bool = False,
                 syncpoint_unmerged_deps: bool = False):
        self.transaction_instability = transaction_instability
        self.syncpoint_instability = syncpoint_instability
        self.transaction_unmerged_deps = transaction_unmerged_deps
        self.syncpoint_unmerged_deps = syncpoint_unmerged_deps

    # -- kind-aware views (txn vs sync-point variants of the same fault) --
    def instability(self, kind) -> bool:
        """Skip the pre-execution Stabilise (CommitSlowPath) round?"""
        return (self.syncpoint_instability if kind.is_sync_point
                else self.transaction_instability)

    def unmerged_deps(self, kind) -> bool:
        """Propose with the pre-accept deps only, dropping the accept-round
        recalculations?"""
        return (self.syncpoint_unmerged_deps if kind.is_sync_point
                else self.transaction_unmerged_deps)

    def __repr__(self):
        on = [n for n in self.__slots__ if getattr(self, n)]
        return f"Faults({', '.join(on) or 'none'})"


FAULTS = Faults()


@contextmanager
def injected(**flags):
    """Scope fault flags for a test: `with injected(transaction_instability=
    True): ...` — restores the previous values on exit."""
    prev = {name: getattr(FAULTS, name) for name in flags}
    for name, value in flags.items():
        setattr(FAULTS, name, value)
    try:
        yield FAULTS
    finally:
        for name, value in prev.items():
            setattr(FAULTS, name, value)
