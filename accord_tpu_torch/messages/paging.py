"""Spill-tier record kinds for the bounded-memory command store.

Reference: accord's pluggable storage contract (accord/api/Journal.java +
accord-core's CommandStore persistence seams): command state a node cannot
afford to keep resident is durably *representable*, so an implementation may
evict and reload it without the protocol observing a missing command.

Two record kinds live here, both written ONLY to the pager's per-incarnation
spill store (`journal/fault_index.py`) — never the node WAL:

  * SpillFrame — the full quiescent payload of one evicted `Command`
    (local/paging.py writes one per eviction; a fault reads exactly one
    back via the fault index's (segment, offset) point-read).
  * FaultIndexCheckpoint — a periodic snapshot of the fault index itself,
    appended to the spill store so reopening it can seed the index from the
    latest checkpoint and scan only the frames appended after it, instead
    of re-scanning every segment.

Unlike the admin records (messages/admin.py), SpillFrame DOES carry a
`txn_id` attribute — that is safe here precisely because these records are
barred from the WAL and therefore from the snapshot-compaction fold that
groups by `txn_id` (both verbs register `has_side_effects=False`, so the
live journal path never frames one; `process()` is a loud no-op in case a
future path miswires them).  The spill store is scratch state: a restart
wipes it and WAL replay rebuilds residency from scratch.
"""

from __future__ import annotations

from typing import Optional, Tuple

from accord_tpu_torch.messages.base import MessageType, Request


class SpillFrame(Request):
    """The evictable payload of one quiescent Command.

    Field-for-field the durable subset of `Command.__slots__`: listeners /
    transient_listeners are empty and `waiting_on` is None on any command
    the pager deems evictable (quiescent, decided), and `owned_keys_memo`
    is a pure cache — none of the four is carried, all four are recreated
    empty on refault (local/paging.py rebuilds via `to_command`)."""

    type = MessageType.SPILL_FRAME_MSG

    FIELDS = ("txn_id", "save_status", "durability", "route", "partial_txn",
              "execute_at", "execute_at_least", "promised", "accepted_ballot",
              "partial_deps", "stable_deps", "writes", "result")

    def __init__(self, txn_id, save_status, durability, route, partial_txn,
                 execute_at, execute_at_least, promised, accepted_ballot,
                 partial_deps, stable_deps, writes, result):
        self.txn_id = txn_id
        self.save_status = save_status
        self.durability = durability
        self.route = route
        self.partial_txn = partial_txn
        self.execute_at = execute_at
        self.execute_at_least = execute_at_least
        self.promised = promised
        self.accepted_ballot = accepted_ballot
        self.partial_deps = partial_deps
        self.stable_deps = stable_deps
        self.writes = writes
        self.result = result

    @classmethod
    def from_command(cls, cmd) -> "SpillFrame":
        return cls(*(getattr(cmd, f) for f in cls.FIELDS))

    def to_command(self):
        from accord_tpu_torch.local.command import Command
        cmd = Command(self.txn_id)
        for f in self.FIELDS[1:]:
            setattr(cmd, f, getattr(self, f))
        return cmd

    def process(self, node, from_id: int, reply_context) -> None:
        raise AssertionError(
            "SpillFrame is a spill-store record; it must never be "
            "dispatched through the protocol or WAL-replay path")

    def __repr__(self):
        return f"SpillFrame({self.txn_id}, {self.save_status.name})"


class FaultIndexCheckpoint(Request):
    """Periodic snapshot of the spill store's fault index.

    `entries` is a portable tuple of (msb, lsb, node, segment_index,
    offset) rows — one per spilled command — matching TxnId.pack() so the
    checkpoint never holds live key objects.  `through_segment` /
    `through_offset` mark the append position the snapshot covers: a
    reopen seeds the index from the newest intact checkpoint and replays
    only frames past that position."""

    type = MessageType.FAULT_INDEX_CHECKPOINT_MSG

    def __init__(self, entries: Tuple, through_segment: int,
                 through_offset: int):
        self.entries = tuple(tuple(int(x) for x in row) for row in entries)
        self.through_segment = int(through_segment)
        self.through_offset = int(through_offset)

    def process(self, node, from_id: int, reply_context) -> None:
        raise AssertionError(
            "FaultIndexCheckpoint is a spill-store record; it must never "
            "be dispatched through the protocol or WAL-replay path")

    def __repr__(self):
        return (f"FaultIndexCheckpoint({len(self.entries)} entries, "
                f"through={self.through_segment}:{self.through_offset})")
