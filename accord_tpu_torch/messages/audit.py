"""Replica-state audit verbs: cross-replica range digests + drill-down.

No reference counterpart — the reference's correctness story is offline
(burn checkers, Elle); these verbs are the ONLINE verification surface the
production host needs: an auditor node periodically asks every
replica of a range for an order-insensitive digest of its decided command
state, bounded by the negotiated cleanup watermarks so replicas at
different truncation points still agree; a mismatch drills down (bisecting
by txn-id window) to per-transaction entry lists and the first divergent
transaction.

All verbs are READ-ONLY (has_side_effects=False — never journaled) and
deliberately NOT TxnRequests: a digest walk is a node-level fold with
cross-store dedup (one leaf per transaction however its keys shard), so
`process` computes directly over the node's stores instead of the per-store
map-reduce.  The walks themselves live in local/audit.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from accord_tpu_torch.messages.base import MessageType, Reply, Request
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp


class AuditDigestOk(Reply):
    """One replica's digest of its decided command state over the audited
    ranges within [lo, hi).

    digest     — hex of the 128-bit XOR fold of per-txn leaves
                 (local/audit.entry_leaf over canonical wire packings)
    count      — transactions folded in
    lo_floor   — this replica's bootstrap/staleness low bound for the
                 ranges (digests must not reach below it)
    hi_floor   — this replica's universal-durable floor (above it this
                 replica is not yet certified to hold everything)
    """

    type = MessageType.AUDIT_DIGEST_RSP

    def __init__(self, digest: str, count: int, lo_floor: Timestamp,
                 hi_floor: Timestamp):
        self.digest = digest
        self.count = count
        self.lo_floor = lo_floor
        self.hi_floor = hi_floor

    def __repr__(self):
        return (f"AuditDigestOk({self.digest[:12]}.. n={self.count} "
                f"lo={self.lo_floor!r} hi={self.hi_floor!r})")


class AuditDigest(Request):
    """Fold decided command state for `ranges` within [lo, hi) into one
    order-insensitive digest (AUDIT_DIGEST_REQ)."""

    type = MessageType.AUDIT_DIGEST_REQ

    def __init__(self, ranges: Ranges, lo: Timestamp, hi: Timestamp):
        self.ranges = ranges
        self.lo = lo
        self.hi = hi

    def process(self, node, from_id: int, reply_context) -> None:
        if node.command_stores.remote:
            # worker runtime: the stores live in per-shard processes — fan
            # the walk out over the worker pipes and merge (supervisor.py)
            node.command_stores.audit_request(self, from_id, reply_context)
            return
        from accord_tpu_torch.local import audit as A
        node.reply(from_id, reply_context,
                   A.digest_reply(node, self.ranges, self.lo, self.hi))

    def __repr__(self):
        return f"AuditDigest({self.ranges!r} [{self.lo!r}, {self.hi!r}))"


class AuditEntriesOk(Reply):
    """Drill-down entry list: (txn_id, cls, execute_at) per decided txn in
    the window, cls in ("committed", "invalidated", "unknown")."""

    type = MessageType.AUDIT_ENTRIES_RSP

    def __init__(self, entries: Tuple[tuple, ...], truncated: bool = False):
        self.entries = tuple(entries)
        # True when the reply was cut at the serving limit — the auditor
        # must bisect further instead of trusting a partial diff
        self.truncated = truncated

    def __repr__(self):
        return (f"AuditEntriesOk(n={len(self.entries)}"
                + (", truncated" if self.truncated else "") + ")")


class AuditEntries(Request):
    """Fetch the per-transaction entries backing a digest window
    (AUDIT_ENTRIES_REQ) — sent only after a digest mismatch, on a window
    bisected small enough to enumerate."""

    type = MessageType.AUDIT_ENTRIES_REQ

    # serving cap: a drill-down that still exceeds this is answered
    # truncated, forcing the auditor to keep bisecting
    LIMIT = 4096

    def __init__(self, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                 limit: Optional[int] = None):
        self.ranges = ranges
        self.lo = lo
        self.hi = hi
        self.limit = limit if limit is not None else self.LIMIT

    def process(self, node, from_id: int, reply_context) -> None:
        if node.command_stores.remote:
            node.command_stores.audit_request(self, from_id, reply_context)
            return
        from accord_tpu_torch.local import audit as A
        entries = A.collect_entries(node, self.ranges, self.lo, self.hi)
        limit = min(self.limit, self.LIMIT)
        truncated = len(entries) > limit
        node.reply(from_id, reply_context,
                   AuditEntriesOk(tuple(entries[:limit]), truncated))

    def __repr__(self):
        return f"AuditEntries({self.ranges!r} [{self.lo!r}, {self.hi!r}))"
