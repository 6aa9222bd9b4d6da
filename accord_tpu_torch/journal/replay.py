"""Crash-restart replay: rebuild a node from its on-disk journal.

The journal IS the recovery story (sim/journal.py proves every live command
reconstructible from it); replay turns that proof operational: each
surviving record is fed back through the node's ordinary message processing
(`Node.receive` with no reply context), so CommandStore state, CFK
registrations, data-store content and execution ordering are rebuilt by the
same handlers that built them the first time — no parallel rehydration code
path to drift.  Records are band-ordered first (PreAccept < Accept <
Commit < Apply < Propagate, snapshot.py's fold order), making replay
insensitive to the order segments captured them in.

Before any record is processed the node's HLC is advanced past every
timestamp in the journal: a restarted node whose wall clock regressed must
never re-issue a TxnId below one it already used (the reference persists
its HLC watermark for the same reason).

Replay runs with the journal detached — re-processing a journaled request
must not re-append it.
"""

from __future__ import annotations

import time
from typing import List, Optional


class ReplayStats:
    __slots__ = ("records", "txns", "duration_us")

    def __init__(self, records: int, txns: int, duration_us: int):
        self.records = records
        self.txns = txns
        self.duration_us = duration_us

    def __repr__(self):
        return (f"ReplayStats(records={self.records} txns={self.txns} "
                f"duration_us={self.duration_us})")


def _fold_hlc(node, records) -> None:
    """Advance the node's HLC past every journaled timestamp."""
    for msg in records:
        for ts in (getattr(msg, "txn_id", None),
                   getattr(msg, "execute_at", None)):
            if ts is not None:
                node.on_remote_timestamp(ts)
        known = getattr(msg, "known", None)
        if known is not None and getattr(known, "execute_at", None) is not None:
            node.on_remote_timestamp(known.execute_at)


def replay_node(node, records: List[object], registry=None,
                flight=None) -> ReplayStats:
    """Feed `records` through `node`'s normal message dispatch (the node
    should be freshly constructed with its topology already reported).
    Deferred work the handlers schedule (execution waiting on deps, reads)
    drains on the node's own scheduler afterwards — sim restart drains the
    virtual queue, hosts their loop thread."""
    from accord_tpu_torch.sim.journal import reconstruct

    t0 = time.monotonic()
    if flight is not None:
        flight.record("journal_replay_begin", None, (len(records),))
    _fold_hlc(node, records)
    from accord_tpu_torch.journal.snapshot import _band
    ordered = sorted(records, key=_band)
    prev_journal, node.journal = node.journal, None
    # replay mode: suppress live side effects of admin records — epoch
    # installs must not re-gossip, and newly-owned ranges must not start
    # live bootstraps until resume_bootstraps() reconciles them against
    # the checkpoint coverage restored further down the same journal
    node.replaying = True
    node.defer_bootstrap = True
    try:
        for req in ordered:
            node.receive(req, 0, None)
    finally:
        node.journal = prev_journal
        node.replaying = False
    txns = len(reconstruct(records))
    duration_us = int((time.monotonic() - t0) * 1e6)
    if registry is not None:
        registry.counter("accord_journal_replay_records_total") \
            .inc(len(records))
        registry.histogram("accord_journal_replay_duration_us") \
            .observe(duration_us)
    if flight is not None:
        flight.record("journal_replay_end", None, (len(records), txns))
    return ReplayStats(len(records), txns, duration_us)
