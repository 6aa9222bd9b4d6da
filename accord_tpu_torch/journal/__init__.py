"""Durable write-ahead journal: the on-disk form of the durability contract.

The sim has always *validated* the journal-replay contract (sim/journal.py:
every live command reconstructible from the node's retained side-effecting
messages — reference SerializerSupport.java:60-557, burn-test
Journal.java:82-303); this package makes it *real*:

  * segment.py  — append-only segment files, length+CRC32-framed records
                  serialized with the structural wire codec (host/wire.py),
                  rotation at a size threshold, torn-tail truncation on open
  * wal.py      — the per-node journal: every `has_side_effects` request is
                  appended before it is acked, with GROUP COMMIT — a flush
                  thread coalesces concurrent appends into one fsync per
                  deadline/batch-bounded window (mirroring the ingest
                  pipeline's micro-batch windows), so durability costs one
                  fsync per window, not per txn
  * snapshot.py — periodic compaction: fold retired segments' records into
                  a snapshot file (verified lossless against sim/journal.py's
                  reconstruction fold) and delete the covered segments
  * replay.py   — on restart, load snapshot + surviving segments and replay
                  them through the node's ordinary message processing to
                  rebuild CommandStore state, then rejoin

Hosts opt in with `ACCORD_JOURNAL=<dir>` (see attach_journal_from_env);
the sim's crash-restart nemesis (`BurnRun --restart`) kills a node with
process-death semantics and restarts it from its journal directory.
"""

from __future__ import annotations

import os

from accord_tpu_torch.journal.segment import SegmentWriter, read_segment
from accord_tpu_torch.journal.wal import (DurableAckSink, JournalConfig,
                                    WriteAheadLog)


def journal_env_dir() -> str:
    """The ACCORD_JOURNAL base directory, or '' when journaling is off."""
    return os.environ.get("ACCORD_JOURNAL", "")


def attach_journal_from_env(node, band: str = None):
    """Host-side wiring: when ACCORD_JOURNAL=<dir> is set, open (or create)
    this node's journal under <dir>/node-<id>, replay any surviving state
    into the freshly built node, attach the WAL as `node.journal` (every
    has_side_effects request is appended by Node._process before the ack),
    and — when group commit is on — gate outbound replies on the fsync
    watermark with DurableAckSink.  Returns the WAL, or None when off.

    `band` names a sub-journal under the node's directory: the shard worker
    runtime journals where it processes, so each worker owns the WAL band
    <dir>/node-<id>/<band> and replays exactly its own shard's history on
    respawn while the parent keeps the node-plane band at the root."""
    base = journal_env_dir()
    if not base:
        return None
    path = os.path.join(base, f"node-{node.id}")
    if band:
        path = os.path.join(path, band)
    cfg = JournalConfig.from_env(path)
    wal = WriteAheadLog(path, node_id=node.id, config=cfg,
                        registry=node.obs.registry, flight=node.obs.flight,
                        retain=False)
    records = wal.load_records()
    if records:
        from accord_tpu_torch.journal.replay import replay_node
        replay_node(node, records,
                    registry=node.obs.registry, flight=node.obs.flight)
    node.journal = wal
    if cfg.group_commit:
        node.sink = DurableAckSink(node.sink, wal)
    # end replay's defer mode: start bootstraps for whatever the journaled
    # checkpoints left uncovered (with the WAL attached, so fresh progress
    # is checkpointed too)
    node.resume_bootstraps()
    return wal
