"""Admin-plane verbs for live elasticity: epoch install, drain, bootstrap WAL
markers.

Reference: accord's configuration service contract (accord/topology/
TopologyManager.java + the accord-maelstrom admin channel): topology changes
enter through an out-of-band admin plane, are made durable before they are
acknowledged, and propagate node-to-node so a single admin contact suffices.

Three verb families live here:

  * EpochInstall / TopologyFetchReq|Ok|Nack — the gossiped epoch proposal and
    its gap-fetch. An install is journaled (has_side_effects) BEFORE the
    admin ack, and `impl/config_service.py` applies it through the same
    immutable-topology swap the sim uses.
  * DrainBegin / DrainDone — scale-in lifecycle. The retiring node fences new
    client coordination on DrainBegin; peers deprioritize it as a bootstrap
    source; DrainDone records the durability watermark handoff completed.
  * BootstrapCheckpoint / BootstrapDone — WAL-only progress records written
    by `local/bootstrap.py` as fetched sub-ranges finalize. They are never
    sent to peers: their `process()` is the crash-restart RESTORE path, so a
    node killed mid-bootstrap resumes from the checkpointed coverage instead
    of re-fetching completed ranges.

All admin records replay in a band BEFORE protocol messages
(`replay_band = -1`, journal/snapshot.py): replayed transactions may be
gated on epochs these records install.  None of them carry a `txn_id`
attribute — the compaction fold must keep them in the always-preserved
`no_txn` band, and the reconstruction validator must skip them.
"""

from __future__ import annotations

from typing import Optional, Tuple

from accord_tpu_torch.messages.base import MessageType, Reply, Request
from accord_tpu_torch.primitives.keys import Range, Ranges


class EpochInstall(Request):
    """Propose/forward one topology epoch.

    `shards` is the portable spec `((start, end, (node, ...)), ...)`;
    `peers` optionally carries transport addresses `((id, host, port), ...)`
    — or `((id, host, port, dc), ...)` when a geo profile places the peer
    in a named datacenter — so existing members learn how to reach (and
    where to place) nodes joining in this epoch.  `geo` optionally carries
    a whole placement profile in `GeoProfile.to_wire()` form so one admin
    contact installs the latency matrix cluster-wide.
    """

    type = MessageType.EPOCH_INSTALL_MSG
    replay_band = -1

    def __init__(self, epoch: int, shards: Tuple,
                 peers: Optional[Tuple] = None, geo=None):
        self.epoch = epoch
        self.shards = tuple(
            (int(s), int(e), tuple(int(n) for n in nodes))
            for s, e, nodes in shards)
        self.peers = (tuple(
            (int(p[0]), str(p[1]), int(p[2]))
            + ((str(p[3]),) if len(p) > 3 and p[3] else ())
            for p in peers) if peers else None)
        if geo is not None:
            from accord_tpu_torch.topology.geo import GeoProfile
            if not isinstance(geo, GeoProfile):
                geo = GeoProfile.from_wire(geo)
            self.geo = geo.to_wire()  # canonical nested tuples
        else:
            self.geo = None

    @classmethod
    def from_topology(cls, topology, peers: Optional[Tuple] = None,
                      geo=None) -> "EpochInstall":
        return cls(topology.epoch,
                   tuple((s.range.start, s.range.end, s.sorted_nodes)
                         for s in topology.shards), peers, geo=geo)

    def build_topology(self):
        from accord_tpu_torch.topology.topology import Topology
        from accord_tpu_torch.topology.shard import Shard
        return Topology(self.epoch,
                        [Shard(Range(s, e), nodes)
                         for s, e, nodes in self.shards])

    def process(self, node, from_id: int, reply_context) -> None:
        service = getattr(node, "config_service", None)
        if service is not None:
            service.on_epoch_install(self, from_id)
        elif not node.topology.has_epoch(self.epoch):
            node.on_topology_update(self.build_topology())

    def __repr__(self):
        return f"EpochInstall(epoch={self.epoch}, shards={len(self.shards)})"


class TopologyFetchReq(Request):
    """Gap fetch: ask a peer for the EpochInstall spec of one epoch (the
    transport realization of the config service's fetch hook)."""

    type = MessageType.TOPOLOGY_FETCH_REQ

    def __init__(self, epoch: int):
        self.epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        service = getattr(node, "config_service", None)
        spec = service.spec_for(self.epoch) if service is not None else None
        if spec is None:
            node.reply(from_id, reply_context, TopologyFetchNack(self.epoch))
        else:
            node.reply(from_id, reply_context, TopologyFetchOk(spec))

    def __repr__(self):
        return f"TopologyFetchReq(epoch={self.epoch})"


class TopologyFetchOk(Reply):
    type = MessageType.TOPOLOGY_FETCH_RSP

    def __init__(self, install: EpochInstall):
        self.install = install

    def __repr__(self):
        return f"TopologyFetchOk({self.install!r})"


class TopologyFetchNack(Reply):
    type = MessageType.TOPOLOGY_FETCH_RSP

    def __init__(self, epoch: int):
        self.epoch = epoch

    def __repr__(self):
        return f"TopologyFetchNack(epoch={self.epoch})"


class DrainBegin(Request):
    """Scale-in step 1: `node_id` stops accepting NEW client coordination.
    Self-receipt fences the coordinator door; peer receipt deprioritizes the
    draining node as a bootstrap/fetch source.  Journaled, so a crashed
    drainer comes back still fenced."""

    type = MessageType.DRAIN_BEGIN_MSG
    replay_band = -1

    def __init__(self, node_id: int):
        self.node_id = node_id

    def process(self, node, from_id: int, reply_context) -> None:
        if node.id == self.node_id:
            node.draining = True
        node.draining_peers.add(self.node_id)
        node.obs.flight.record("drain_begin", None, (self.node_id, from_id))

    def __repr__(self):
        return f"DrainBegin(n{self.node_id})"


class DrainDone(Request):
    """Scale-in step 2 marker: `node_id` has handed off in-flight work and
    its durability watermarks cover its ranges — it can retire without
    losing an acked write."""

    type = MessageType.DRAIN_DONE_MSG
    replay_band = -1

    def __init__(self, node_id: int):
        self.node_id = node_id

    def process(self, node, from_id: int, reply_context) -> None:
        if node.id == self.node_id:
            node.drained = True
        node.draining_peers.add(self.node_id)
        node.obs.flight.record("drain_done", None, (self.node_id, from_id))

    def __repr__(self):
        return f"DrainDone(n{self.node_id})"


class BootstrapCheckpoint(Request):
    """WAL-only bootstrap progress record: the finalized coverage of one
    fetch attempt, with the installed snapshot and conflict watermarks.
    Written by Bootstrap._on_max_conflict as sub-ranges flip safe-to-read;
    `process()` runs only on crash-restart replay and re-installs exactly
    what the live path had finalized, so resume never re-fetches it.

    The fence TxnId is deliberately stored as `fence`, NOT `txn_id`: the
    compaction fold groups by `txn_id` and could subsume a record carrying
    one; `no_txn` records are always preserved verbatim."""

    type = MessageType.BOOTSTRAP_CHECKPOINT_MSG
    replay_band = -1

    def __init__(self, epoch: int, fence, ranges: Ranges, snapshot,
                 max_conflict=None, max_applied=None):
        self.epoch = epoch
        self.fence = fence
        self.ranges = ranges
        self.snapshot = snapshot
        self.max_conflict = max_conflict
        self.max_applied = max_applied

    def process(self, node, from_id: int, reply_context) -> None:
        from accord_tpu_torch.local import commands as C
        from accord_tpu_torch.local.store import PreLoadContext
        if self.snapshot:
            node.data_store.install_snapshot(self.snapshot)
        if self.max_applied is not None:
            node.on_remote_timestamp(self.max_applied)
        if self.max_conflict is not None:
            node.on_remote_timestamp(self.max_conflict)
        for store in node.command_stores.intersecting(self.ranges):
            owned = self.ranges.slice(store.ranges)
            if owned.is_empty:
                continue
            store.redundant_before.set_bootstrapped_at(owned, self.fence)
            if self.max_conflict is not None:
                store.max_conflicts.update(owned, self.max_conflict)
            store.mark_safe_to_read(owned)
            store.execute(PreLoadContext.empty(), C.re_evaluate_waiting)
        done = getattr(node, "_ckpt_bootstrapped", None)
        if done is not None:
            have = done.get(self.epoch, Ranges.EMPTY)
            done[self.epoch] = have.union(self.ranges)

    def __repr__(self):
        return (f"BootstrapCheckpoint(epoch={self.epoch}, "
                f"ranges={self.ranges!r})")


class BootstrapDone(Request):
    """WAL-only completion marker: every range this node was assigned in
    `epoch` finished bootstrapping (the sync-complete broadcast went out)."""

    type = MessageType.BOOTSTRAP_DONE_MSG
    replay_band = -1

    def __init__(self, epoch: int, ranges: Ranges):
        self.epoch = epoch
        self.ranges = ranges

    def process(self, node, from_id: int, reply_context) -> None:
        done = getattr(node, "_bootstrap_complete", None)
        if done is not None:
            done.add(self.epoch)

    def __repr__(self):
        return f"BootstrapDone(epoch={self.epoch})"
