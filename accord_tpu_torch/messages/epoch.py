"""Epoch-sync gossip and the bootstrap data-fetch verb.

Reference: epoch sync is the ConfigurationService/EpochReady contract
(api/ConfigurationService.java — nodes acknowledge an epoch once their data
for it is ready; TopologyManager.onEpochSyncComplete collects a quorum per
shard before coordination may rely on the new epoch). The data fetch is the
DataStore bootstrap protocol (api/DataStore.java:39-113, FETCH_DATA_REQ
carried by impl/AbstractFetchCoordinator in the reference).
"""

from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.messages.base import MessageType, Reply, Request
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import TxnId


class EpochSyncComplete(Request):
    """`from` has finished preparing `epoch` (bootstrap fetched, stores
    re-ranged): counts toward the per-shard sync quorum that unlocks
    coordination in the new epoch (TopologyManager.onEpochSyncComplete)."""

    def __init__(self, epoch: int):
        self.epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        node.topology.on_epoch_sync_complete(from_id, self.epoch)

    def __repr__(self):
        return f"EpochSyncComplete({self.epoch})"


class FetchSnapshotOk(Reply):
    type = MessageType.FETCH_DATA_RSP

    def __init__(self, snapshot, ranges: Ranges, max_applied=None):
        self.snapshot = snapshot  # opaque DataStore payload
        self.ranges = ranges      # what the peer actually covered
        # the source's max applied executeAt within `ranges` — the optional
        # bound of DataStore.StartingRangeFetch.started(maxApplied), letting
        # the fetcher raise its clocks without a separate global probe
        self.max_applied = max_applied

    def __repr__(self):
        return f"FetchSnapshotOk({self.ranges!r})"


class FetchSnapshotNack(Reply):
    type = MessageType.FETCH_DATA_RSP

    def __repr__(self):
        return "FetchSnapshotNack"


class FetchSnapshot(Request):
    """Bootstrap fetch: once `fence` (the bootstrap ExclusiveSyncPoint) has
    applied at the peer, its data for `ranges` contains every transaction
    ordered below the fence — snapshot and return it."""

    type = MessageType.FETCH_DATA_REQ

    def __init__(self, txn_id: TxnId, ranges: Ranges):
        self.txn_id = txn_id  # the fence ESP
        self.ranges = ranges

    @property
    def wait_for_epoch(self) -> int:
        return self.txn_id.epoch

    def process(self, node, from_id: int, reply_context) -> None:
        from accord_tpu_torch.local.command import OnAppliedListener
        from accord_tpu_torch.local.store import PreLoadContext

        stores = node.command_stores.intersecting(self.ranges)
        if not stores:
            node.reply(from_id, reply_context, FetchSnapshotNack())
            return
        covered = Ranges.EMPTY
        for s in stores:
            covered = covered.union(s.ranges.slice(self.ranges))
        if covered.is_empty:
            node.reply(from_id, reply_context, FetchSnapshotNack())
            return
        remaining = {s.id for s in stores}

        def on_all_applied():
            snap = node.data_store.snapshot_ranges(covered)
            max_applied = None
            for s in stores:
                for key, tfk in s.tfks.items():
                    if tfk.last_executed is not None and covered.contains(key) \
                            and (max_applied is None
                                 or tfk.last_executed > max_applied):
                        max_applied = tfk.last_executed
            node.reply(from_id, reply_context,
                       FetchSnapshotOk(snap, covered, max_applied))

        def arm(safe_store):
            from accord_tpu_torch.local.status import SaveStatus
            sid = safe_store.store.id

            def fired(_cmd):
                remaining.discard(sid)
                if not remaining:
                    on_all_applied()

            cmd = safe_store.get(self.txn_id)
            listener = OnAppliedListener.arm(cmd, fired)
            if not listener.fired and not cmd.has_been(SaveStatus.STABLE):
                # chase the fence if it hasn't reached us yet
                safe_store.progress_log.waiting(
                    self.txn_id, safe_store.store, "Applied", cmd.route,
                    self.ranges)

        for s in stores:
            s.execute(PreLoadContext.for_txn(self.txn_id), arm)

    def __repr__(self):
        return f"FetchSnapshot({self.ranges!r} fenced by {self.txn_id!r})"
