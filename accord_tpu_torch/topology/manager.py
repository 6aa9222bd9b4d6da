"""TopologyManager: the per-node epoch ledger and sync tracker.

Reference: accord/topology/TopologyManager.java:70-671. Tracks every known
epoch's topology, which peers have completed their inter-epoch sync (a
per-shard quorum of sync acknowledgements unlocks the epoch for precise
coordination), pending futures for unknown epochs, and the epoch-window
selection used by coordinators (`with_unsynced_epochs` / `precise_epochs`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from accord_tpu_torch.primitives.keys import Ranges, Route
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult, success


def _covered_by(select, ranges: Ranges) -> bool:
    """Is the selection (Route / Ranges / sorted key list) fully inside
    `ranges`?  Used to decide per-range sync unlock."""
    if isinstance(select, Route):
        select = select.participants()
    if isinstance(select, Ranges):
        return ranges.contains_all_ranges(select)
    return ranges.contains_all_keys(select)


class EpochState:
    __slots__ = ("global_topology", "synced_nodes", "sync_complete",
                 "synced_ranges", "closed", "redundant")

    def __init__(self, global_topology: Topology):
        self.global_topology = global_topology
        self.synced_nodes: Set[int] = set()
        self.sync_complete = False
        self.synced_ranges: Ranges = Ranges.EMPTY  # per-shard quorum-synced
        self.closed: Ranges = Ranges.EMPTY      # ranges no longer coordinated here
        self.redundant: Ranges = Ranges.EMPTY   # ranges fully superseded

    def recompute_sync(self) -> bool:
        """Accumulate quorum-synced shard ranges; sync-complete once every
        shard has a (slow-path) quorum of synced replicas.

        Per-range granularity mirrors the reference's curSyncComplete /
        syncCompleteFor (TopologyManager.java:115-186): a shard whose quorum
        has synced unlocks ITS range for precise coordination even while
        other shards of the same epoch are still syncing."""
        if self.sync_complete:
            return True
        synced = []
        complete = True
        for shard in self.global_topology.shards:
            acks = sum(1 for n in shard.nodes if n in self.synced_nodes)
            if acks >= shard.slow_path_quorum_size:
                synced.append(shard.range)
            else:
                complete = False
        self.synced_ranges = Ranges(synced)
        self.sync_complete = complete
        return complete

    def sync_complete_for(self, select) -> bool:
        """Per-range unlock: the selection is fully inside quorum-synced
        shard ranges (TopologyManager.java syncCompleteFor)."""
        if self.sync_complete:
            return True
        if self.synced_ranges.is_empty:
            return False
        return _covered_by(select, self.synced_ranges)


class TopologyManager:
    def __init__(self, node_id: int, sorter=None):
        from accord_tpu_torch.topology.sorter import SIZE_OF_INTERSECTION
        self.node_id = node_id
        self.sorter = sorter if sorter is not None else SIZE_OF_INTERSECTION
        self._epochs: Dict[int, EpochState] = {}
        self._min_epoch = 0
        self._max_epoch = 0
        self._pending: Dict[int, AsyncResult] = {}
        self._fetch_hook: Optional[Callable[[int], None]] = None
        # windows: with_unsynced_epochs calls; extended: windows widened to
        # older epochs; range_unlocks: windows kept precise by the per-range
        # sync test while the epoch as a whole was still syncing
        self.stats = {"windows": 0, "extended": 0, "range_unlocks": 0}

    # -- feeding --
    def on_topology_update(self, topology: Topology) -> None:
        epoch = topology.epoch
        if self._max_epoch == 0:
            self._min_epoch = epoch
            # first epoch needs no predecessor sync
            state = EpochState(topology)
            state.sync_complete = True
            self._epochs[epoch] = state
        else:
            invariants.check_argument(
                epoch == self._max_epoch + 1,
                "topology epochs must arrive in order (%d after %d)",
                epoch, self._max_epoch)
            self._epochs[epoch] = EpochState(topology)
        self._max_epoch = max(self._max_epoch, epoch)
        pending = self._pending.pop(epoch, None)
        if pending is not None:
            pending.try_success(topology)

    def on_epoch_sync_complete(self, node: int, epoch: int) -> None:
        """Peer `node` reports it finished syncing epoch `epoch`'s data."""
        state = self._epochs.get(epoch)
        if state is None:
            return  # unknown epoch; acks for future epochs are re-broadcast
        state.synced_nodes.add(node)
        state.recompute_sync()

    def on_epoch_closed(self, ranges: Ranges, epoch: int) -> None:
        state = self._epochs.get(epoch)
        if state is not None:
            state.closed = state.closed.union(ranges)

    def on_epoch_redundant(self, ranges: Ranges, epoch: int) -> None:
        state = self._epochs.get(epoch)
        if state is not None:
            state.redundant = state.redundant.union(ranges)

    def truncate_before(self, epoch: int) -> None:
        for e in list(self._epochs):
            if e < epoch:
                del self._epochs[e]
        self._min_epoch = max(self._min_epoch, epoch)

    def set_fetch_hook(self, hook: Callable[[int], None]) -> None:
        """Called when someone awaits an epoch we don't know (drives
        ConfigurationService.fetchTopologyForEpoch)."""
        self._fetch_hook = hook

    # -- queries --
    @property
    def epoch(self) -> int:
        return self._max_epoch

    @property
    def min_epoch(self) -> int:
        return self._min_epoch

    def has_epoch(self, epoch: int) -> bool:
        return epoch in self._epochs

    def current(self) -> Topology:
        invariants.check_state(self._max_epoch > 0, "no topology yet")
        return self._epochs[self._max_epoch].global_topology

    def current_local(self) -> Topology:
        return self.current().for_node(self.node_id)

    def for_epoch(self, epoch: int) -> Topology:
        state = self._epochs.get(epoch)
        invariants.check_state(state is not None, "unknown epoch %d", epoch)
        return state.global_topology

    def is_sync_complete(self, epoch: int) -> bool:
        state = self._epochs.get(epoch)
        return state is not None and state.sync_complete

    def epoch_acked_by(self, epoch: int, node: int) -> bool:
        """Has `node` reported sync-complete for `epoch`?  The epoch-install
        gossip uses this to stop resending to peers that have demonstrably
        caught up (a sync ack implies the peer knows the topology)."""
        state = self._epochs.get(epoch)
        return state is not None and node in state.synced_nodes

    def sync_complete_for(self, epoch: int, select) -> bool:
        """Epoch-sync test at range granularity: true when the selection's
        ranges all belong to quorum-synced shards of `epoch`, even if the
        epoch as a whole is still syncing (TopologyManager.syncCompleteFor)."""
        state = self._epochs.get(epoch)
        return state is not None and state.sync_complete_for(select)

    def await_epoch(self, epoch: int) -> AsyncResult:
        """Resolves (with the Topology) once `epoch` is known locally."""
        if epoch in self._epochs:
            return success(self._epochs[epoch].global_topology)
        pending = self._pending.get(epoch)
        if pending is None:
            pending = self._pending[epoch] = AsyncResult()
        if self._fetch_hook is not None:
            # re-trigger on every await: the hook dedupes in-flight fetches
            # itself, and a fetch that failed (source unreachable) must be
            # retriable by the next waiter rather than wedging every one
            self._fetch_hook(epoch)
        return pending

    # -- coordination epoch-window selection --
    def precise_epochs(self, select, min_epoch: int, max_epoch: int) -> Topologies:
        """Sub-topologies for exactly [min_epoch, max_epoch]
        (TopologyManager.preciseEpochs)."""
        out: List[Topology] = []
        for e in range(max_epoch, min_epoch - 1, -1):
            out.append(self.for_epoch(e).for_selection(select))
        return Topologies(out)

    def with_unsynced_epochs(self, select, min_epoch: int, max_epoch: int
                             ) -> Topologies:
        """[min_epoch, max_epoch] extended downward through epochs whose sync
        has not yet quorum-completed FOR THE SELECTION's ranges, so replicas
        still serving old epochs are contacted
        (TopologyManager.withUnsyncedEpochs).  Range-granular: an epoch
        counts as synced when every shard range the selection touches has a
        sync quorum, even while other shards of that epoch are still syncing
        (reference syncCompleteFor, TopologyManager.java:115-186)."""
        self.stats["windows"] += 1
        lo = min_epoch
        range_unlock = False
        while True:
            state = self._epochs.get(lo)
            if state is not None and state.sync_complete_for(select):
                range_unlock = not state.sync_complete
                break
            if lo <= self._min_epoch:
                break
            lo -= 1
        if lo < min_epoch:
            self.stats["extended"] += 1
        elif range_unlock:
            # only a PRECISE window counts as a per-range unlock win
            self.stats["range_unlocks"] += 1
        out: List[Topology] = []
        for e in range(max_epoch, lo - 1, -1):
            out.append(self.for_epoch(e).for_selection(select))
        return Topologies(out)

    def with_open_epochs(self, select, min_epoch: int, max_epoch: int) -> Topologies:
        return self.with_unsynced_epochs(select, min_epoch, max_epoch)
