"""TopologyRandomizer: the topology-change nemesis for the burn test.

Reference: accord-core test accord/topology/TopologyRandomizer.java:58,
109-115 — mutates the topology on a virtual-time cadence with UpdateType
{SPLIT, MERGE, MEMBERSHIP, FASTPATH}, exercising epoch sync, bootstrap and
stale-replica handling. Each node learns the new epoch after its own random
delay, so nodes genuinely straddle epochs mid-coordination.
"""

from __future__ import annotations

from typing import Dict, List

from accord_tpu_torch.primitives.keys import Range, Ranges
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.random_source import RandomSource


class TopologyRandomizer:
    def __init__(self, cluster, rng: RandomSource, period_s: float = 2.0,
                 max_changes: int = 1_000_000):
        self.cluster = cluster
        self.rng = rng
        self.period_us = int(period_s * 1e6)
        self.max_changes = max_changes
        self.changes = 0
        self.stopped = False
        # per-node epoch delivery chains (epochs must arrive in order)
        self._pending: Dict[int, List[Topology]] = {
            nid: [] for nid in cluster.nodes}
        self._delivering: Dict[int, bool] = {nid: False for nid in cluster.nodes}

    def start(self) -> None:
        self.cluster.queue.add(self.period_us, self._tick)

    # ------------------------------------------------------------ mutation --
    def stop(self) -> None:
        self.stopped = True

    def _tick(self) -> None:
        if self.stopped or self.changes >= self.max_changes:
            return
        new = self._mutate(self.cluster.topology)
        if new is not None:
            self.changes += 1
            self.cluster.topology = new
            self.cluster.topology_ledger[new.epoch] = new
            for nid in self.cluster.nodes:
                self._enqueue(nid, new)
        self.cluster.queue.add(self.period_us, self._tick)

    def _enqueue(self, nid: int, topology: Topology) -> None:
        self._pending[nid].append(topology)
        if not self._delivering[nid]:
            self._deliver_next(nid)

    def _deliver_next(self, nid: int) -> None:
        if not self._pending[nid]:
            self._delivering[nid] = False
            return
        self._delivering[nid] = True
        topology = self._pending[nid].pop(0)
        delay = 1000 + self.rng.next_int(200_000)  # 1ms..200ms

        def deliver():
            self.cluster.config_services[nid].report_topology(topology)
            self._deliver_next(nid)

        self.cluster.queue.add(delay, deliver)

    def _mutate(self, top: Topology):
        kind = self.rng.pick(["SPLIT", "MERGE", "MEMBERSHIP", "MEMBERSHIP",
                              "FASTPATH"])
        shards = list(top.shards)
        if kind == "SPLIT":
            i = self.rng.next_int(len(shards))
            s = shards[i]
            if s.range.end - s.range.start < 2:
                return None
            mid = s.range.start + 1 + self.rng.next_int(
                s.range.end - s.range.start - 1)
            shards[i:i + 1] = [
                Shard(Range(s.range.start, mid), s.nodes,
                      s.fast_path_electorate, s.joining),
                Shard(Range(mid, s.range.end), s.nodes,
                      s.fast_path_electorate, s.joining),
            ]
        elif kind == "MERGE":
            candidates = [i for i in range(len(shards) - 1)
                          if shards[i].nodes == shards[i + 1].nodes
                          and shards[i].range.end == shards[i + 1].range.start]
            if not candidates:
                return None
            i = self.rng.pick(candidates)
            a, b = shards[i], shards[i + 1]
            shards[i:i + 2] = [Shard(Range(a.range.start, b.range.end),
                                     a.nodes)]
        elif kind == "MEMBERSHIP":
            i = self.rng.next_int(len(shards))
            s = shards[i]
            outsiders = sorted(set(self.cluster.nodes) - set(s.nodes))
            if not outsiders:
                return None
            leave = self.rng.pick(sorted(s.nodes))
            join = self.rng.pick(outsiders)
            nodes = tuple(join if n == leave else n for n in s.nodes)
            shards[i] = Shard(s.range, nodes)
        else:  # FASTPATH
            i = self.rng.next_int(len(shards))
            s = shards[i]
            rf = len(s.nodes)
            f = (rf - 1) // 2
            min_e = rf - f
            size = min_e + self.rng.next_int(rf - min_e + 1)
            electorate = frozenset(self.rng.sample(sorted(s.nodes), size))
            if electorate == s.fast_path_electorate:
                return None
            shards[i] = Shard(s.range, s.nodes, electorate, s.joining)
        return Topology(top.epoch + 1, shards)
