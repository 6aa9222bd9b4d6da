"""Topologies: the multi-epoch window a coordination spans.

Reference: accord/topology/Topologies.java (Single/Multi). A transaction
coordinated in epoch C but executing in epoch E > C must contact replicas from
every epoch in [C, E]; Topologies holds those per-epoch (sub-)topologies,
newest first, exactly as the reference orders them.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, List, Sequence, Set, Tuple

from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils import invariants


class Topologies:
    __slots__ = ("_topologies",)

    def __init__(self, topologies: Sequence[Topology]):
        invariants.check_argument(len(topologies) > 0, "empty Topologies")
        ts = sorted(topologies, key=lambda t: -t.epoch)
        for a, b in zip(ts, ts[1:]):
            invariants.check_argument(a.epoch == b.epoch + 1,
                                      "Topologies epochs must be contiguous")
        self._topologies: Tuple[Topology, ...] = tuple(ts)

    @classmethod
    def single(cls, topology: Topology) -> "Topologies":
        return cls((topology,))

    # -- epoch window --
    @property
    def current_epoch(self) -> int:
        return self._topologies[0].epoch

    @property
    def oldest_epoch(self) -> int:
        return self._topologies[-1].epoch

    @property
    def size(self) -> int:
        return len(self._topologies)

    def current(self) -> Topology:
        return self._topologies[0]

    def get(self, i: int) -> Topology:
        """i-th topology, newest first (reference Topologies.get)."""
        return self._topologies[i]

    def for_epoch(self, epoch: int) -> Topology:
        i = self.current_epoch - epoch
        invariants.check_argument(0 <= i < len(self._topologies),
                                  "epoch %d outside window", epoch)
        return self._topologies[i]

    def for_epochs(self, min_epoch: int, max_epoch: int) -> "Topologies":
        return Topologies([t for t in self._topologies
                           if min_epoch <= t.epoch <= max_epoch])

    def __iter__(self):
        return iter(self._topologies)

    # -- node union --
    def nodes(self) -> FrozenSet[int]:
        out: Set[int] = set()
        for t in self._topologies:
            out.update(t.nodes())
        return frozenset(out)

    def contacts(self, sorter=None) -> List[int]:
        ns = list(self.nodes())
        if sorter is not None:
            return sorter.sort(ns, self)
        return sorted(ns)

    def __eq__(self, other):
        return isinstance(other, Topologies) and self._topologies == other._topologies

    def __hash__(self):
        return hash(self._topologies)

    def __repr__(self):
        return f"Topologies(e{self.oldest_epoch}..e{self.current_epoch})"
