"""TopologySorter: contact-ordering policy for coordination rounds.

Reference: accord/api/TopologySorter.java (comparator SPI; least preferable
first) + accord/impl/SizeOfIntersectionSorter.java — prefer replicas that
appear in MORE shards of the selection: one message to such a node advances
more shard quorums, so reads and fan-outs favour them.

Ours exposes `sort(nodes, topologies)` returning most-preferable first (the
order consumers like ReadTracker.initial_contacts take directly), with node
id as the deterministic tie-break.
"""

from __future__ import annotations

from typing import List, Sequence


class TopologySorter:
    def sort(self, nodes: Sequence[int], topologies) -> List[int]:
        raise NotImplementedError


class SizeOfIntersectionSorter(TopologySorter):
    """Order by how many shards across the epoch window each node replicates
    (SizeOfIntersectionSorter.compare counts shard memberships the same
    way), descending; ties by node id."""

    def sort(self, nodes: Sequence[int], topologies) -> List[int]:
        def intersections(node: int) -> int:
            return sum(1 for topology in topologies
                       for shard in topology.shards
                       if node in shard.nodes)

        return sorted(nodes, key=lambda n: (-intersections(n), n))


SIZE_OF_INTERSECTION = SizeOfIntersectionSorter()
