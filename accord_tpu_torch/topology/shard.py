"""Shard: one replicated range with its quorum arithmetic.

Reference: accord/topology/Shard.java:38-96. The fast-path electorate is the
subset of replicas whose votes count toward the single-round-trip fast path;
quorum sizes follow the Accord paper's intersection requirements:
  maxFailures          = (rf - 1) // 2
  slowPathQuorumSize   = rf - maxFailures                (simple majority)
  fastPathQuorumSize   = (f + e) // 2 + 1, requiring e >= rf - f
  recoveryFastPathSize = (maxFailures + 1) // 2
"""

from __future__ import annotations

from typing import FrozenSet, Sequence, Tuple

from accord_tpu_torch.primitives.keys import Range, RoutingKey
from accord_tpu_torch.utils import invariants


def max_tolerated_failures(replicas: int) -> int:
    return (replicas - 1) // 2


def slow_path_quorum_size(replicas: int) -> int:
    return replicas - max_tolerated_failures(replicas)


def fast_path_quorum_size(replicas: int, electorate: int, f: int) -> int:
    invariants.check_argument(electorate >= replicas - f,
                              "electorate must include at least rf - f replicas")
    return (f + electorate) // 2 + 1


class Shard:
    __slots__ = ("range", "nodes", "sorted_nodes", "fast_path_electorate",
                 "joining", "max_failures", "recovery_fast_path_size",
                 "fast_path_quorum_size", "slow_path_quorum_size")

    def __init__(self, range_: Range, nodes: Sequence[int],
                 fast_path_electorate: FrozenSet[int] = None,
                 joining: FrozenSet[int] = None):
        self.range = range_
        self.nodes: Tuple[int, ...] = tuple(nodes)
        self.sorted_nodes: Tuple[int, ...] = tuple(sorted(nodes))
        electorate = (frozenset(fast_path_electorate)
                      if fast_path_electorate is not None else frozenset(nodes))
        self.fast_path_electorate = electorate
        self.joining = frozenset(joining) if joining else frozenset()
        invariants.check_argument(self.joining <= set(nodes),
                                  "joining nodes must also be present in nodes")
        self.max_failures = max_tolerated_failures(len(self.nodes))
        self.recovery_fast_path_size = (self.max_failures + 1) // 2
        self.slow_path_quorum_size = slow_path_quorum_size(len(self.nodes))
        self.fast_path_quorum_size = fast_path_quorum_size(
            len(self.nodes), len(electorate), self.max_failures)

    @property
    def rf(self) -> int:
        return len(self.nodes)

    def contains(self, key: RoutingKey) -> bool:
        return self.range.contains(key)

    def contains_node(self, node: int) -> bool:
        return node in self.nodes

    def is_in_electorate(self, node: int) -> bool:
        return node in self.fast_path_electorate

    def rejects_fast_path(self, reject_count: int) -> bool:
        """Have enough electorate votes been lost that the fast path cannot
        reach quorum? (Shard.java:84-87)"""
        return reject_count > len(self.fast_path_electorate) - self.fast_path_quorum_size

    def __eq__(self, other):
        return (isinstance(other, Shard) and self.range == other.range
                and self.nodes == other.nodes
                and self.fast_path_electorate == other.fast_path_electorate
                and self.joining == other.joining)

    def __hash__(self):
        return hash((self.range, self.nodes))

    def __repr__(self):
        return (f"Shard({self.range!r}, nodes={list(self.nodes)}, "
                f"electorate={sorted(self.fast_path_electorate)})")
