"""Topology: one epoch's shard layout (reference: accord/topology/Topology.java:59-540)."""

from __future__ import annotations

import bisect
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.primitives.keys import Range, Ranges, Route, RoutingKey, _SortedKeyList
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.utils import invariants


class Topology:
    __slots__ = ("epoch", "shards", "ranges", "_starts", "_node_shards",
                 "_node_ranges", "_selection_memo")

    EMPTY: "Topology"

    def __init__(self, epoch: int, shards: Sequence[Shard]):
        self.epoch = epoch
        self.shards: Tuple[Shard, ...] = tuple(
            sorted(shards, key=lambda s: (s.range.start, s.range.end)))
        # shard ranges must not overlap
        for a, b in zip(self.shards, self.shards[1:]):
            invariants.check_argument(a.range.end <= b.range.start,
                                      "shard ranges overlap")
        self.ranges = Ranges([s.range for s in self.shards])
        self._starts = [s.range.start for s in self.shards]
        node_shards: Dict[int, List[int]] = {}
        for i, s in enumerate(self.shards):
            for n in s.nodes:
                node_shards.setdefault(n, []).append(i)
        self._node_shards = {n: tuple(ix) for n, ix in node_shards.items()}
        # per-node Ranges memo: topologies are immutable and
        # ranges_for_node runs per destination per message send
        # (TxnRequest.compute_scope)
        self._node_ranges: Dict[int, Ranges] = {}
        # for_selection memo keyed by participant-object identity: a txn's
        # coordination rounds re-select with the SAME route participants
        # object 3-4 times per epoch window.  Values hold a strong ref to
        # the key object, so a live entry's id cannot be reused; bounded by
        # wholesale clear.
        self._selection_memo: Dict[int, Tuple] = {}

    # -- basic accessors --
    @property
    def size(self) -> int:
        return len(self.shards)

    def nodes(self) -> FrozenSet[int]:
        return frozenset(self._node_shards.keys())

    def contains_node(self, node: int) -> bool:
        return node in self._node_shards

    def shards_for_node(self, node: int) -> List[Shard]:
        return [self.shards[i] for i in self._node_shards.get(node, ())]

    def ranges_for_node(self, node: int) -> Ranges:
        r = self._node_ranges.get(node)
        if r is None:
            r = self._node_ranges[node] = Ranges(
                [self.shards[i].range
                 for i in self._node_shards.get(node, ())])
        return r

    def shard_for_key(self, key: RoutingKey) -> Optional[Shard]:
        i = bisect.bisect_right(self._starts, key.token) - 1
        if i >= 0 and self.shards[i].contains(key):
            return self.shards[i]
        return None

    def shard_for_token(self, token: int) -> Optional[Shard]:
        return self.shard_for_key(RoutingKey(token))

    # -- selection over routables (Topology.forSelection / mapReduceOn) --
    def shards_for(self, select) -> List[Shard]:
        """Shards intersecting a Keys/RoutingKeys/Ranges/Route selection,
        in range order."""
        if isinstance(select, Route):
            select = select.participants()
        out: List[Shard] = []
        if isinstance(select, _SortedKeyList):
            ki = 0
            for s in self.shards:
                while ki < len(select) and select[ki].token < s.range.start:
                    ki += 1
                if ki < len(select) and s.range.contains(select[ki]):
                    out.append(s)
            return out
        if isinstance(select, Ranges):
            for s in self.shards:
                if select.intersects(s.range):
                    out.append(s)
            return out
        raise TypeError(type(select))

    def for_selection(self, select) -> "Topology":
        """Sub-topology of shards intersecting the selection (forSelection)."""
        memo = self._selection_memo
        hit = memo.get(id(select))
        if hit is not None and hit[0] is select:
            return hit[1]
        sub = Topology(self.epoch, self.shards_for(select))
        if len(memo) > 256:
            memo.clear()
        memo[id(select)] = (select, sub)
        return sub

    def for_node(self, node: int) -> "Topology":
        return Topology(self.epoch, self.shards_for_node(node))

    def map_reduce_on(self, select, map_fn: Callable[[Shard], object],
                      reduce_fn: Callable[[object, object], object],
                      initial=None):
        acc = initial
        for s in self.shards_for(select):
            v = map_fn(s)
            acc = v if acc is None else reduce_fn(acc, v)
        return acc

    def foldl(self, select, fn: Callable, acc):
        for s in self.shards_for(select):
            acc = fn(acc, s)
        return acc

    def for_each(self, fn: Callable[[Shard], None]) -> None:
        for s in self.shards:
            fn(s)

    def nodes_for(self, select) -> FrozenSet[int]:
        out: Set[int] = set()
        for s in self.shards_for(select):
            out.update(s.nodes)
        return frozenset(out)

    def __eq__(self, other):
        return (isinstance(other, Topology) and self.epoch == other.epoch
                and self.shards == other.shards)

    def __hash__(self):
        return hash((self.epoch, self.shards))

    def __repr__(self):
        return f"Topology(e{self.epoch}, {len(self.shards)} shards)"


Topology.EMPTY = Topology(0, ())
