"""Simulated network: per-link nemesis actions and randomized delays.

Reference: accord-core test impl/basic/NodeSink.java:45 (Action {DELIVER,
DROP, DELIVER_WITH_FAILURE, FAILURE}), Cluster.java:518+ (partition
generator / LinkConfig). All deliveries are Pending items in the shared
virtual-time queue, so message interleavings derive entirely from the seed.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional, Tuple

from accord_tpu_torch.api.spi import CallbackSink, MessageSink
from accord_tpu_torch.messages.base import FailureReply, Reply, Request
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.utils.random_source import RandomSource


class Action(enum.Enum):
    DELIVER = "DELIVER"
    DROP = "DROP"
    DELIVER_WITH_FAILURE = "DELIVER_WITH_FAILURE"  # deliver, but fail the response path
    FAILURE = "FAILURE"                            # fail without delivering


class LinkConfig:
    """Per-ordered-pair link behavior."""

    def __init__(self, deliver_prob: float = 1.0, min_delay_us: int = 500,
                 max_delay_us: int = 20_000, down: bool = False):
        self.deliver_prob = deliver_prob
        self.min_delay_us = min_delay_us
        self.max_delay_us = max_delay_us
        self.down = down

    def action(self, random: RandomSource) -> Action:
        if self.down:
            return Action.DROP
        if random.next_float() < self.deliver_prob:
            return Action.DELIVER
        return Action.DROP


class SimNetwork:
    def __init__(self, queue: PendingQueue, random: RandomSource):
        self.queue = queue
        self.random = random
        self.nodes: Dict[int, object] = {}          # node_id -> Node
        self.links: Dict[Tuple[int, int], LinkConfig] = {}
        self.default_link = LinkConfig()
        self.stats: Dict[str, int] = {}
        self.on_deliver: Optional[Callable] = None  # tracing hook
        # drop filters: fn(from_id, to_id, message) -> True to drop
        # (reference test/accord/NetworkFilter)
        self.filters: list = []
        # geo placement (topology/geo.GeoProfile): when installed, the
        # per-(src,dst) link-class bounds replace the flat default-link
        # delay draw — still exactly one bounded next_int per delivery, so
        # the run stays deterministic per seed; explicit set_link overrides
        # (nemesis partitions, bespoke test links) still win
        self.geo = None

    def set_geo(self, profile) -> None:
        self.geo = profile

    def add_filter(self, fn: Callable) -> Callable:
        self.filters.append(fn)
        return fn

    def remove_filter(self, fn: Callable) -> None:
        if fn in self.filters:
            self.filters.remove(fn)

    def _filtered(self, from_id: int, to_id: int, message) -> bool:
        return any(f(from_id, to_id, message) for f in self.filters)

    def register(self, node) -> None:
        self.nodes[node.id] = node

    def link(self, from_id: int, to_id: int) -> LinkConfig:
        return self.links.get((from_id, to_id), self.default_link)

    def set_link(self, from_id: int, to_id: int, config: LinkConfig) -> None:
        self.links[(from_id, to_id)] = config

    def partition(self, group_a, group_b) -> None:
        """Sever links between two node groups (both directions)."""
        for a in group_a:
            for b in group_b:
                self.set_link(a, b, LinkConfig(down=True))
                self.set_link(b, a, LinkConfig(down=True))

    def heal(self) -> None:
        self.links.clear()

    def _count(self, what: str) -> None:
        self.stats[what] = self.stats.get(what, 0) + 1

    def _record_drop(self, from_id: int, to_id: int, message,
                     msg_name: str) -> None:
        """Drops are recorded on the SENDER's flight ring (the receiver
        never saw the message; the sender's timeline is where the gap shows
        up next to its tx event)."""
        node = self.nodes.get(from_id)
        obs = getattr(node, "obs", None)
        if obs is not None:
            obs.flight.record("drop", getattr(message, "trace_id", None),
                              (from_id, to_id, msg_name))

    def _delay_us(self, from_id: int, to_id: int, link: LinkConfig) -> int:
        """Per-delivery delay draw.  With a geo profile installed and no
        explicit link override for this pair, the (src,dst) link-class
        bounds govern; otherwise the link's own bounds (the pre-geo flat
        path, bit-identical in rng consumption)."""
        if self.geo is not None and (from_id, to_id) not in self.links:
            bounds = self.geo.delay_bounds_us(from_id, to_id)
            if bounds is not None:
                lo, hi = bounds
                return lo if hi <= lo else self.random.next_int(lo, hi)
        return (link.min_delay_us
                if link.max_delay_us <= link.min_delay_us
                else self.random.next_int(link.min_delay_us, link.max_delay_us))

    def _count_link_class(self, from_id: int, to_id: int) -> None:
        """Per-link-class message census on the SENDER's registry — the
        messages/txn x link-class yardstick (WAN crossings/txn) the wan
        report section folds.  Only active under a geo profile."""
        cls = self.geo.link_class(from_id, to_id)
        if cls is None:
            return
        node = self.nodes.get(from_id)
        obs = getattr(node, "obs", None)
        if obs is not None:
            obs.registry.counter("accord_link_msgs_total", cls=cls).inc()

    def deliver_request(self, from_id: int, to_id: int, request: Request,
                        reply_context) -> None:
        link = self.link(from_id, to_id)
        action = link.action(self.random)
        msg_name = type(request).__name__
        if action == Action.DROP or self._filtered(from_id, to_id, request):
            self._count(f"drop.{msg_name}")
            self._record_drop(from_id, to_id, request, msg_name)
            return
        self._count(f"deliver.{msg_name}")
        if self.geo is not None:
            self._count_link_class(from_id, to_id)
        delay = self._delay_us(from_id, to_id, link)

        def run():
            node = self.nodes.get(to_id)
            if node is None:
                return
            if self.on_deliver is not None:
                self.on_deliver(from_id, to_id, request)
            node.receive(request, from_id, reply_context)

        self.queue.add(delay, run)

    def deliver_reply(self, from_id: int, to_id: int, msg_id: int,
                      reply: Reply) -> None:
        link = self.link(from_id, to_id)
        if link.action(self.random) == Action.DROP \
                or self._filtered(from_id, to_id, reply):
            self._count(f"drop.{type(reply).__name__}")
            self._record_drop(from_id, to_id, reply, type(reply).__name__)
            return
        self._count(f"deliver.{type(reply).__name__}")
        if self.geo is not None:
            self._count_link_class(from_id, to_id)
        delay = self._delay_us(from_id, to_id, link)

        def run():
            node = self.nodes.get(to_id)
            if node is None:
                return
            sink: NodeSink = node.sink
            sink.deliver_reply(msg_id, from_id, reply)

        self.queue.add(delay, run)


class PartitionNemesis:
    """Periodically severs the cluster into two groups and heals after a
    random interval (reference Cluster.java:518+ schedules re-partitioning
    every 5s virtual). Alternates partition/heal ticks; `stop()` heals and
    cancels, letting the burn quiesce."""

    def __init__(self, network: SimNetwork, queue: PendingQueue,
                 random: RandomSource, node_ids,
                 period_s: float = 5.0, max_partition_s: float = 4.0):
        self.network = network
        self.queue = queue
        self.random = random
        self.node_ids = sorted(node_ids)
        self.period_us = int(period_s * 1e6)
        self.max_partition_us = int(max_partition_s * 1e6)
        self.partitioned = False
        self.partitions_applied = 0
        self._stopped = False

    def start(self) -> None:
        self.queue.add(self.random.next_int(0, self.period_us), self._tick)

    def stop(self) -> None:
        self._stopped = True
        if self.partitioned:
            self._heal()

    def _heal(self) -> None:
        self.network.heal()
        self.partitioned = False

    def _tick(self) -> None:
        if self._stopped:
            return
        if self.partitioned:
            self._heal()
            self.queue.add(self.random.next_int(1, self.period_us), self._tick)
            return
        ids = list(self.node_ids)
        if len(ids) >= 2:
            self.random.shuffle(ids)
            cut = 1 + self.random.next_int(len(ids) - 1)
            self.network.partition(ids[:cut], ids[cut:])
            self.partitioned = True
            self.partitions_applied += 1
        self.queue.add(self.random.next_int(1, self.max_partition_us),
                       self._tick)


class DcPartitionNemesis:
    """Periodically severs ONE whole datacenter from the rest of the
    cluster and heals it (virtual-time ticks like PartitionNemesis, which
    cuts random groups).  Every begin/heal is recorded on each live node's
    flight ring (`dc_partition_begin` / `dc_partition_heal`) so a stitched
    timeline explains exactly when and why the fast-path ratio dipped: a
    partitioned electorate member makes the fast quorum unreachable while
    a hub-local slow quorum keeps committing on the slow path.

    `partition_now(dc)` / `heal_now()` are public so a bench lane can
    drive deterministic degrade/heal windows without the random ticker."""

    def __init__(self, network: SimNetwork, queue: PendingQueue,
                 random: RandomSource, geo, dcs=None,
                 period_s: float = 5.0, max_partition_s: float = 4.0):
        self.network = network
        self.queue = queue
        self.random = random
        self.geo = geo
        # DCs eligible for partitioning (default: every named DC)
        self.dcs = sorted(dcs) if dcs else sorted(geo.dcs)
        self.period_us = int(period_s * 1e6)
        self.max_partition_us = int(max_partition_s * 1e6)
        self.partitioned_dc: str = ""
        self.partitions_applied = 0
        self._stopped = False

    def start(self) -> None:
        self.queue.add(self.random.next_int(0, self.period_us), self._tick)

    def stop(self) -> None:
        self._stopped = True
        if self.partitioned_dc:
            self.heal_now()

    def partition_now(self, dc: str) -> None:
        inside = self.geo.nodes_in(dc)
        outside = [n for n in self.network.nodes if n not in inside]
        self.network.partition(inside, outside)
        self.partitioned_dc = dc
        self.partitions_applied += 1
        data = (dc, tuple(inside))
        for obs in self._all_obs():
            obs.flight.record("dc_partition_begin", None, data)

    def heal_now(self) -> None:
        dc, self.partitioned_dc = self.partitioned_dc, ""
        self.network.heal()
        data = (dc, tuple(self.geo.nodes_in(dc)))
        for obs in self._all_obs():
            obs.flight.record("dc_partition_heal", None, data)

    def _all_obs(self):
        return [obs for obs in
                (getattr(node, "obs", None)
                 for node in self.network.nodes.values())
                if obs is not None]

    def _tick(self) -> None:
        if self._stopped:
            return
        if self.partitioned_dc:
            self.heal_now()
            self.queue.add(self.random.next_int(1, self.period_us),
                           self._tick)
            return
        self.partition_now(self.dcs[self.random.next_int(len(self.dcs))])
        self.queue.add(self.random.next_int(1, self.max_partition_us),
                       self._tick)


class NodeSink(CallbackSink):
    """MessageSink bound to one simulated node."""

    def __init__(self, node_id: int, network: SimNetwork):
        super().__init__()
        self.node_id = node_id
        self.network = network

    def send(self, to: int, request: Request) -> None:
        if self._capture(to, None, request):
            return
        self.network.deliver_request(self.node_id, to, request, None)

    def send_with_callback(self, to: int, request: Request, callback,
                           executor=None) -> None:
        msg_id = self._register(callback)
        ctx = (self.node_id, msg_id)
        if self._capture(to, ctx, request):
            return
        self.network.deliver_request(self.node_id, to, request, ctx)

    def _send_prepared(self, to: int, reply_context, request) -> None:
        self.network.deliver_request(self.node_id, to, request,
                                     reply_context)

    def reply(self, to: int, reply_context, reply: Reply) -> None:
        if reply_context is None:
            return
        origin, msg_id = reply_context
        self.network.deliver_reply(self.node_id, origin, msg_id, reply)
