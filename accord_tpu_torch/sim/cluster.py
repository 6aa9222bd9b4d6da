"""SimCluster: a whole Accord cluster in one deterministic event loop.

Reference: the burn-test cluster (accord-core test impl/basic/Cluster.java:102,
run loop :277-410): every node's executors, timers and deliveries share one
virtual-time queue; the loop is `while processPending()`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from accord_tpu_torch.api.spi import Agent, EventsListener
from accord_tpu_torch.impl.config_service import DirectConfigService
from accord_tpu_torch.impl.list_store import ListStore
from accord_tpu_torch.local.node import Node
from accord_tpu_torch.primitives.keys import Range, Ranges
from accord_tpu_torch.primitives.timestamp import TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.sim.network import NodeSink, SimNetwork
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.sim.scheduler import SimScheduler
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.random_source import RandomSource


class SimAgent(Agent):
    def __init__(self, cluster: "SimCluster", node_id: int):
        self.cluster = cluster
        self.node_id = node_id
        self.failures: List[BaseException] = []
        # flipped by SimCluster.kill_node: a ghost's timers (progress-log
        # polls, watchdogs armed pre-crash) keep firing on the discarded
        # object graph — their failures must not abort the simulation
        self.dead = False

    def on_uncaught_exception(self, failure: BaseException) -> None:
        self.failures.append(failure)
        if not self.dead:
            self.cluster.queue.fail(failure)

    def on_handled_exception(self, failure: BaseException) -> None:
        # recorded (so harnesses can assert on incidents like a mid-run
        # device-backend death) but NOT fatal to the simulation
        self.failures.append(failure)

    def pre_accept_timeout(self) -> float:
        return 1.0  # virtual second

    def empty_txn(self, kind: TxnKind, keys_or_ranges) -> Txn:
        return Txn(kind, keys_or_ranges)


class DriftingClock:
    """Per-node wall clock: the shared virtual clock plus a bounded random
    walk (reference BurnTest.java:330-340 — per-node drifting clocks with
    frequent small jumps and occasional large ones, FrequentLargeRange).
    The HLC max-folds regressions away (Node.unique_now), so drift exercises
    timestamp ordering and preaccept-expiry paths without breaking
    monotonicity."""

    def __init__(self, clock, random: RandomSource, small_us: int = 2_000,
                 large_us: int = 10_000, bound_us: int = 50_000):
        self.clock = clock
        self.random = random
        self.small_us = small_us
        self.large_us = large_us
        self.bound_us = bound_us
        self.offset = 0

    def now_us(self) -> int:
        r = self.random
        step = (r.next_int(-self.large_us, self.large_us)
                if r.next_float() < 0.1
                else r.next_int(-self.small_us, self.small_us))
        self.offset = max(-self.bound_us,
                          min(self.bound_us, self.offset + step))
        return max(0, self.clock.now_us + self.offset)


class _DeadSink:
    """Message sink of a killed node's ghost: timers scheduled before the
    kill still fire on the discarded object graph, and whatever they try to
    send must vanish (the process is gone)."""

    def send(self, to, request) -> None:
        pass

    def send_with_callback(self, to, request, callback, executor=None) -> None:
        pass  # no reply ever: the caller's RPC timeout fires

    def reply(self, to, reply_context, reply) -> None:
        pass

    def deliver_reply(self, msg_id, from_id, reply) -> None:
        pass


class SimCluster:
    """N simulated nodes over a token-range topology."""

    def __init__(self, n_nodes: int = 3, seed: int = 0, token_span: int = 1000,
                 n_shards: int = 2, rf: int = None, num_command_stores: int = 1,
                 progress_log_factory: Optional[Callable] = None,
                 store_factory: Optional[Callable] = None,
                 clock_drift: bool = False, journal: bool = True,
                 journal_dir: Optional[str] = None,
                 trace: bool = False, pipeline: bool = False,
                 pipeline_config=None, qos: bool = False, qos_config=None,
                 geo=None, electorate=None):
        self.random = RandomSource(seed)
        self.queue = PendingQueue(self.random.fork())
        self.network = SimNetwork(self.queue, self.random.fork())
        self.scheduler = SimScheduler(self.queue)
        # geo placement (topology/geo.GeoProfile): installs the per-link-
        # class delay matrix into the network and DC/electorate labels
        # into each node's obs; `electorate` (a node-id set) narrows every
        # shard's fast-path electorate to its intersection with the
        # shard's replicas (Shard enforces e >= rf - f).  Neither knob
        # touches the rng fork order, so geo=None stays bit-identical to
        # the pre-geo cluster.
        self.geo = geo
        self._electorate = frozenset(electorate) if electorate else None
        if geo is not None:
            self.network.set_geo(geo)
        # journal_dir turns the in-memory message journal into the REAL
        # write-ahead log (accord_tpu_torch/journal/): per-node on-disk segments
        # in synchronous (deterministic) mode, enabling the crash-restart
        # nemesis — kill_node discards all in-memory state, restart_node
        # rebuilds the replica from its journal directory
        self.journal_dir = journal_dir
        if journal_dir is not None:
            from accord_tpu_torch.journal.wal import DurableJournalSet
            self.journal = DurableJournalSet(journal_dir)
        elif journal:
            from accord_tpu_torch.sim.journal import Journal
            self.journal = Journal()
        else:
            self.journal = None
        self.token_span = token_span
        self.nodes: Dict[int, Node] = {}
        self.agents: Dict[int, SimAgent] = {}
        self.dead: set = set()
        self.restarts = 0
        rf = rf if rf is not None else n_nodes
        node_ids = list(range(1, n_nodes + 1))
        self.topology = self._make_topology(1, node_ids, n_shards, rf)
        # epoch ledger backing each node's ConfigurationService fetches
        self.topology_ledger: Dict[int, Topology] = {1: self.topology}
        self.config_services: Dict[int, object] = {}
        # live replica-state auditors (local/audit.py), one per node once
        # attach_auditors is called; restart_node rebuilds the victim's
        self.auditors: Dict[int, object] = {}
        self._auditor_kw: Optional[dict] = None
        # per-node build args retained so restart_node can rebuild an
        # identically configured replica
        self._num_command_stores = num_command_stores
        self._progress_log_factory = progress_log_factory
        self._store_factory = store_factory
        self._clock_drift = clock_drift
        self._trace_enabled = trace
        # set by start_durability_scheduling; restart_node reuses them
        self._durability_cycle_s = None
        self._durability_global_every = None
        for nid in node_ids:
            self._build_node(nid)
        # continuous micro-batching ingest (accord_tpu_torch/pipeline/) on every
        # node, deadline-driven by the shared virtual-time scheduler so the
        # deterministic burn can exercise admission batching, MultiPreAccept
        # envelopes and load shedding under the full nemesis stack
        self.pipelines: Dict[int, object] = {}
        self._pipeline_enabled = pipeline
        self._pipeline_config = pipeline_config
        # per-tenant QoS admission tiers (accord_tpu_torch/qos/) on every node,
        # clocked by virtual time so the deterministic burn can exercise
        # priority-aware shedding under the full nemesis stack.  Built
        # BEFORE the pipelines: the ingest queue is the tier's last-resort
        # inner ring and tallies its sheds there.
        self.qos_tiers: Dict[int, object] = {}
        self._qos_enabled = qos
        self._qos_config = qos_config
        if qos:
            for nid in self.nodes:
                self._build_qos_tier(nid)
        if pipeline:
            from accord_tpu_torch.pipeline import Pipeline
            for nid, node in self.nodes.items():
                self.pipelines[nid] = Pipeline(node, self.scheduler,
                                               pipeline_config,
                                               qos=self.qos_tiers.get(nid))

    def _build_node(self, nid: int) -> Node:
        """Construct (or reconstruct) one node and wire it to the cluster:
        network registration, config service, journal attachment."""
        agent = SimAgent(self, nid)
        sink = NodeSink(nid, self.network)
        now_us = (DriftingClock(self.queue.clock, self.random.fork()).now_us
                  if self._clock_drift
                  else (lambda: self.queue.clock.now_us))
        from accord_tpu_torch.obs import NodeObs
        from accord_tpu_torch.utils.tracing import Trace
        node = Node(
            nid, sink, agent, self.scheduler, ListStore(nid),
            self.random.fork(), num_shards=self._num_command_stores,
            progress_log_factory=self._progress_log_factory,
            store_factory=self._store_factory,
            now_us=now_us,
            trace=Trace(nid, enabled=True,
                        clock=lambda: self.queue.clock.now_us / 1e6)
            if self._trace_enabled else None,
            # span timestamps come from the UNDRIFTED virtual clock:
            # DriftingClock.now_us steps a random walk per call, so
            # clocking obs events through it would perturb the very
            # protocol behavior being observed (and mis-order stitched
            # cross-node traces)
            obs=NodeObs(nid, clock_us=lambda: self.queue.clock.now_us,
                        dc=self.geo.dc_of(nid) if self.geo else None,
                        elect=("in" if nid in self._electorate else "out")
                        if (self.geo is not None
                            and self._electorate is not None) else None),
        )
        if self.geo is not None:
            # placement is forensics-relevant: a stitched timeline reading
            # a ratio dip needs to know which DC each recorder lived in
            node.obs.flight.record("geo_install", None,
                                   (self.geo.name, node.obs.dc))
        if self.journal_dir is not None:
            self.journal.open_node(nid, registry=node.obs.registry,
                                   flight=node.obs.flight)
        node.journal = self.journal
        self.agents[nid] = agent
        self.nodes[nid] = node
        self.network.register(node)
        # topology flows through the node's ConfigurationService
        # (reference AbstractConfigurationService): the node is a
        # listener, the cluster ledger serves gap fetches
        service = DirectConfigService(nid, self.topology_ledger.get)
        service.attach_node(node)
        self.config_services[nid] = service
        if nid in self.dead:
            # restart: feed the full epoch history (replayed messages gate
            # on their txn's epoch) in DEFER mode — bootstraps are queued,
            # not started, and restart_node's resume_bootstraps() reconciles
            # them against the checkpoint coverage the journal replay
            # restores (re-fetching only what the checkpoints left missing)
            node.defer_bootstrap = True
            for epoch in sorted(self.topology_ledger):
                service.report_topology(self.topology_ledger[epoch])
        else:
            service.report_topology(self.topology)
        return node

    def _build_qos_tier(self, nid: int):
        """Construct (or reconstruct, after restart_node) one node's QoS
        admission tier.  Virtual time has no real loop lag, so the sim's
        deterministic pressure signal is the pipeline ingest depth (looked
        up lazily: the pipelines dict is built after the tiers and
        repopulated on restart)."""
        from accord_tpu_torch.qos import PressureController, QosConfig, QosTier
        node = self.nodes[nid]
        config = self._qos_config if self._qos_config is not None \
            else QosConfig()

        def clock_us() -> int:
            return int(self.queue.clock.now_us)

        def depth_pressure(_nid=nid, _cfg=config) -> float:
            p = self.pipelines.get(_nid)
            return p.ingest.depth / _cfg.depth_target if p is not None \
                else 0.0

        controller = PressureController(config, clock_us,
                                        sources=(depth_pressure,))
        tier = QosTier(config, node.obs.registry, node.obs.flight, clock_us,
                       controller=controller)
        self.qos_tiers[nid] = tier
        return tier

    def pipeline_submit(self, node_id: int, txn, tenant: str = "",
                        priority: str = ""):
        """Client entry through the node's QoS tier (when on) and ingest
        pipeline (falls back to direct coordination when the pipeline is
        off)."""
        tier = self.qos_tiers.get(node_id)
        if tier is not None:
            nack = tier.admit(tenant, priority or "normal")
            if nack is not None:
                from accord_tpu_torch.utils.async_chains import AsyncResult
                result = AsyncResult()
                result.try_failure(nack)
                return result
        p = self.pipelines.get(node_id)
        result = (self.nodes[node_id].coordinate(txn) if p is None
                  else p.submit(txn))
        if tier is not None:
            # admitted op settled (either way): shrink the tier's inflight
            # backlog signal — deterministic, it rides the virtual queue
            result.add_callback(lambda _v, _f: tier.op_done())
        return result

    def _make_topology(self, epoch: int, node_ids: List[int], n_shards: int,
                       rf: int) -> Topology:
        width = self.token_span // n_shards
        shards = []
        for i in range(n_shards):
            # rotate replica sets around the ring
            replicas = [node_ids[(i + j) % len(node_ids)] for j in range(rf)]
            electorate = (frozenset(replicas) & self._electorate
                          if self._electorate else None)
            shards.append(Shard(Range(i * width, (i + 1) * width), replicas,
                                fast_path_electorate=electorate))
        return Topology(epoch, shards)

    def update_topology(self, topology: Topology) -> None:
        self.topology = topology
        self.topology_ledger[topology.epoch] = topology
        for service in self.config_services.values():
            service.report_topology(topology)

    def start_durability_scheduling(self, shard_cycle_s: float = None,
                                    global_cycle_every: int = None) -> None:
        """Run the reference's rotating durability rounds on every node
        (CoordinateDurabilityScheduling.java; burn Cluster.java:333-349)."""
        from accord_tpu_torch.coordinate.durability import \
            CoordinateDurabilityScheduling
        # remembered so a restarted node rejoins the durability rotation
        self._durability_cycle_s = shard_cycle_s
        self._durability_global_every = global_cycle_every
        for node in self.nodes.values():
            CoordinateDurabilityScheduling(
                node, shard_cycle_s=shard_cycle_s,
                global_cycle_every=global_cycle_every).start()

    # ------------------------------------------------------------ auditing --
    def attach_auditors(self, interval_s: float = 0.0,
                        census_interval_s: float = None, **kw) -> None:
        """One replica-state auditor per node (local/audit.py).  With
        interval_s/census_interval_s > 0 the periodic timers arm on the
        shared virtual-time scheduler (the live-audit arm); at 0 the
        auditors are passive and a harness drives audit_once/census_once
        explicitly (the burn's end-of-run checker)."""
        from accord_tpu_torch.local.audit import Auditor
        self._auditor_kw = dict(interval_s=interval_s,
                                census_interval_s=census_interval_s, **kw)
        for nid, node in self.nodes.items():
            if nid in self.dead:
                continue
            a = Auditor(node, **self._auditor_kw)
            a.start()
            self.auditors[nid] = a

    def _attach_auditor(self, nid: int) -> None:
        if self._auditor_kw is None:
            return
        from accord_tpu_torch.local.audit import Auditor
        a = Auditor(self.nodes[nid], **self._auditor_kw)
        a.start()
        self.auditors[nid] = a

    # --------------------------------------------------- crash-restart nemesis --
    def live_node_ids(self) -> List[int]:
        return sorted(set(self.nodes) - self.dead)

    def kill_node(self, node_id: int) -> None:
        """Process-death semantics: every piece of in-memory state —
        command stores, data store, obs rings, pending callbacks — is
        discarded; only the on-disk journal survives.  Requires a durable
        journal (journal_dir), or there would be nothing to restart from.

        The dead Node object is not (cannot be) garbage-collected
        immediately: virtual-time timers scheduled before the kill still
        hold it.  Those ghosts are neutralized, not cancelled — their sink
        drops everything and their agent no longer fails the queue — which
        is exactly a killed process's externally observable behavior."""
        assert self.journal_dir is not None, \
            "kill_node without a durable journal loses acked state"
        assert node_id not in self.dead
        node = self.nodes[node_id]
        self.dead.add(node_id)
        # deliveries to the dead id vanish (SimNetwork checks registration)
        self.network.nodes.pop(node_id, None)
        node.sink = _DeadSink()
        node.journal = None  # a dead process journals nothing
        self.agents[node_id].dead = True
        self.pipelines.pop(node_id, None)
        self.qos_tiers.pop(node_id, None)
        auditor = self.auditors.pop(node_id, None)
        if auditor is not None:
            auditor.stop()
        # close the WAL file handles; un-synced OS buffers survive a
        # process kill, so nothing acked is lost (sync mode anyway)
        self.journal.close_node(node_id)

    def restart_node(self, node_id: int) -> "Node":
        """Bring a killed node back from its journal directory: build a
        fresh replica of the same identity, feed it every ledger epoch
        (start_sync=False — its state comes from the journal, not a peer
        bootstrap), replay the journal through normal message processing,
        and re-register it with the network.  Anything it missed while
        down heals exactly like a partition: later txns' deps name the
        missed ones and the progress log chases them."""
        assert node_id in self.dead, f"node {node_id} is not dead"
        node = self._build_node(node_id)
        self.dead.discard(node_id)
        self.restarts += 1
        wal = self.journal.wals[node_id]
        records = wal.load_records()
        from accord_tpu_torch.journal.replay import replay_node
        replay_node(node, records, registry=node.obs.registry,
                    flight=node.obs.flight)
        # end replay's defer mode: start live bootstraps only for whatever
        # the journaled checkpoints left uncovered
        node.resume_bootstraps()
        if self._durability_cycle_s is not None:
            from accord_tpu_torch.coordinate.durability import \
                CoordinateDurabilityScheduling
            CoordinateDurabilityScheduling(
                node, shard_cycle_s=self._durability_cycle_s,
                global_cycle_every=self._durability_global_every).start()
        if self._qos_enabled:
            self._build_qos_tier(node_id)
        if self._pipeline_enabled:
            from accord_tpu_torch.pipeline import Pipeline
            self.pipelines[node_id] = Pipeline(
                node, self.scheduler, self._pipeline_config,
                qos=self.qos_tiers.get(node_id))
        self._attach_auditor(node_id)
        return node

    # ----------------------------------------------------------- execution --
    def process_all(self, max_items: int = 1_000_000) -> int:
        return self.queue.drain(max_items=max_items)

    def process_until(self, predicate: Callable[[], bool],
                      max_items: int = 1_000_000) -> bool:
        n = 0
        while n < max_items:
            if predicate():
                return True
            if not self.queue.process_one():
                return predicate()
            n += 1
        return predicate()

    @property
    def now_s(self) -> float:
        return self.queue.clock.now_s()

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

    # -------------------------------------------------------- observability --
    def metrics_snapshot(self) -> dict:
        """Cluster-wide obs snapshot: per-node registries merged (counters/
        histograms sum, gauges max) plus the computed summary."""
        from accord_tpu_torch.obs.report import merge_node_snapshots
        return merge_node_snapshots(
            [n.obs.snapshot() for n in self.nodes.values()])

    def stitched_trace(self, trace_id: str):
        """One transaction's span events merged across every replica that
        recorded it: [(at_us, node_id, phase, tags)]."""
        from accord_tpu_torch.obs.spans import stitch
        return stitch([n.obs.spans for n in self.nodes.values()], trace_id)

    def find_trace_ids(self, phase: str = None, **tags):
        from accord_tpu_torch.obs.spans import find_trace_ids
        return find_trace_ids([n.obs.spans for n in self.nodes.values()],
                              phase=phase, **tags)

    def flight_recorders(self):
        return [n.obs.flight for n in self.nodes.values()]

    def stitched_flight(self, trace_ids=None, limit=None):
        """The cross-replica flight timeline (obs/flight.py): every node's
        always-on event ring merged into causal order, optionally filtered
        to a set of trace ids — the failure-forensics view."""
        from accord_tpu_torch.obs.flight import stitch_flight
        return stitch_flight(self.flight_recorders(), trace_ids=trace_ids,
                             limit=limit)
