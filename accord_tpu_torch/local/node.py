"""Node: the per-process runtime (reference: accord/local/Node.java:100-780).

Wires MessageSink / ConfigurationService / TopologyManager / CommandStores /
Agent / Scheduler; owns the HLC (uniqueNow, Node.java:341-366), txn-id
allocation (:562), coordination entry (:567-596), routing helpers (:598-673),
message receive + epoch gating (:715-736), and send helpers with
store-affine callbacks (:431-533).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from accord_tpu_torch.api.spi import (
    Agent, EventsListener, LocalConfig, MessageSink, ProgressLog, Scheduler,
)
from accord_tpu_torch.coordinate.errors import Timeout
from accord_tpu_torch.local.store import CommandStores, EmptyFanout, PreLoadContext
from accord_tpu_torch.obs.spans import trace_key as _trace_key
from accord_tpu_torch.messages.base import Callback, FailureReply, Reply, Request, TxnRequest
from accord_tpu_torch.primitives.keys import Keys, Ranges, Route, RoutingKey
from accord_tpu_torch.primitives.timestamp import Domain, Timestamp, TxnId, TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.topology.manager import TopologyManager
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult, success
from accord_tpu_torch.utils.random_source import RandomSource


class _SafeCallback:
    """Once-only callback wrapper with timeout arming (reference
    SafeCallback + Node timeout registration)."""

    def __init__(self, node: "Node", to: int, callback: Callback,
                 txn_id=None):
        self.node = node
        self.to = to
        self.callback = callback
        self.txn_id = txn_id  # watched coordination to credit progress to
        self.done = False
        self.timer = None

    def arm_timeout(self, delay_s: float) -> None:
        self.timer = self.node.scheduler.once(delay_s, self._on_timeout)

    def _on_timeout(self) -> None:
        if not self.done:
            self.done = True
            unregister = getattr(self, "sink_unregister", None)
            if unregister is not None:
                unregister()  # release the sink's msg-id entry (CallbackSink)
            try:
                self.callback.on_failure(self.to, Timeout())
            except BaseException as e:  # noqa: BLE001
                self.callback.on_callback_failure(self.to, e)

    def deliver(self, reply) -> None:
        if self.done:
            return
        self.done = True
        if self.timer is not None:
            self.timer.cancel()
        if self.txn_id is not None:
            # any genuine reply (even a remote failure) is liveness
            # evidence for the coordination's inactivity watchdog
            self.node.note_coordination_progress(self.txn_id)
        try:
            if isinstance(reply, FailureReply):
                self.callback.on_failure(self.to, reply.failure)
            elif isinstance(reply, BaseException):
                self.callback.on_failure(self.to, reply)
            else:
                self.callback.on_success(self.to, reply)
        except BaseException as e:  # noqa: BLE001
            self.callback.on_callback_failure(self.to, e)


class Node:
    def __init__(self, node_id: int, sink: MessageSink, agent: Agent,
                 scheduler: Scheduler, data_store, random: RandomSource,
                 num_shards: int = 1, config: LocalConfig = None,
                 progress_log_factory: Callable = None,
                 store_factory: Callable = None,
                 now_us: Callable[[], int] = None,
                 events: EventsListener = None,
                 trace=None, obs=None):
        from accord_tpu_torch.obs import CounterDict, NodeObs
        from accord_tpu_torch.utils.tracing import NO_TRACE
        self.id = node_id
        self.sink = sink
        self.agent = agent
        self.scheduler = scheduler
        self.data_store = data_store
        self.random = random
        self.trace = trace if trace is not None else NO_TRACE
        self.config = config or LocalConfig.default()
        # observability: one metrics registry + span store per node
        # (obs/ — instrumented by coordinators, stores, pipeline, hosts).
        # The clock indirection lets _now_us be assigned below.
        self.obs = obs if obs is not None else NodeObs(
            node_id, clock_us=lambda: self._now_us())
        self.topology = TopologyManager(node_id)
        self.command_stores = CommandStores(self, num_shards,
                                            store_factory=store_factory)
        self.events = events or EventsListener()
        self._progress_log_factory = progress_log_factory
        self._progress_logs: Dict[int, ProgressLog] = {}
        self._now_us = now_us or (lambda: 0)
        if obs is None:
            # the indirection above only existed because _now_us was not
            # yet assigned; rebind the obs/flight clocks directly so every
            # span/flight event saves a lambda hop (~37k clock reads per
            # 400-txn TCP run)
            self.obs._clock_us = self._now_us
            self.obs.flight._clock_us = self._now_us
        self._hlc = 0
        # (stripe, mod) congruence class for minted HLCs, or None: set only
        # by the shard worker runtime (set_hlc_stripe) — in-loop nodes mint
        # exactly as before
        self._hlc_stripe = None
        # optional side-effecting-message journal (sim/journal.Journal);
        # when set, every has_side_effects request is recorded at processing
        self.journal = None
        self.coordinating: Dict[TxnId, AsyncResult] = {}
        # txn_id -> last observable-progress time (s) for watched
        # coordinations; see _arm_coordination_watchdog
        self._coordination_activity: Dict[TxnId, float] = {}
        # txn_id -> recovery rounds started here, pruned once the txn's
        # local recovery future settles for good (storm-boundedness
        # metric: watchdog-driven retry must not mask livelock;
        # recovery_attempts_max keeps the high-water mark, burn-asserted)
        self.recovery_attempts: Dict[TxnId, int] = {}
        self.recovery_attempts_max = 0
        # the Infer ladder's A/B counters (coordinate/infer.py, reference
        # Infer.inferInvalidWithQuorum): evidence = CheckStatus merges whose
        # replies carried InvalidIf evidence; quorum_evidence = merges where
        # a per-shard QUORUM carried it (resolvable with ZERO extra rounds);
        # inferred_rounds = ballot-protected Invalidate rounds still paid on
        # evidence (sub-quorum, or the ACCORD_INFER_FULL=0 escape hatch);
        # no_round_commits = invalidations committed directly off quorum
        # evidence; fence_refusals = fresh witnesses refused below the
        # durable fence (local/commands.is_durably_fenced); safe_to_clean =
        # stragglers the cleanup sweep inferred invalid and erased.
        # Registry-backed with the old dict shape preserved (the r5 Infer
        # A/B harness reads these keys).
        self.infer_stats = CounterDict(
            self.obs.registry, "accord_infer_total",
            ("evidence", "quorum_evidence", "inferred_rounds",
             "no_round_commits", "fence_refusals", "safe_to_clean"))
        self._reply_seq = 0
        # epochs with a live shared refetch timer chain (_ensure_epoch_fetch)
        self._epoch_refetch: set = set()
        # spans with a staleness-escalation bootstrap in flight (dedup), and
        # spans that re-escalated while covered by an in-flight attempt
        # (needing a fresh fence once it completes)
        self._stale_bootstrapping: Ranges = Ranges.EMPTY
        self._stale_requeue: Ranges = Ranges.EMPTY
        # -- live elasticity (messages/admin.py, impl/config_service.py) --
        # the attached configuration service (set by attach_node), the
        # replay/defer flags crash-restart uses to suspend live side effects,
        # and the drain state the scale-in protocol maintains
        self.config_service = None
        self.replaying = False
        # while True, on_topology_update records newly-owned ranges instead
        # of starting live bootstraps (journal replay / restart feed);
        # resume_bootstraps() then starts only what checkpoints left uncovered
        self.defer_bootstrap = False
        self._deferred_bootstrap: Dict[int, Ranges] = {}
        # epoch -> coverage restored from journaled BootstrapCheckpoint
        # records; epochs whose BootstrapDone marker replayed
        self._ckpt_bootstrapped: Dict[int, Ranges] = {}
        self._bootstrap_complete: set = set()
        self.draining = False   # this node is fenced against new client work
        self.drained = False    # drain handoff finished; safe to retire
        self.draining_peers: set = set()  # peers to deprioritize as sources

    # ------------------------------------------------------------ lifecycle --
    def on_topology_update(self, topology: Topology, start_sync: bool = True
                           ) -> Ranges:
        """Feed a new epoch (reference Node.onTopologyUpdate :247-255):
        re-range the stores, bootstrap newly-owned ranges behind an
        ExclusiveSyncPoint fence, then broadcast epoch-sync completion so
        peers' TopologyManagers can unlock the epoch (§3.4). Returns the
        ranges newly owned by this node."""
        first = not self.topology.has_epoch(topology.epoch - 1) \
            and self.topology.min_epoch in (0, topology.epoch)
        if self.trace.enabled:
            self.trace.event("topology_update", epoch=topology.epoch)
        self.topology.on_topology_update(topology)
        owned = topology.ranges_for_node(self.id)
        added = self.command_stores.update_topology(owned)
        epoch = topology.epoch

        def synced(_v=None, _f=None):
            # honest start_sync: a FAILED bootstrap (bounded retries
            # exhausted) must not report the epoch synced — peers would
            # route reads at data this node never acquired
            if _f is None:
                self._broadcast_sync_complete(epoch, topology)

        if self.defer_bootstrap and not first and start_sync:
            # journal replay / restart feed: record what this epoch added
            # (stores are already re-ranged above) and let
            # resume_bootstraps() reconcile it against checkpointed
            # coverage once the journal has finished replaying
            self._deferred_bootstrap[epoch] = added
            return added
        if added.is_empty or first or not start_sync:
            # nothing to copy (or the genesis epoch: there is no data yet)
            for store in self.command_stores.intersecting(added):
                store.mark_safe_to_read(added)
            if start_sync:
                synced()
        else:
            from accord_tpu_torch.local.bootstrap import Bootstrap
            attempt = Bootstrap(self, added, epoch)
            attempt.result.add_callback(
                lambda v, f, e=epoch, r=added:
                self._journal_bootstrap_done(e, r) if f is None else None)
            attempt.result.add_callback(synced)
            attempt.start()
        return added

    def _broadcast_sync_complete(self, epoch: int, topology: Topology) -> None:
        from accord_tpu_torch.messages.epoch import EpochSyncComplete
        self.topology.on_epoch_sync_complete(self.id, epoch)
        for to in sorted(topology.nodes()):
            if to != self.id:
                self.send(to, EpochSyncComplete(epoch))

    def _journal_bootstrap_done(self, epoch: int, ranges: Ranges) -> None:
        self._bootstrap_complete.add(epoch)
        if self.journal is None or self.replaying:
            return
        from accord_tpu_torch.messages.admin import BootstrapDone
        self.journal.record(self.id, BootstrapDone(epoch, ranges))

    def resume_bootstraps(self) -> None:
        """End defer mode after a journal replay / restart feed: reconcile
        each deferred epoch's newly-owned ranges against the coverage its
        journaled BootstrapCheckpoint records restored, and bootstrap ONLY
        the remainder — a crash mid-bootstrap resumes from the checkpointed
        watermark instead of re-fetching completed ranges."""
        self.defer_bootstrap = False
        deferred, self._deferred_bootstrap = self._deferred_bootstrap, {}
        for epoch in sorted(deferred):
            added = deferred[epoch]
            restored = self._ckpt_bootstrapped.pop(epoch, Ranges.EMPTY)
            remaining = added.subtract(restored)
            topology = self.topology.for_epoch(epoch)
            if remaining.is_empty or epoch in self._bootstrap_complete:
                # every owned range is covered (checkpoints, or nothing was
                # added): the epoch is synced as far as this node goes
                for store in self.command_stores.intersecting(remaining):
                    store.mark_safe_to_read(remaining)
                self._broadcast_sync_complete(epoch, topology)
                continue
            from accord_tpu_torch.local.bootstrap import Bootstrap
            attempt = Bootstrap(self, remaining, epoch)

            def finished(_v, _f, e=epoch, t=topology, r=added):
                if _f is None:
                    self._journal_bootstrap_done(e, r)
                    self._broadcast_sync_complete(e, t)

            attempt.result.add_callback(finished)
            attempt.start()

    def mark_stale_and_bootstrap(self, ranges: Ranges) -> None:
        """Re-acquire `ranges` wholesale after local per-txn catch-up proved
        impossible (peers truncated the deps): the staleness escalation path
        (reference Agent.onStale / markShardStale -> Bootstrap).

        Spans already being bootstrapped are not dropped — the in-flight
        attempt's ESP fence may PREDATE the txn that just wedged (its
        snapshot will not contain it), so they are queued and re-escalated
        with a fresh fence once the in-flight attempt finishes."""
        overlapping = ranges.slice(self._stale_bootstrapping)
        if not overlapping.is_empty:
            self._stale_requeue = self._stale_requeue.union(overlapping)
        remaining = ranges.subtract(self._stale_bootstrapping)
        if remaining.is_empty:
            return
        self._stale_bootstrapping = self._stale_bootstrapping.union(remaining)
        self.agent.on_stale(self.unique_now(), remaining)
        from accord_tpu_torch.local.bootstrap import Bootstrap
        attempt = Bootstrap(self, remaining, self.epoch)
        attempt.result.add_callback(
            lambda v, f: self._stale_bootstrap_done(remaining))
        attempt.start()

    def _stale_bootstrap_done(self, finished: Ranges) -> None:
        self._stale_bootstrapping = self._stale_bootstrapping.subtract(finished)
        requeue = self._stale_requeue.slice(finished)
        if not requeue.is_empty:
            self._stale_requeue = self._stale_requeue.subtract(requeue)
            self.mark_stale_and_bootstrap(requeue)

    def progress_log_for(self, store) -> ProgressLog:
        pl = self._progress_logs.get(store.id)
        if pl is None:
            if self._progress_log_factory is None:
                pl = ProgressLog.__new__(_NullProgressLog)
            else:
                pl = self._progress_log_factory(self, store)
            self._progress_logs[store.id] = pl
        return pl

    # ------------------------------------------------------------------ HLC --
    def now_us(self) -> int:
        """Wall (or virtual) clock in microseconds."""
        return self._now_us()

    def unique_now(self) -> Timestamp:
        """Monotonic unique HLC (Node.uniqueNow CAS loop, :341-366)."""
        self._hlc = self._striped(max(self._hlc + 1, self._now_us()))
        return Timestamp(self.epoch, self._hlc, 0, self.id)

    def unique_now_at_least(self, at_least: Timestamp) -> Timestamp:
        self._hlc = self._striped(
            max(self._hlc + 1, self._now_us(), at_least.hlc + 1))
        epoch = max(self.epoch, at_least.epoch)
        return Timestamp(epoch, self._hlc, 0, self.id)

    def set_hlc_stripe(self, stripe: int, mod: int) -> None:
        """Worker runtime (shard/): N processes mint under ONE node id, so
        each confines its HLCs to a congruence class — same-id collisions
        become impossible without any cross-process clock coordination."""
        self._hlc_stripe = (stripe, mod)

    def _striped(self, hlc: int) -> int:
        if self._hlc_stripe is None:
            return hlc
        s, m = self._hlc_stripe
        return hlc + ((s - hlc) % m)

    def on_remote_timestamp(self, ts: Timestamp) -> None:
        """Merge a remote HLC observation (epoch/hlc propagation)."""
        if ts.hlc > self._hlc:
            self._hlc = ts.hlc

    @property
    def epoch(self) -> int:
        return max(1, self.topology.epoch)

    def next_txn_id(self, kind: TxnKind, domain: Domain) -> TxnId:
        now = self.unique_now()
        return TxnId.create(now.epoch, now.hlc, kind, domain, self.id)

    # -------------------------------------------------------------- routing --
    def compute_route(self, txn: Txn) -> Route:
        """Home-key selection (Node.java:598-617): a routing key from the
        txn's participants, preferring one this node owns."""
        if isinstance(txn.keys, Keys):
            routing = txn.keys.as_routing()
            invariants.check_argument(len(routing) > 0, "txn has no keys")
            home = self._select_home_key(list(routing))
            return Route.of_keys(home, routing)
        ranges = txn.keys
        invariants.check_argument(len(ranges) > 0, "txn has no ranges")
        home = self._select_home_key(
            [RoutingKey(r.start) for r in ranges])
        return Route.of_ranges(home, ranges)

    def _select_home_key(self, candidates: List[RoutingKey]) -> RoutingKey:
        local = self.topology.current().ranges_for_node(self.id)
        for k in candidates:
            if local.contains(k):
                return k
        return candidates[0]

    # --------------------------------------------------------- coordination --
    def coordinate(self, txn: Txn, txn_id: Optional[TxnId] = None
                   ) -> AsyncResult:
        """Client entry: coordinate a transaction to its Result
        (Node.coordinate :567-596)."""
        from accord_tpu_torch.coordinate.ephemeral import CoordinateEphemeralRead
        from accord_tpu_torch.coordinate.transaction import CoordinateTransaction
        domain = Domain.KEY if isinstance(txn.keys, Keys) else Domain.RANGE
        if txn_id is None:
            txn_id = self.next_txn_id(txn.kind, domain)
        result = AsyncResult()
        if self.trace.enabled:
            self.trace.event("coordinate", txn_id=txn_id, kind=txn.kind.name)
        self.obs.txn_begin(txn_id, kind=txn.kind.name)
        result.add_callback(lambda v, f: self.obs.txn_end(txn_id, f))
        if txn.kind == TxnKind.EPHEMERAL_READ:
            # invisible single-round read: no recovery registration
            self.with_epoch(txn_id.epoch,
                            lambda: CoordinateEphemeralRead(
                                self, txn_id, txn, result).start())
            return result
        self.coordinating[txn_id] = result
        result.add_callback(lambda v, f: self.coordinating.pop(txn_id, None))
        self._arm_coordination_watchdog(txn_id, result, "coordination")
        self.with_epoch(txn_id.epoch,
                        lambda: CoordinateTransaction(self, txn_id, txn,
                                                      result).start())
        return result

    def recover(self, txn_id: TxnId, route: Route) -> AsyncResult:
        """Recovery entry (Node.recover :685)."""
        from accord_tpu_torch.coordinate.recover import Recover
        existing = self.coordinating.get(txn_id)
        if existing is not None:
            return existing
        result = AsyncResult()
        self.coordinating[txn_id] = result
        result.add_callback(lambda v, f: self.coordinating.pop(txn_id, None))
        self._arm_coordination_watchdog(txn_id, result, "recovery")
        n_attempts = self.recovery_attempts.get(txn_id, 0) + 1
        self.recovery_attempts[txn_id] = n_attempts
        self.recovery_attempts_max = max(self.recovery_attempts_max,
                                         n_attempts)
        result.add_callback(
            lambda v, f: None if f is not None
            else self.recovery_attempts.pop(txn_id, None))
        if self.trace.enabled:
            self.trace.event("recover", txn_id=txn_id)
        self.obs.txn_begin(txn_id, path="recovery")
        result.add_callback(
            lambda v, f: self.obs.txn_end(txn_id, f, path="recovery"))
        self.with_epoch(txn_id.epoch,
                        lambda: Recover(self, txn_id, route, result).start())
        return result

    def invalidate(self, txn_id: TxnId, some_route: Route) -> AsyncResult:
        """Multi-shard invalidation entry, for txns we hold only partial
        route knowledge of (Invalidate.invalidate); doubles as route
        discovery and escalates to Recover if anything was witnessed."""
        from accord_tpu_torch.coordinate.invalidate import Invalidate
        existing = self.coordinating.get(txn_id)
        if existing is not None:
            return existing
        result = AsyncResult()
        self.coordinating[txn_id] = result
        result.add_callback(lambda v, f: self.coordinating.pop(txn_id, None))
        self._arm_coordination_watchdog(txn_id, result, "invalidation")
        if self.trace.enabled:
            self.trace.event("invalidate", txn_id=txn_id)
        self.obs.txn_begin(txn_id, path="invalidation")
        result.add_callback(
            lambda v, f: self.obs.txn_end(txn_id, f, path="invalidation"))
        self.with_epoch(txn_id.epoch,
                        lambda: Invalidate(self, txn_id, some_route,
                                           result).start())
        return result

    def _arm_coordination_watchdog(self, txn_id: TxnId, result: AsyncResult,
                                   what: str) -> None:
        """Force-fail a coordination/recovery/invalidation future that
        outlives every plausible sequence of its RPC rounds.  These futures are
        deduplicated through `coordinating`, so ANY code path that fails to
        settle (a round that sent zero messages, a reply handler that
        returns without continuing) otherwise pins a dead future there
        forever — after which the progress log's escalations all no-op and
        a wedged txn is never repaired (seed-15003 soak: an acked write
        was lost to exactly that).  The watchdog converts such a bug into a
        bounded stall: the failure pops the dedup entry and the next
        escalation starts a fresh coordinator."""
        timeout_s = (self.agent.pre_accept_timeout()
                     * self.config.rpc_timeout_multiplier
                     * self.config.coordination_watchdog_multiplier)
        hard_s = timeout_s \
            * self.config.coordination_watchdog_hard_cap_multiplier
        start = self.now_us() / 1e6
        self._coordination_activity[txn_id] = start
        state = {}

        def fire():
            now = self.now_us() / 1e6
            last = self._coordination_activity.get(txn_id, start)
            if now - last < timeout_s and now - start < hard_s:
                # observable progress since the last check (replies
                # received, retries started): a slow-but-live coordination
                # must not be force-failed (ADVICE r3) — re-arm for the
                # remaining inactivity window, bounded by the hard cap
                remaining = min(timeout_s - (now - last),
                                hard_s - (now - start))
                state["timer"] = self.scheduler.once(max(remaining, 1e-3),
                                                     fire)
                return
            if now - start >= hard_s and now - last < timeout_s:
                reason = (f"exceeded the {hard_s:.1f}s hard cap while still "
                          f"exchanging messages (livelocked coordination)")
            else:
                reason = (f"saw no progress for {timeout_s:.1f}s "
                          f"(non-settling coordination path)")
            result.try_failure(Timeout(f"{what} of {txn_id} {reason}"))

        state["timer"] = self.scheduler.once(timeout_s, fire)
        result.add_callback(lambda v, f: (
            state["timer"].cancel(),
            self._coordination_activity.pop(txn_id, None)))

    def note_coordination_progress(self, txn_id: TxnId) -> None:
        """Record observable progress on a watched coordination so its
        inactivity watchdog re-arms instead of firing (see
        _arm_coordination_watchdog).  Called on every reply delivered to a
        send carrying a coordinating txn's id."""
        if txn_id in self._coordination_activity:
            self._coordination_activity[txn_id] = self.now_us() / 1e6

    def with_epoch(self, epoch: int, fn: Callable[[], None]) -> None:
        """Run fn once `epoch` is locally known (Node.withEpoch)."""
        if self.topology.has_epoch(epoch):
            fn()
            return
        self.topology.await_epoch(epoch).add_callback(
            lambda v, f: fn() if f is None else self.agent
            .on_uncaught_exception(f))
        self._ensure_epoch_fetch(epoch)

    def _ensure_epoch_fetch(self, epoch: int) -> None:
        """ONE 1 Hz refetch chain per pending epoch, shared by every waiter
        (with_epoch and receive()'s gate alike): a transient topology-fetch
        failure must not wedge waiters, so the (deduplicated) fetch re-arms
        until the epoch lands; gossip resolving the pending future first
        stops the chain."""
        if epoch in self._epoch_refetch or self.topology.has_epoch(epoch):
            return
        self._epoch_refetch.add(epoch)
        pending = self.topology.await_epoch(epoch)

        def tick():
            if pending.is_done:
                self._epoch_refetch.discard(epoch)
                return
            self.topology.await_epoch(epoch)       # re-triggers the hook
            self.scheduler.once(1.0, tick)

        self.scheduler.once(1.0, tick)

    # ------------------------------------------------------------ messaging --
    def send(self, to_nodes, request: Request,
             callback: Optional[Callback] = None,
             timeout_s: Optional[float] = None) -> None:
        """Send to one or many nodes, optionally registering a reply callback
        with timeout (Node.send helpers :431-533)."""
        if isinstance(to_nodes, int):
            to_nodes = [to_nodes]
        watched = getattr(request, "txn_id", None)
        if watched is not None and getattr(request, "trace_id", None) is None:
            # stamp the trace id once: the structural wire codec round-trips
            # instance attributes, so every replica can stitch this request
            # into the transaction's span (obs/spans.py)
            try:
                request.trace_id = _trace_key(watched)
            except AttributeError:
                pass  # slotted request without __dict__: not traceable
        if watched is not None and watched not in self._coordination_activity:
            watched = None
        mt = request.type
        verb = mt.label if mt is not None else type(request).__name__
        flight = self.obs.flight
        tid = getattr(request, "trace_id", None)
        for to in to_nodes:
            flight.record("tx", tid, (to, verb))
            if callback is not None:
                safe = _SafeCallback(self, to, callback, txn_id=watched)
                safe.arm_timeout(timeout_s if timeout_s is not None
                                 else self.agent.pre_accept_timeout()
                                 * self.config.rpc_timeout_multiplier)
                self.sink.send_with_callback(to, request, safe)
            else:
                self.sink.send(to, request)

    def send_to_route(self, route, min_epoch: int, max_epoch: int, make_msg,
                      callback=None):
        """Fan a message out to every node owning part of `route` across the
        epoch window, with per-destination scope slicing; returns the
        Topologies used (for tracker construction). `make_msg(to, scope)`
        builds each message; None skips that destination."""
        from accord_tpu_torch.messages.base import TxnRequest
        topologies = self.topology.with_unsynced_epochs(
            route.participants(), min_epoch, max_epoch)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, route)
            if scope is None:
                continue
            msg = make_msg(to, scope)
            if msg is not None:
                self.send(to, msg, callback=callback)
        return topologies

    def reply(self, to: int, reply_context, reply: Reply) -> None:
        mt = reply.type
        self.obs.flight.record(
            "reply", None,
            (to, mt.label if mt is not None else type(reply).__name__))
        prof = self.obs.cpuprof
        if prof.active:
            # inside a sampled dispatch (obs/cpuprof.py): the sink's encode
            # + egress work is the "reply_encode" stage of the waterfall.
            # (Binary-tier TCP packs at flush time, outside the dispatch —
            # that cost shows in the loop tick gauge instead.)
            t = prof.stage_begin()
            self.sink.reply(to, reply_context, reply)
            prof.stage_end(t, "reply_encode")
            return
        self.sink.reply(to, reply_context, reply)

    def receive(self, request: Request, from_id: int, reply_context) -> None:
        """Inbound dispatch with epoch gating (Node.receive :715-736)."""
        wait_for = request.wait_for_epoch
        if wait_for and not self.topology.has_epoch(wait_for):
            self.topology.await_epoch(wait_for).add_callback(
                lambda v, f: self._process(request, from_id, reply_context))
            self._ensure_epoch_fetch(wait_for)
            return
        self._process(request, from_id, reply_context)

    def _process(self, request: Request, from_id: int, reply_context) -> None:
        # HLC merge on receipt: every timestamp this node witnesses must be
        # absorbed so its next mint sorts after it.  Witnessing used to
        # absorb incidentally (propose_execute_at's unique_now_at_least),
        # but the Infer ladder's fence refusal declines to witness at all —
        # without the explicit merge a refused replica's clock could trail
        # journaled remote timestamps, and a crash between the refusal and
        # the next local mint would rely solely on the replay HLC fold for
        # the never-reissue-a-used-TxnId guarantee (tests/test_wal.py pins
        # the live half of it).
        req_txn_id = getattr(request, "txn_id", None)
        if req_txn_id is not None:
            self.on_remote_timestamp(req_txn_id)
        req_execute_at = getattr(request, "execute_at", None)
        if req_execute_at is not None:
            self.on_remote_timestamp(req_execute_at)
        tid = getattr(request, "trace_id", None)
        mt = request.type
        verb = mt.label if mt is not None else type(request).__name__
        self.obs.flight.record("rx", tid, (from_id, verb))
        if tid is not None:
            # stitch this replica into the transaction's cross-node span
            self.obs.rx(tid, verb, from_id)
        if self.journal is not None and request.type is not None \
                and request.type.has_side_effects \
                and not (self.command_stores.remote
                         and isinstance(request, TxnRequest)):
            # journal-where-processed: under the shard worker runtime a
            # TxnRequest's side effects land in a WORKER's stores, and the
            # worker appends it to its own WAL band before executing — the
            # parent journaling it too would double-replay on restart
            self.journal.record(self.id, request)
        # protocol-CPU attribution (obs/cpuprof.py, ACCORD_CPU_PROFILE=N):
        # bracket the dispatch so its wall time decomposes into the
        # decode/apply/cfk/reply-encode waterfall, labeled by verb.  With
        # profiling off this is ONE attribute check (obs-budget-gated).
        prof = self.obs.cpuprof
        sampled = prof.enabled and prof.dispatch_begin(verb)
        try:
            request.process(self, from_id, reply_context)
        except BaseException as e:  # noqa: BLE001
            if reply_context is not None:
                self.reply(from_id, reply_context, FailureReply(e))
            else:
                self.agent.on_uncaught_exception(e)
        finally:
            if sampled:
                prof.dispatch_end()

    def local_request(self, request: Request) -> None:
        """Apply a local-only request (PROPAGATE_*) to our own stores."""
        if self.journal is not None and request.type is not None \
                and request.type.has_side_effects \
                and not (self.command_stores.remote
                         and isinstance(request, TxnRequest)):
            self.journal.record(self.id, request)
        request.process(self, self.id, None)

    # ------------------------------------------------- store fan-out/reduce --
    def map_reduce_consume_local(self, request: TxnRequest, from_id: int,
                                 reply_context) -> None:
        """Fan a TxnRequest out over intersecting command stores, reduce the
        replies (async-aware), reply to the sender
        (Node.mapReduceConsumeLocal :405 -> CommandStores.mapReduceConsume).
        The fan-out itself lives on CommandStores so the worker runtime
        (shard/) can route it across per-shard processes unchanged."""

        def consume(value, failure):
            if reply_context is None:
                if failure is not None and not isinstance(failure, EmptyFanout):
                    self.agent.on_uncaught_exception(failure)
                return
            if failure is not None:
                self.reply(from_id, reply_context, FailureReply(failure))
                return
            self.reply(from_id, reply_context, value)

        self.command_stores.map_reduce_request(request, consume)


class _NullProgressLog(ProgressLog):
    pass
