"""The burn test: randomized full-cluster simulation with verification.

Reference: accord-core test burn/BurnTest.java:316-553 + impl/basic/Cluster
(SURVEY.md §4a): a seeded workload of multi-key reads/writes/RMWs driven
through a simulated cluster; every response feeds the strict-serializability
verifier; acks/nacks/timeouts are tallied and asserted non-pathological;
everything derives from one seed (`--loop-seed` reproduction).

Usage:  python -m accord_tpu_torch.sim.burn -s SEED -o OPS [--nodes N] [--drop P]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.impl.list_store import (ListQuery, ListRangeRead, ListRead,
                                        ListResult, ListUpdate)
from accord_tpu_torch.primitives.keys import Key, Keys, Ranges
from accord_tpu_torch.primitives.timestamp import TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.sim.cluster import SimCluster
from accord_tpu_torch.sim.network import LinkConfig
from accord_tpu_torch.sim.verify import Observation, StrictSerializabilityVerifier
from accord_tpu_torch.utils.random_source import RandomSource


class BurnStats:
    def __init__(self):
        self.acks = 0
        self.nacks = 0
        # pipeline admission sheds (typed Rejected: never coordinated, safe
        # to retry) — surfaced in the summary as their own tally instead of
        # being folded into nacks, so a shedding run is distinguishable
        # from a failing one
        self.shed = 0
        self.lost = 0
        self.pending = 0
        # crash-restart nemesis: nodes killed (process death) and brought
        # back from their on-disk journal mid-run
        self.restarts = 0
        # submit->ack VIRTUAL latency per acked op (us): the measurement for
        # SURVEY §7's flush-window-latency hard part — the batched device
        # store must not inflate the fast path's single-round-trip advantage
        self.ack_latencies_us: list = []

    def latency_us(self, pct: float) -> int:
        """Nearest-rank percentile (0..100] of acked-op latency; -1 with no
        acks."""
        if not self.ack_latencies_us:
            return -1
        s = sorted(self.ack_latencies_us)
        rank = math.ceil(len(s) * pct / 100.0)
        return s[min(len(s) - 1, max(0, rank - 1))]

    def __repr__(self):
        return (f"acks={self.acks} nacks={self.nacks} shed={self.shed} "
                f"lost={self.lost} pending={self.pending}"
                + (f" restarts={self.restarts}" if self.restarts else ""))


class BurnRun:
    def __init__(self, seed: int, ops: int, nodes: int = 3, keys: int = 20,
                 drop_prob: float = 0.0, rf: int = None, n_shards: int = 4,
                 concurrency: int = 8,
                 progress_log_factory="default", num_command_stores: int = 1,
                 range_reads: bool = True, range_every: int = 8,
                 durability: bool = True,
                 durability_cycle_s: float = None,
                 topology_changes: bool = True,
                 topology_period_s: float = 3.0,
                 store_factory=None,
                 partitions: bool = False,
                 partition_period_s: float = 8.0,
                 clock_drift: bool = False,
                 trace: bool = False,
                 pipeline: bool = False,
                 pipeline_config=None,
                 qos: bool = False,
                 qos_config=None,
                 restarts: int = 0,
                 journal_dir: Optional[str] = None,
                 restart_down_s: float = 2.0,
                 eph_ratio: float = 0.0,
                 audit: bool = True,
                 audit_live_s: float = 0.0,
                 census_live_s: float = 0.0,
                 audit_kw: Optional[dict] = None,
                 corrupt_at: Optional[int] = None,
                 corrupt_invalidated: bool = False,
                 geo=None,
                 electorate=None,
                 dc_partitions: bool = False,
                 dc_partition_period_s: float = 2.0):
        if progress_log_factory == "default":
            # the progress log is a required component under message loss: an
            # acked txn whose Apply messages are all dropped is only repaired
            # by recovery (the reference burn always runs SimpleProgressLog)
            from accord_tpu_torch.impl.progress_log import SimpleProgressLog
            progress_log_factory = SimpleProgressLog
        self.seed = seed
        self.ops = ops
        self.rng = RandomSource(seed)
        # crash-restart nemesis needs a REAL journal to restart from: a
        # killed node's in-memory state is discarded wholesale (process
        # death), so the cluster journal becomes per-node on-disk WALs
        # (accord_tpu_torch/journal/) instead of the in-memory message list
        self.restarts = restarts
        self.restart_down_s = restart_down_s
        if restarts > 0 and journal_dir is None:
            import tempfile
            journal_dir = tempfile.mkdtemp(prefix="accord-burn-wal-")
        self.journal_dir = journal_dir
        self.cluster = SimCluster(
            n_nodes=nodes, seed=self.rng.next_long(), n_shards=n_shards,
            rf=rf, progress_log_factory=progress_log_factory,
            num_command_stores=num_command_stores,
            store_factory=store_factory, clock_drift=clock_drift,
            journal_dir=journal_dir,
            trace=trace, pipeline=pipeline,
            pipeline_config=pipeline_config,
            qos=qos, qos_config=qos_config,
            geo=geo, electorate=electorate)
        # QoS arm: ops carry a randomized tenant (t0..t2) and priority
        # class; per-class outcomes are tallied CLIENT-side (exact across
        # crash-restarts, which reset a node's registry counters) so the
        # fairness invariant — high is never QoS-shed while best_effort is
        # being admitted — is assertable from the run alone
        self.qos = qos
        self.qos_class_stats: Dict[str, Dict[str, int]] = {}
        if drop_prob > 0:
            self.cluster.network.default_link = LinkConfig(
                deliver_prob=1.0 - drop_prob)
        self.partition_nemesis = None
        if partitions:
            from accord_tpu_torch.sim.network import PartitionNemesis
            self.partition_nemesis = PartitionNemesis(
                self.cluster.network, self.cluster.queue, self.rng.fork(),
                list(self.cluster.nodes), period_s=partition_period_s)
            self.partition_nemesis.start()
        # DC-partition nemesis (geo arm): periodically sever one whole
        # datacenter and heal it — the fast-path ratio degrades while an
        # electorate DC is dark and recovers after heal; every begin/heal
        # lands on the flight rings (dc_partition_begin/heal)
        self.dc_partition_nemesis = None
        if dc_partitions:
            assert geo is not None, "dc_partitions needs a geo profile"
            from accord_tpu_torch.sim.network import DcPartitionNemesis
            self.dc_partition_nemesis = DcPartitionNemesis(
                self.cluster.network, self.cluster.queue, self.rng.fork(),
                geo, period_s=dc_partition_period_s)
            self.dc_partition_nemesis.start()
        self.keys = keys
        self.concurrency = concurrency
        self.range_reads = range_reads
        self.range_every = range_every
        # read-heavy ephemeral lane: this fraction of ops become
        # single-key Zipf reads on the EPHEMERAL_READ path, putting the
        # never-witnessed single-round read under the full nemesis stack
        # (the default mix only reaches it via occasional 1-key pure reads)
        self.eph_ratio = eph_ratio
        if durability:
            # randomized cadence like the reference burn (Cluster.java:333)
            cycle = (durability_cycle_s if durability_cycle_s is not None
                     else 5.0 + self.rng.next_float() * 25.0)
            self.cluster.start_durability_scheduling(shard_cycle_s=cycle)
        self.nemesis = None
        if topology_changes:
            from accord_tpu_torch.sim.topology_nemesis import TopologyRandomizer
            self.nemesis = TopologyRandomizer(self.cluster, self.rng.fork(),
                                              period_s=topology_period_s)
            self.nemesis.start()
        # three unrelated checking algorithms must all pass, like the
        # reference's own verifier composed with Elle (CompositeVerifier +
        # ElleVerifier.java:47): cycle detection on the constraint graph,
        # explicit witness construction + model replay, and the ported
        # Elle list-append analysis (sim/elle.py — version orders inferred
        # from reads, SCC cycle search, anomaly classification)
        from accord_tpu_torch.sim.verify_replay import full_verifier
        self.verifier = full_verifier()
        # failure forensics (obs/flight.py): acked results map their client
        # txn_desc to the protocol trace id (ListResult carries the TxnId),
        # so a checker Violation naming an observation stitches that txn's
        # cross-replica flight timeline into the failure artifact
        self.verifier.attach_forensics(self._forensics)
        self._trace_of_desc: Dict[str, str] = {}
        self.flight_artifact: Optional[str] = None
        self._last_forensics_events = None
        # test hook: mutate the observation list before verification (an
        # injected invariant violation exercising the forensics path —
        # tests/test_flight.py)
        self.fault_injector = None
        # replica-state auditor (local/audit.py): passive auditors on every
        # node for the ALWAYS-ON end-of-run digest+census checker; live
        # periodic auditing (the production cadence) via audit_live_s /
        # census_live_s.  The corruption nemesis (sim/corruption.py)
        # silently mutates one replica's decided state mid-run — the
        # divergence the end-of-run checker must then report.
        self.audit = audit
        if audit:
            self.cluster.attach_auditors(interval_s=audit_live_s,
                                         census_interval_s=census_live_s,
                                         **(audit_kw or {}))
        self._corrupt_at = corrupt_at
        self._corrupt_invalidated = corrupt_invalidated
        self.corrupted_txn = None
        self.corrupted_node: Optional[int] = None
        self.audit_rounds: list = []
        self.stats = BurnStats()
        self.next_value = 0
        self._value_owner: Dict[int, dict] = {}
        # crash-restart nemesis schedule: kill #i fires once the completed-
        # op count crosses its threshold (mid-run by construction), restart
        # follows restart_down_s of virtual downtime later
        self._kill_at = [self.ops * (i + 1) // (restarts + 1)
                         for i in range(restarts)]
        self.restarted_nodes: List[int] = []

    # ---------------------------------------------------------- workload --
    def _gen_txn(self) -> Txn:
        rng = self.rng
        if self.eph_ratio and rng.next_float() < self.eph_ratio:
            token = rng.next_zipf(self.keys)
            return Txn(TxnKind.EPHEMERAL_READ, Keys.of(token),
                       read=ListRead(Keys.of(token)), query=ListQuery())
        # ~1 in range_every ops: a range read over a token window (the
        # reference burn mixes range queries in, BurnTest.java:124-210)
        if self.range_reads and rng.next_int(0, self.range_every) == 0:
            lo = rng.next_int(0, self.keys - 1)
            hi = min(self.keys, lo + 1 + rng.next_int(1, max(2, self.keys // 4)))
            ranges = Ranges.of((lo, hi))
            return Txn(TxnKind.READ, ranges, read=ListRangeRead(ranges),
                       query=ListQuery())
        n_read = rng.next_int(0, 3)
        n_write = rng.next_int(0, 3) if n_read else rng.next_int(1, 3)
        read_tokens = {rng.next_zipf(self.keys) for _ in range(n_read)}
        write_tokens = {rng.next_zipf(self.keys) for _ in range(n_write)}
        appends = {}
        for t in write_tokens:
            appends[t] = self.next_value
            self.next_value += 1
        all_tokens = read_tokens | write_tokens
        # RMWs read what they write (the strongest check)
        read_set = read_tokens | (write_tokens if rng.next_bool() else set())
        if not appends and len(read_set) == 1:
            # single-key pure reads go the ephemeral (single-round, invisible)
            # path, as the reference burn does (BurnTest.java:124-210)
            return Txn(TxnKind.EPHEMERAL_READ, Keys.of(*read_set),
                       read=ListRead(Keys.of(*read_set)), query=ListQuery())
        return Txn(
            TxnKind.WRITE if appends else TxnKind.READ,
            Keys.of(*all_tokens),
            read=ListRead(Keys.of(*read_set)) if read_set else None,
            query=ListQuery(),
            update=ListUpdate({Key(t): v for t, v in appends.items()})
            if appends else None)

    # -------------------------------------------------- crash-restart -----
    def _maybe_kill(self) -> None:
        """Fire the next scheduled kill once enough ops completed.  The
        kill itself runs as its own queue event (not inside a client
        callback's stack), the restart after `restart_down_s` of virtual
        downtime.  Kills never overlap: a due threshold waits while a
        previous victim is still down."""
        if not self._kill_at or self.cluster.dead:
            return
        done_ops = (self.stats.acks + self.stats.nacks + self.stats.shed
                    + self.stats.lost)
        if done_ops < self._kill_at[0]:
            return
        self._kill_at.pop(0)
        victim = self.rng.pick(self.cluster.live_node_ids())
        down_us = int(self.restart_down_s * 1e6)
        queue = self.cluster.queue

        def do_restart():
            self.cluster.restart_node(victim)
            self.stats.restarts += 1
            self.restarted_nodes.append(victim)

        def do_kill():
            self.cluster.kill_node(victim)
            queue.add(down_us, do_restart)

        queue.add(0, do_kill)

    # ---------------------------------------------------- corruption arm --
    def _maybe_corrupt(self) -> None:
        """Fire the scheduled out-of-band corruption once enough ops
        completed: silently mutate one committed-below-universal command on
        a random live replica (sim/corruption.py).  Eligibility depends on
        the durability rounds having certified a window — retried on a
        virtual-time backoff until a victim txn exists."""
        if self._corrupt_at is None or self.corrupted_txn is not None:
            return
        done_ops = (self.stats.acks + self.stats.nacks + self.stats.shed
                    + self.stats.lost)
        if done_ops < self._corrupt_at:
            return
        self._corrupt_at = None  # schedule exactly one injection chain
        victim = self.rng.pick(self.cluster.live_node_ids())

        def do_corrupt():
            from accord_tpu_torch.sim.corruption import corrupt_below_universal
            txn = corrupt_below_universal(
                self.cluster, victim,
                flip_invalidated=self._corrupt_invalidated)
            if txn is None:
                # no certified window yet: wait for a durability round
                self.cluster.queue.add(1_000_000, do_corrupt)
                return
            self.corrupted_txn = txn
            self.corrupted_node = victim

        self.cluster.queue.add(0, do_corrupt)

    # ------------------------------------------------ end-of-run auditing --
    def _run_end_audit(self) -> None:
        """The always-on audit checker: at quiesce every shard's digests
        must agree across its replicas (at whatever truncation points they
        reached), and any recorded divergence fails the burn with the
        divergent txn's stitched cross-replica flight timeline.  Rounds a
        lossy link left inconclusive are retried a few passes; live-audit
        timers are stopped first so passes do not interleave."""
        auditors = self.cluster.auditors
        for a in auditors.values():
            a.stop()
            a.census_once()
        for _attempt in range(4):
            done = {}
            for nid, a in auditors.items():
                a.audit_once(on_done=lambda r, n=nid: done.__setitem__(n, r))
            self.cluster.process_until(
                lambda: len(done) == len(auditors), max_items=2_000_000)
            reports = [r for r in done.values() if r is not None]
            outcomes = [rd["outcome"] for r in reports
                        for rd in r["rounds"]]
            if outcomes and "inconclusive" not in outcomes:
                break
        self.audit_rounds = [rd for r in reports for rd in r["rounds"]]
        divs = [d for a in auditors.values() for d in a.divergences]

        def check():
            assert not divs, (
                "audit divergence: " + "; ".join(
                    f"txn {d['txn']} {d['kind']} on range "
                    f"[{d['range'][0]},{d['range'][1]}) across nodes "
                    f"{sorted(d['nodes'])} (replicas {d['replicas']})"
                    for d in divs[:4]))

        self._with_flight_artifact(check)

    # --------------------------------------------------------------- run --
    def run(self) -> BurnStats:
        cluster = self.cluster
        submitted = [0]
        inflight = [0]
        observations = []

        def submit_one():
            if submitted[0] >= self.ops:
                return
            submitted[0] += 1
            idx = submitted[0]
            inflight[0] += 1
            txn = self._gen_txn()
            # clients only reach live nodes (a killed node's socket is gone)
            origin = self.rng.pick(cluster.live_node_ids())
            tenant = priority = ""
            if self.qos:
                tenant = f"t{self.rng.next_int(3)}"
                roll = self.rng.next_float()
                priority = ("high" if roll < 0.2
                            else "normal" if roll < 0.7 else "best_effort")
            start_us = cluster.queue.clock.now_us
            result = cluster.pipeline_submit(origin, txn, tenant, priority)

            def done(value, failure):
                from accord_tpu_torch.pipeline.backpressure import Rejected
                from accord_tpu_torch.qos import QosRejected
                inflight[0] -= 1
                end_us = cluster.queue.clock.now_us
                if priority:
                    cs = self.qos_class_stats.setdefault(
                        priority, {"acked": 0, "qos_shed": 0,
                                   "qos_throttle": 0, "inner_shed": 0,
                                   "failed": 0, "lost": 0})
                    if isinstance(failure, QosRejected):
                        cs["qos_" + failure.reason] += 1
                    elif isinstance(failure, Rejected):
                        cs["inner_shed"] += 1
                    elif failure is not None:
                        cs["failed"] += 1
                    elif isinstance(value, ListResult):
                        cs["acked"] += 1
                    else:
                        cs["lost"] += 1
                if isinstance(failure, Rejected):
                    # admission shed: its own summary tally (the txn was
                    # never coordinated — folding it into nacks hid every
                    # pipeline shed inside the failure count)
                    self.stats.shed += 1
                elif failure is not None:
                    self.stats.nacks += 1
                elif isinstance(value, ListResult):
                    self.stats.acks += 1
                    self.stats.ack_latencies_us.append(end_us - start_us)
                    from accord_tpu_torch.obs.spans import trace_key
                    self._trace_of_desc[f"txn{idx}@n{origin}"] = \
                        trace_key(value.txn_id)
                    reads = {k.token: v for k, v in value.read_values.items()}
                    if isinstance(txn.keys, Ranges):
                        # a range read asserts the FULL content of the window:
                        # absent keys are an observed empty prefix (omitting a
                        # key with committed writes is a serializability bug)
                        for rng in txn.keys:
                            for token in range(rng.start, min(rng.end, self.keys)):
                                reads.setdefault(token, ())
                    observations.append(Observation(
                        f"txn{idx}@n{origin}", reads,
                        {k.token: v for k, v in value.appends.items()},
                        start_us, end_us))
                else:
                    self.stats.lost += 1
                self._maybe_kill()
                self._maybe_corrupt()
                # pipeline: keep `concurrency` txns in flight
                submit_one()

            result.add_callback(done)

        for _ in range(min(self.concurrency, self.ops)):
            submit_one()
        # predicate-driven: recurring progress-log polls keep the queue
        # non-empty forever, so "drain" means "all client ops settled" —
        # then a bounded virtual-time grace window lets trailing Apply
        # messages (and any progress-log-driven recovery) propagate
        cluster.process_until(
            lambda: submitted[0] >= self.ops and inflight[0] == 0,
            max_items=50_000_000)
        # quiesce: stop mutating topology, heal partitions, then let
        # replication/recovery drain (the reference burn similarly settles
        # before verifying)
        if self.nemesis is not None:
            self.nemesis.stop()
        if self.partition_nemesis is not None:
            self.partition_nemesis.stop()
        if self.dc_partition_nemesis is not None:
            self.dc_partition_nemesis.stop()
        if self.restarts:
            # a node may still be down (kill near the end of the run):
            # process virtual time until its scheduled restart lands —
            # verification requires every replica present
            cluster.process_until(lambda: not cluster.dead,
                                  max_items=5_000_000)
            assert not cluster.dead, "killed node never restarted"
            assert self.stats.restarts == self.restarts, \
                (self.stats.restarts, self.restarts)
        # drain trailing replication, then — because acked work may still be
        # repairing (Apply loss after long partitions; the progress-log
        # chase heals it but needs virtual time) — keep draining while
        # unapplied decided commands remain, up to a hard cap.  A REAL
        # protocol read would wait on these via deps, so verifying a raw
        # snapshot earlier would be a harness false alarm.
        for _ in range(11):
            cluster.queue.drain(
                until_us=cluster.queue.clock.now_us + 60_000_000,
                max_items=5_000_000)
            if not self._has_unapplied_decided():
                break
        self.stats.pending = inflight[0]
        tally = (self.stats.acks + self.stats.nacks + self.stats.shed
                 + self.stats.lost + self.stats.pending)
        assert tally == submitted[0], \
            f"op accounting leak: {self.stats} vs submitted={submitted[0]}"

        # always-on audit checker: cross-replica range digests must agree
        # at quiesce; divergences (e.g. the corruption arm's silent
        # mutation) fail the burn with the stitched flight timeline
        if self.audit:
            self._run_end_audit()

        # final histories: majority agreement across replicas per key
        final = self._with_flight_artifact(self._final_histories)
        if self.fault_injector is not None:
            self.fault_injector(observations)
        for obs in observations:
            self.verifier.observe(obs)
        self.verifier.verify(final)
        # journal-replay durability contract: every live command must be
        # reconstructible from the node's retained side-effecting messages
        # (SerializerSupport.reconstruct; test Journal.java:82-303)
        if self.cluster.journal is not None:
            from accord_tpu_torch.sim.journal import validate_cluster
            self.journal_checked, self.journal_skipped = \
                self._with_flight_artifact(
                    lambda: validate_cluster(self.cluster))
        return self.stats

    # ---------------------------------------------------- observability --
    def metrics_snapshot(self) -> dict:
        """End-of-run cluster obs report (assertable in hostile tests):
        merged registries + summary (fast-path ratio, outcomes, per-phase
        latency, device flush windows, pipeline counters)."""
        return self.cluster.metrics_snapshot()

    def stitched_trace(self, trace_id: str):
        return self.cluster.stitched_trace(trace_id)

    def recovered_trace_ids(self):
        """Trace ids for which some node began a recovery coordination."""
        return self.cluster.find_trace_ids(phase="begin",
                                           path="recovery")

    # ------------------------------------------------- failure forensics --
    def flight_recorders(self):
        return self.cluster.flight_recorders()

    def stitched_flight(self, trace_ids=None, limit=None):
        return self.cluster.stitched_flight(trace_ids=trace_ids,
                                            limit=limit)

    def _forensics(self, txn_descs) -> str:
        """The verifiers' forensics hook (sim/verify.ForensicsMixin): map
        the offending observations' client descriptions to their protocol
        trace ids and stitch those transactions' flight events across every
        replica into one causally ordered timeline — leading with the first
        cross-replica status divergence when one exists."""
        from accord_tpu_torch.obs.flight import (first_divergence, format_timeline,
                                           stitch_flight)
        tids = {self._trace_of_desc.get(d) for d in txn_descs}
        tids.discard(None)
        if not tids:
            return ""
        events = stitch_flight(self.flight_recorders(), tids, limit=400)
        self._last_forensics_events = events
        parts = []
        div = first_divergence(events)
        if div is not None:
            idx, at_i = div
            def _tr(v):
                return (f"s{v[0]}:{v[1]}->{v[2]}" if isinstance(v, tuple)
                        and len(v) == 3 else "MISSING" if v is None
                        else str(v))

            parts.append(
                f"first diverging event (status transition #{idx} "
                f"per replica): "
                + ", ".join(f"n{n}={_tr(v)}"
                            for n, v in sorted(at_i.items())))
        parts.append(format_timeline(
            events, header=f"flight timeline (cross-replica) for "
                           f"{sorted(tids)}:"))
        self.flight_artifact = "\n".join(parts)
        return self.flight_artifact

    def _with_flight_artifact(self, fn):
        """Run a verification step that has no observation context (journal
        validation, replica-divergence detection); on failure, recover the
        offending trace ids from the exception text (TxnId reprs ARE trace
        ids) — or fall back to the recent cross-replica tail — and append
        the stitched timeline to the raised error."""
        try:
            return fn()
        except AssertionError as exc:
            from accord_tpu_torch.obs.flight import (format_timeline, stitch_flight,
                                               trace_ids_in_text)
            recorders = self.flight_recorders()
            tids = trace_ids_in_text(recorders, str(exc))
            if tids:
                events = stitch_flight(recorders, tids, limit=400)
                header = (f"flight timeline (cross-replica) for "
                          f"{sorted(tids)}:")
            else:
                events = stitch_flight(recorders, None, limit=120)
                header = ("flight timeline (cross-replica tail; no trace "
                          "ids recovered from the failure):")
            self._last_forensics_events = events
            self.flight_artifact = format_timeline(events, header=header)
            exc.args = ((f"{exc.args[0] if exc.args else exc}\n"
                         f"{self.flight_artifact}"),)
            raise

    def _has_unapplied_decided(self) -> bool:
        """Any stable-or-outcome-holding command still waiting to execute?"""
        from accord_tpu_torch.local.status import SaveStatus
        for node in self.cluster.nodes.values():
            for store in node.command_stores.all():
                for cmd in store.commands.values():
                    if cmd.save_status in (SaveStatus.STABLE,
                                           SaveStatus.READY_TO_EXECUTE,
                                           SaveStatus.PRE_APPLIED,
                                           SaveStatus.APPLYING):
                        return True
        return False

    def _final_histories(self) -> Dict[int, Tuple[int, ...]]:
        """Longest agreed history per key across replicas (replicas may lag
        but must never diverge)."""
        cluster = self.cluster
        final: Dict[int, Tuple[int, ...]] = {}
        all_tokens = set()
        for node in cluster.nodes.values():
            all_tokens.update(node.data_store.snapshot().keys())
        for token in sorted(all_tokens):
            histories = [node.data_store.get(Key(token))
                         for node in cluster.nodes.values()]
            longest = max(histories, key=len)
            for h in histories:
                if h != longest[:len(h)]:
                    raise AssertionError(
                        f"replica divergence on key {token}: {h} vs {longest}")
            final[token] = longest
        return final


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="accord-tpu burn test")
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-o", "--ops", type=int, default=200)
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--rf", type=int, default=None,
                        help="replication factor (< nodes = partial "
                             "replication; default full)")
    parser.add_argument("--keys", type=int, default=20)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--drop", type=float, default=0.0)
    parser.add_argument("--partitions", action="store_true",
                        help="schedule network partitions + heals")
    parser.add_argument("--geo", action="store_true",
                        help="place nodes on the 7-node wan3 profile "
                             "(topology/geo.py: hub DC holding the slow "
                             "quorum + three single-node WAN DCs at "
                             "50/100/160ms RTT); forces --nodes 7, full "
                             "replication")
    parser.add_argument("--electorate", default=None, metavar="IDS",
                        help="--geo: comma-separated node ids forming the "
                             "fast-path electorate (default: all replicas)")
    parser.add_argument("--dc-partitions", action="store_true",
                        help="--geo: periodically sever one whole DC and "
                             "heal it (DcPartitionNemesis; "
                             "dc_partition_begin/heal flight kinds)")
    parser.add_argument("--restart", type=int, nargs="?", const=1, default=0,
                        metavar="N",
                        help="crash-restart nemesis: kill N random nodes "
                             "mid-burn (process-death semantics) and "
                             "restart each from its on-disk write-ahead "
                             "journal (accord_tpu_torch/journal/)")
    parser.add_argument("--journal", default=None, metavar="DIR",
                        help="--restart: journal base directory (default: "
                             "a fresh temp dir)")
    parser.add_argument("--down", type=float, default=2.0,
                        help="--restart: virtual seconds a killed node "
                             "stays down before restarting")
    parser.add_argument("--drift", action="store_true",
                        help="per-node drifting wall clocks")
    parser.add_argument("--stores", type=int, default=1,
                        help="command stores per node (keyspace shards)")
    parser.add_argument("--delayed-stores", action="store_true",
                        help="run store tasks on simulated executors with "
                             "randomized delays + cache-miss page-in")
    parser.add_argument("--loops", type=int, default=1,
                        help="run N consecutive seeds")
    parser.add_argument("--device-store", action="store_true",
                        help="run deps scans on the batched device tier "
                             "(flush-window accumulation -> one kernel call)")
    parser.add_argument("--mesh-store", action="store_true",
                        help="device tier with the key-range-sharded deps "
                             "step, its shards stacked on one device, or "
                             "spread over cards with --cards "
                             "(MeshDeviceCommandStore)")
    parser.add_argument("--cards", type=int, default=None, metavar="N",
                        help="--mesh-store: spread each store's shards over "
                             "the first N visible cards (with --device cpu, "
                             "N CPU devices); NCCL sums the counts")
    parser.add_argument("--device-verify", action="store_true",
                        help="cross-check every device-served scan against "
                             "the scalar oracle inline")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="device of --device-store/--mesh-store: the "
                             "CUDA card (default; raises without one) or "
                             "the plain PyTorch versions on the CPU")
    parser.add_argument("--flush-window-us", type=int, default=300,
                        help="device-store flush window (virtual us; 300 "
                             "measured best — see BASELINE.md latency-tax "
                             "table)")
    parser.add_argument("--pipeline", action="store_true",
                        help="submit through the continuous micro-batching "
                             "ingest pipeline (accord_tpu_torch/pipeline/)")
    parser.add_argument("--qos", action="store_true",
                        help="submit through the per-tenant QoS admission "
                             "tier (accord_tpu_torch/qos/): randomized tenants + "
                             "priority classes, deterministic pressure "
                             "shedding under virtual time")
    parser.add_argument("--range-heavy", action="store_true",
                        help="range reads ~1 in 3 ops instead of 1 in 8")
    parser.add_argument("--eph-heavy", action="store_true",
                        help="~half of ops become single-key reads on the "
                             "ephemeral (never-witnessed) read path")
    parser.add_argument("--no-audit", action="store_true",
                        help="disable the always-on end-of-run replica-"
                             "state audit checker (local/audit.py)")
    parser.add_argument("--audit-live", type=float, default=0.0,
                        metavar="S",
                        help="run the periodic live audit+census every S "
                             "virtual seconds during the burn (the "
                             "production cadence; 0 = end-of-run only)")
    parser.add_argument("--corrupt", type=int, nargs="?", const=0,
                        default=None, metavar="N",
                        help="corruption nemesis: after N completed ops "
                             "(default ops/2) silently mutate one "
                             "committed command on a random replica — the "
                             "audit checker must then FAIL the burn "
                             "naming the divergent txn")
    parser.add_argument("--message-stats", action="store_true",
                        help="print per-message-type delivery/drop counters")
    parser.add_argument("--trace", action="store_true",
                        help="record structured protocol events per node and "
                             "print the tail after the run")
    parser.add_argument("--metrics", action="store_true",
                        help="print the end-of-run obs report (merged "
                             "metrics registry summary, JSON)")
    parser.add_argument("--cpu-top", action="store_true",
                        help="print the merged protocol-CPU waterfall "
                             "(per-verb stage p50/p99 + top-verbs table, "
                             "obs/cpuprof.py; set ACCORD_CPU_PROFILE=N "
                             "to sample, else the section is empty)")
    parser.add_argument("--flight-dump", action="store_true",
                        help="print the stitched cross-replica flight-"
                             "recorder tail after the run (the same view "
                             "the failure artifact captures)")
    parser.add_argument("--flight-txn", default=None,
                        help="--flight-dump: filter to trace ids containing "
                             "this substring")
    args = parser.parse_args(argv)
    if args.cards is not None and (not args.mesh_store or args.cards < 1):
        parser.error("--cards N takes N >= 1 and --mesh-store")
    cards = None if args.cards is None else (
        ["cpu"] * args.cards if args.device == "cpu"
        else [f"cuda:{i}" for i in range(args.cards)])
    spread = {} if cards is None else {"devices": cards}
    def make_store_factory(seed: int):
        # built PER SEED: a shared delayed-store RandomSource would carry
        # its state across --loops iterations, making a failure at loop
        # seed N irreproducible by `-s N` alone (burn soaks found exactly
        # that: a seed-15003 violation that vanished standalone)
        if args.device_store or args.mesh_store:
            if args.delayed_stores:
                # delayed-executor nemesis composed OVER the device tier
                from accord_tpu_torch.sim.delayed_store import delayed_device_factory
                from accord_tpu_torch.utils.random_source import RandomSource
                return delayed_device_factory(
                    RandomSource(seed ^ 0x5D5D), mesh_store=args.mesh_store,
                    flush_window_us=args.flush_window_us,
                    verify=args.device_verify, device=args.device,
                    **spread)
            if args.mesh_store:
                from accord_tpu_torch.impl.device_store import MeshDeviceCommandStore
                return MeshDeviceCommandStore.factory(
                    flush_window_us=args.flush_window_us,
                    verify=args.device_verify, device=args.device,
                    **spread)
            from accord_tpu_torch.impl.device_store import DeviceCommandStore
            return DeviceCommandStore.factory(
                flush_window_us=args.flush_window_us,
                verify=args.device_verify, device=args.device)
        if args.delayed_stores:
            from accord_tpu_torch.sim.delayed_store import DelayedCommandStore
            from accord_tpu_torch.utils.random_source import RandomSource
            return DelayedCommandStore.factory(RandomSource(seed ^ 0x5D5D))
        return None

    geo = None
    electorate = None
    if args.geo:
        from accord_tpu_torch.topology.geo import wan3_profile
        geo = wan3_profile()
        args.nodes = len(geo.node_dc)
        args.rf = None  # full replication: every shard spans every DC
        if args.electorate:
            electorate = frozenset(
                int(t) for t in args.electorate.split(","))
    for i in range(args.loops):
        seed = args.seed + i
        store_factory = make_store_factory(seed)
        # one journal world per seed: reusing a directory across loops
        # would replay seed N's history into seed N+1's cluster
        journal_dir = (None if args.journal is None
                       else f"{args.journal}/seed-{seed}")
        run = BurnRun(seed, args.ops, nodes=args.nodes, keys=args.keys,
                      rf=args.rf, range_every=3 if args.range_heavy else 8,
                      n_shards=args.shards, drop_prob=args.drop,
                      store_factory=store_factory,
                      num_command_stores=args.stores,
                      partitions=args.partitions, clock_drift=args.drift,
                      trace=args.trace, pipeline=args.pipeline,
                      qos=args.qos,
                      restarts=args.restart, journal_dir=journal_dir,
                      restart_down_s=args.down,
                      eph_ratio=0.5 if args.eph_heavy else 0.0,
                      audit=not args.no_audit,
                      audit_live_s=args.audit_live,
                      census_live_s=args.audit_live,
                      corrupt_at=(None if args.corrupt is None
                                  else (args.corrupt or args.ops // 2)),
                      geo=geo, electorate=electorate,
                      dc_partitions=args.dc_partitions)
        stats = run.run()
        if args.trace:
            for node in run.cluster.nodes.values():
                dump = node.trace.dump(limit=40)
                if dump:
                    print(dump)
        extra = ""
        if args.device_store or args.mesh_store:
            h = m = b = p = rh = rm = dis = 0
            wb = wp = wx = wd = gh = gm = 0
            mx = xw = 0
            for node in run.cluster.nodes.values():
                for s in node.command_stores.all():
                    h += s.device_hits
                    m += s.device_misses
                    b += s.device_batches
                    p += s.device_batched_probes
                    mx = max(mx, s.device_max_batch)
                    rh += s.device_recovery_hits
                    rm += s.device_recovery_misses
                    wb += s.device_wave_batches
                    wp += s.device_wave_planned
                    wx += s.device_wave_executed
                    wd = max(wd, s.device_wave_max_depth)
                    gh += s.device_range_hits
                    gm += s.device_range_misses
                    xw += s.device_cross_txn_windows
                    dis += s.device_disabled
            extra = (f" device[hits={h} misses={m} batches={b} "
                     f"probes={p} max_batch={mx} cross_txn_windows={xw} "
                     f"recovery_hits={rh} recovery_misses={rm} "
                     f"wave_batches={wb} wave_planned={wp} "
                     f"wave_executed={wx} wave_depth={wd} "
                     f"range_hits={gh} range_misses={gm}"
                     + (f" DISABLED={dis}" if dis else "") + "]")
        if run.cluster.pipelines:
            ps = [p.stats for p in run.cluster.pipelines.values()]
            extra += (f" pipeline[batches={sum(s.batches for s in ps)} "
                      f"dispatched={sum(s.dispatched for s in ps)} "
                      f"shed={sum(s.shed for s in ps)} "
                      f"batch_max={max(s.batch_size_max for s in ps)} "
                      f"batch_mean="
                      f"{sum(s.dispatched for s in ps) / max(1, sum(s.batches for s in ps)):.1f}]")
        if run.qos_class_stats:
            parts = []
            for pr in ("high", "normal", "best_effort"):
                cs = run.qos_class_stats.get(pr)
                if cs:
                    parts.append(f"{pr}={cs['acked']}a/{cs['qos_shed']}s/"
                                 f"{cs['qos_throttle']}t/{cs['inner_shed']}i")
            extra += " qos[" + " ".join(parts) + "]"
        inf = {"evidence": 0, "quorum_evidence": 0, "inferred_rounds": 0,
               "no_round_commits": 0, "fence_refusals": 0,
               "safe_to_clean": 0}
        for node in run.cluster.nodes.values():
            for k in inf:
                inf[k] += node.infer_stats[k]
        if any(inf.values()):
            # the Infer ladder A/B (coordinate/infer.py): quorum_evidence
            # counts interrogations resolvable with no extra round;
            # no_round_commits is how many the full ladder settled that
            # way; inferred_rounds is what was still paid in
            # ballot-protected Invalidate rounds (sub-quorum evidence or
            # the ACCORD_INFER_FULL=0 escape hatch)
            extra += (f" infer[evidence={inf['evidence']} "
                      f"quorum_evidence={inf['quorum_evidence']} "
                      f"inferred_rounds={inf['inferred_rounds']} "
                      f"no_round={inf['no_round_commits']} "
                      f"fence_refusals={inf['fence_refusals']} "
                      f"safe_to_clean={inf['safe_to_clean']}]")

        if run.audit_rounds:
            agree = sum(1 for r in run.audit_rounds
                        if r["outcome"] == "agree")
            extra += (f" audit[rounds={len(run.audit_rounds)} "
                      f"agree={agree}]")
        if run.dc_partition_nemesis is not None:
            extra += (f" dc_partitions["
                      f"{run.dc_partition_nemesis.partitions_applied}]")

        def lat(pct):
            us = stats.latency_us(pct)
            return f"{us / 1e3:.1f}ms" if us >= 0 else "n/a"

        print(f"seed={seed} ops={args.ops} {stats} "
              f"lat_p50={lat(50)} lat_p95={lat(95)} "
              f"virtual_time={run.cluster.now_s:.1f}s "
              f"events={run.cluster.queue.processed} OK{extra}")
        if args.metrics:
            import json as _json
            print("obs " + _json.dumps(run.metrics_snapshot()["summary"]))
        if args.cpu_top:
            import json as _json
            print("cpu " + _json.dumps(
                run.metrics_snapshot()["summary"]["cpu"]))
        if args.flight_dump:
            from accord_tpu_torch.obs.flight import format_timeline
            tids = None
            if args.flight_txn:
                tids = {t for rec in run.flight_recorders()
                        for t in rec.trace_ids() if args.flight_txn in t}
            print(format_timeline(
                run.stitched_flight(trace_ids=tids, limit=120),
                header="flight (cross-replica tail):"))
        if args.message_stats:
            # per-verb delivery/drop counters (reference burn reports
            # messageStatsMap per message type, BurnTest.java:510+)
            net = run.cluster.network.stats
            verbs = sorted({k.split(".", 1)[1] for k in net})
            for verb in verbs:
                d = net.get(f"deliver.{verb}", 0)
                x = net.get(f"drop.{verb}", 0)
                print(f"  {verb:<28} delivered={d:<7} dropped={x}")
        if stats.acks == 0:
            print("PATHOLOGICAL: no transaction succeeded", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
