"""Open-loop drivers: intended-start scheduling over the sim and TCP hosts.

Both runners share the measurement discipline that closed-loop bench lanes
cannot provide:

  * arrivals follow a pre-computed schedule (arrival.py) — completions
    never gate submissions, so a stalled coordinator backs work up instead
    of silently pausing the load;
  * every op's latency is measured from its INTENDED start (the schedule
    time), charging omitted time to the tail; the same acked ops measured
    from actual submit give the closed-loop comparison — the delta IS the
    coordinated omission;
  * acked ops join the trace spans (obs/spans.phase_firsts) for
    per-phase attribution, plus a synthetic "admission" phase
    (coordination begin - intended start: client scheduling, any stall
    ahead of the coordinator, and pipeline queueing).

The sim runner (`run_open_loop_sim`) is fully deterministic — virtual-time
arrivals on the shared PendingQueue — and supports stall injection: during
[stall_at_us, stall_at_us+stall_us) submissions are HELD AT THE
COORDINATOR'S DOOR and released when the stall ends, the externally
observable behavior of a wedged event loop (a client cannot observe which
internal stage stalled, only that its op sat).  The TCP runner drives the
real multi-process cluster on the wall clock; per-phase data rides back on
submit replies (`want_phases`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from accord_tpu_torch.utils.random_source import RandomSource
from accord_tpu_torch.workload.arrival import make_offsets_us
from accord_tpu_torch.workload.profiles import Op, build_txn, make_profile

# bounded exact-sample buffers: enough for sample-exact p99.9 at every
# realistic lane size, bounded against a runaway caller
MAX_SAMPLES = 1 << 17


class OpRecord:
    """One op's ledger row: intended vs actual submit vs end."""

    __slots__ = ("idx", "intended_us", "submit_us", "end_us", "outcome",
                 "phase_firsts")

    def __init__(self, idx: int, intended_us: int):
        self.idx = idx
        self.intended_us = intended_us
        self.submit_us: Optional[int] = None
        self.end_us: Optional[int] = None
        self.outcome: Optional[str] = None  # ack | shed | fail | None
        self.phase_firsts: Optional[list] = None  # [(phase, at_us)]


class OpenLoopResult:
    """Ledger + SLO report of one open-loop run."""

    def __init__(self, records: List[OpRecord], report: dict,
                 summary: Optional[dict], schedule: dict):
        self.records = records
        self.report = report
        self.summary = summary
        self.schedule = schedule

    @property
    def counts(self) -> Dict[str, int]:
        return self.report["counts"]


def _collect(records: List[OpRecord], offered_per_s: float,
             schedule: dict, summary: Optional[dict],
             t0_us: int) -> dict:
    """Fold the ledger into the SLO report (obs/report.slo_report)."""
    from accord_tpu_torch.obs.report import slo_report
    from accord_tpu_torch.obs.spans import phase_deltas

    open_lat: List[int] = []
    closed_lat: List[int] = []
    phases: Dict[str, List[int]] = {}
    counts = {"acked": 0, "shed": 0, "failed": 0, "pending": 0}
    last_end = t0_us
    for rec in records:
        if rec.outcome == "ack":
            counts["acked"] += 1
            last_end = max(last_end, rec.end_us)
            if len(open_lat) < MAX_SAMPLES:
                open_lat.append(max(0, rec.end_us - rec.intended_us))
                closed_lat.append(max(0, rec.end_us - rec.submit_us))
            firsts = rec.phase_firsts or []
            if firsts:
                # admission: intended start -> coordination begin (client
                # scheduling + stall + pipeline queue), then the span's
                # own milestone deltas
                begin_at = firsts[0][1]
                phases.setdefault("admission", []).append(
                    max(0, begin_at - rec.intended_us))
                for ph, dur in phase_deltas(firsts):
                    if ph != "end":
                        phases.setdefault(ph, []).append(dur)
        elif rec.outcome == "shed":
            counts["shed"] += 1
        elif rec.outcome == "fail":
            counts["failed"] += 1
        else:
            counts["pending"] += 1
    duration_s = max(1e-9, (last_end - t0_us) / 1e6)
    return slo_report(open_lat, closed_lat, phases, counts, offered_per_s,
                      duration_s, schedule=schedule, summary=summary)


# ------------------------------------------------------------- sim host ----

def run_open_loop_sim(profile: str = "zipfian", ops: int = 400,
                      rate_per_s: float = 400.0, schedule: str = "poisson",
                      seed: int = 0, nodes: int = 3, keys: int = 48,
                      n_shards: int = 4, pipeline: bool = True,
                      token_span: int = 1000,
                      stall_at_us: Optional[int] = None, stall_us: int = 0,
                      store_factory: Optional[Callable] = None,
                      profile_kwargs: Optional[dict] = None,
                      keep_cluster: bool = False) -> OpenLoopResult:
    """Deterministic open-loop run through the pipeline host in the sim:
    arrivals at virtual-time offsets, latencies in virtual microseconds.

    stall_at_us/stall_us: hold every submission landing inside the window
    until it closes (a stalled coordinator as the client observes one).
    Open-loop latency charges the hold (intended start predates it);
    closed-loop latency of the SAME run does not — the coordinated-
    omission demonstration (tests/test_workload.py)."""
    from accord_tpu_torch.sim.cluster import SimCluster

    rng = RandomSource(seed)
    cluster = SimCluster(n_nodes=nodes, seed=rng.next_long(),
                         token_span=token_span, n_shards=n_shards,
                         pipeline=pipeline, store_factory=store_factory)
    cluster.start_durability_scheduling(shard_cycle_s=10.0)
    prof = make_profile(profile, keys=keys, seed=rng.next_long(),
                        **(profile_kwargs or {}))
    offsets = make_offsets_us(schedule, rate_per_s, ops,
                              seed=rng.next_long())
    origin_rng = rng.fork()
    t0_us = cluster.queue.clock.now_us
    records = [OpRecord(i, t0_us + off) for i, off in enumerate(offsets)]
    ops_list = [prof.next_op() for _ in range(ops)]
    settled = [0]
    stall_end_us = (t0_us + stall_at_us + stall_us
                    if stall_at_us is not None and stall_us > 0 else None)
    stall_begin_us = (t0_us + stall_at_us
                      if stall_end_us is not None else None)

    def submit(i: int) -> None:
        now = cluster.queue.clock.now_us
        if stall_end_us is not None and stall_begin_us <= now < stall_end_us:
            # coordinator wedged: the op sits until the stall clears
            cluster.queue.add(stall_end_us - now, lambda: submit(i))
            return
        rec = records[i]
        rec.submit_us = now
        origin = origin_rng.pick(cluster.live_node_ids())
        txn = build_txn(ops_list[i])

        def done(value, failure):
            from accord_tpu_torch.pipeline.backpressure import Rejected
            rec.end_us = cluster.queue.clock.now_us
            settled[0] += 1
            if isinstance(failure, Rejected):
                rec.outcome = "shed"
            elif failure is not None:
                rec.outcome = "fail"
            elif value is not None:
                rec.outcome = "ack"
                from accord_tpu_torch.obs.spans import phase_firsts, trace_key
                span = cluster.nodes[origin].obs.spans.get(
                    trace_key(value.txn_id))
                rec.phase_firsts = phase_firsts(span)
            else:
                rec.outcome = "fail"

        cluster.pipeline_submit(origin, txn).add_callback(done)

    for i, off in enumerate(offsets):
        cluster.queue.add(off, (lambda j: (lambda: submit(j)))(i))
    cluster.process_until(lambda: settled[0] >= ops, max_items=50_000_000)

    summary = cluster.metrics_snapshot()["summary"]
    sched = {"kind": schedule, "rate_per_s": rate_per_s, "ops": ops,
             "seed": seed, "host": "sim-pipeline" if pipeline else "sim"}
    if stall_end_us is not None:
        sched["stall_at_us"] = stall_at_us
        sched["stall_us"] = stall_us
    result = OpenLoopResult(records,
                            _collect(records, rate_per_s, sched, summary,
                                     t0_us),
                            summary, sched)
    if keep_cluster:
        result.cluster = cluster
    return result


# ------------------------------------------------------------- wan lane ----

class WanRec(OpRecord):
    """OpRecord + the decided commit path (fast|slow) for windowed
    fast-path-ratio measurement."""

    __slots__ = ("path",)

    def __init__(self, idx: int, intended_us: int):
        super().__init__(idx, intended_us)
        self.path: Optional[str] = None


def wan_window_ratios(records: List["WanRec"], t0_us: int,
                      begin_us: int, end_us: int) -> Dict[str, dict]:
    """Fast-path ratio split into before/during/after a [begin, end)
    virtual-time window (offsets from t0): the degrade-then-recover
    surface of the DC-partition arm.  Ops are bucketed by SUBMIT time —
    an op submitted during the window pays the partition regardless of
    when it finally settles."""
    out = {}
    for name, lo, hi in (("before", 0, begin_us),
                         ("during", begin_us, end_us),
                         ("after", end_us, None)):
        recs = [r for r in records
                if r.submit_us is not None
                and r.submit_us - t0_us >= lo
                and (hi is None or r.submit_us - t0_us < hi)]
        fast = sum(1 for r in recs if r.path == "fast")
        slow = sum(1 for r in recs if r.path == "slow")
        out[name] = {"ops": len(recs), "fast": fast, "slow": slow,
                     "fast_path_ratio": (round(fast / (fast + slow), 4)
                                         if fast + slow else None)}
    return out


def run_wan_sim(electorate=None, origin: int = 1, ops: int = 200,
                rate_per_s: float = 30.0, schedule: str = "poisson",
                seed: int = 0, hub: int = 4, keys: int = 240,
                n_shards: int = 2, profile: str = "uniform",
                geo=None, partition=None,
                store_factory: Optional[Callable] = None,
                keep_cluster: bool = False) -> OpenLoopResult:
    """Deterministic open-loop WAN scenario: a geo-placed sim cluster
    (default topology/geo.wan3_profile — a hub DC holding the full slow
    quorum plus three single-node DCs at 50/100/160 ms RTT) driven from a
    PINNED origin node, so one run measures one (electorate, coordinator
    placement) configuration.  `electorate` narrows every shard's
    fast-path electorate (None = all replicas); latencies are virtual
    microseconds against the profile's injected matrix, and each acked
    op records its decided commit path (WanRec.path) so fast-path ratio
    can be windowed.

    partition: optional (dc, begin_us, end_us) — sever that whole DC for
    [begin, end) after t0 via DcPartitionNemesis.partition_now/heal_now,
    the deterministic degrade-then-recover arm (flight kinds
    dc_partition_begin/heal mark the window on every node's ring).

    store_factory: the nodes' command stores, as in run_open_loop_sim."""
    from accord_tpu_torch.sim.cluster import SimCluster
    from accord_tpu_torch.sim.network import DcPartitionNemesis
    from accord_tpu_torch.topology.geo import wan3_profile

    if geo is None:
        geo = wan3_profile(hub)
    nodes = len(geo.node_dc)
    rng = RandomSource(seed)
    cluster = SimCluster(n_nodes=nodes, seed=rng.next_long(),
                         n_shards=n_shards, rf=nodes, geo=geo,
                         electorate=electorate, store_factory=store_factory)
    prof = make_profile(profile, keys=keys, seed=rng.next_long())
    offsets = make_offsets_us(schedule, rate_per_s, ops,
                              seed=rng.next_long())
    t0_us = cluster.queue.clock.now_us
    records = [WanRec(i, t0_us + off) for i, off in enumerate(offsets)]
    ops_list = [prof.next_op() for _ in range(ops)]
    settled = [0]
    nemesis = None
    if partition is not None:
        dc, begin_us, end_us = partition
        nemesis = DcPartitionNemesis(cluster.network, cluster.queue,
                                     rng.fork(), geo)
        cluster.queue.add(begin_us, lambda: nemesis.partition_now(dc))
        cluster.queue.add(end_us, nemesis.heal_now)

    def submit(i: int) -> None:
        rec = records[i]
        rec.submit_us = cluster.queue.clock.now_us
        txn = build_txn(ops_list[i])

        def done(value, failure):
            rec.end_us = cluster.queue.clock.now_us
            settled[0] += 1
            if failure is not None or value is None:
                rec.outcome = "fail"
                return
            rec.outcome = "ack"
            from accord_tpu_torch.obs.spans import phase_firsts, trace_key
            span = cluster.nodes[origin].obs.spans.get(
                trace_key(value.txn_id))
            if span is not None:
                rec.phase_firsts = phase_firsts(span)
                rec.path = span.path

        cluster.node(origin).coordinate(txn).add_callback(done)

    for i, off in enumerate(offsets):
        cluster.queue.add(off, (lambda j: (lambda: submit(j)))(i))
    cluster.process_until(lambda: settled[0] >= ops, max_items=50_000_000)

    summary = cluster.metrics_snapshot()["summary"]
    sched = {"kind": schedule, "rate_per_s": rate_per_s, "ops": ops,
             "seed": seed, "host": "sim-wan", "origin": origin,
             "origin_dc": geo.dc_of(origin),
             "electorate": sorted(electorate) if electorate else None}
    report = _collect(records, rate_per_s, sched, summary, t0_us)
    if partition is not None:
        dc, begin_us, end_us = partition
        report["partition"] = {"dc": dc, "begin_us": begin_us,
                               "end_us": end_us,
                               "windows": wan_window_ratios(
                                   records, t0_us, begin_us, end_us)}
    result = OpenLoopResult(records, report, summary, sched)
    result.geo = geo
    if keep_cluster:
        result.cluster = cluster
    return result


# ------------------------------------------------------------- tcp host ----

def run_open_loop_tcp(profile: str = "zipfian", ops: int = 300,
                      rate_per_s: float = 100.0, schedule: str = "poisson",
                      seed: int = 7, nodes: int = 3, keys: int = 64,
                      n_shards: int = 4, want_phases: bool = True,
                      profile_kwargs: Optional[dict] = None,
                      settle_timeout_s: float = 60.0) -> OpenLoopResult:
    """Open-loop run over the REAL multi-process TCP cluster (wall clock).
    ACCORD_PIPELINE et al. are read by the node processes from the ambient
    environment — the caller chooses the host configuration.  Range ops are
    sim-only (the submit frame carries no range encoding)."""
    from accord_tpu_torch.host.tcp import TcpClusterClient

    rng = RandomSource(seed)
    prof = make_profile(profile, keys=keys, seed=rng.next_long(),
                        **(profile_kwargs or {}))
    offsets = make_offsets_us(schedule, rate_per_s, ops,
                              seed=rng.next_long())
    ops_list = [prof.next_op() for _ in range(ops)]
    assert all(op.ranges is None for op in ops_list), \
        "range ops are sim-only (no wire encoding on the submit frame)"
    origin_rng = rng.fork()
    origins = [1 + origin_rng.next_int(nodes) for _ in range(ops)]

    client = TcpClusterClient(n_nodes=nodes, n_shards=n_shards)
    summary = None
    snaps = []
    try:
        t0_us = int(time.time() * 1e6)
        records = [OpRecord(i, t0_us + off) for i, off in enumerate(offsets)]

        def handle(frame) -> bool:
            body = frame.get("body", {})
            if body.get("type") != "submit_reply":
                return False
            rec = records[body["req"]]
            rec.end_us = int(time.time() * 1e6)
            if body.get("ok"):
                rec.outcome = "ack"
                if body.get("phases"):
                    rec.phase_firsts = [(ph, at) for ph, at
                                        in body["phases"]]
            elif body.get("shed"):
                rec.outcome = "shed"
            else:
                rec.outcome = "fail"
            return True

        sent = pending = 0
        while sent < ops:
            due_us = records[sent].intended_us
            now_us = int(time.time() * 1e6)
            if now_us < due_us:
                frame = client.recv(min(0.05, (due_us - now_us) / 1e6))
                if frame is not None and handle(frame):
                    pending -= 1
                continue
            op = ops_list[sent]
            records[sent].submit_us = int(time.time() * 1e6)
            client.submit(origins[sent], op.reads, op.appends, sent,
                          ephemeral=op.ephemeral, want_phases=want_phases)
            sent += 1
            pending += 1
        deadline = time.monotonic() + settle_timeout_s
        while pending > 0 and time.monotonic() < deadline:
            frame = client.recv(1.0)
            if frame is not None and handle(frame):
                pending -= 1

        # obs snapshots AFTER the channel quiesces (fetch_metrics drops
        # stray frames); merged summary feeds fast_path_ratio into the row
        from accord_tpu_torch.obs.report import merge_node_snapshots
        snaps = [client.fetch_metrics(i) for i in range(1, nodes + 1)]
        merged = merge_node_snapshots([s for s in snaps if s])
        summary = merged["summary"] if merged["nodes"] else None
    finally:
        client.close()

    sched = {"kind": schedule, "rate_per_s": rate_per_s, "ops": ops,
             "seed": seed, "host": "tcp"}
    result = OpenLoopResult(records,
                            _collect(records, rate_per_s, sched, summary,
                                     t0_us),
                            summary, sched)
    result.snapshots = snaps  # every node's own, not only the merged one
    return result


# -------------------------------------------------------- overload lane ----

class OverloadRec(OpRecord):
    """One overload-lane op: the ledger row plus its QoS identity and the
    client-side retry trail (attempts, nacks, whether the retry honored
    the server's `retry_after_us` hint)."""

    __slots__ = ("window", "tenant", "priority", "attempts", "qos_nacks",
                 "honored", "retried")

    def __init__(self, idx: int, intended_us: int, window: int,
                 tenant: str, priority: str):
        super().__init__(idx, intended_us)
        self.window = window
        self.tenant = tenant
        self.priority = priority
        self.attempts = 0
        self.qos_nacks = 0
        self.honored = 0   # resubmits that waited >= the hinted delay
        self.retried = 0


def _probe_capacity(client, prof, origin_rng, nodes: int, ops: int,
                    concurrency: int, timeout_s: float = 60.0) -> dict:
    """Closed-loop capacity probe: `concurrency` outstanding ops, next
    submitted on each completion — the classic saturation measurement the
    open-loop sweep's multipliers are anchored to.  Probes submit as
    `high` so the armed QoS tier cannot nack them: the probe must measure
    what the node can DO, not what the tenant buckets provision."""
    t0 = time.monotonic()
    sent = done = acked = 0
    pending = 0
    deadline = t0 + timeout_s
    while done < ops and time.monotonic() < deadline:
        while sent < ops and pending < concurrency:
            op = prof.next_op()
            client.submit(1 + origin_rng.next_int(nodes), op.reads,
                          op.appends, f"probe-{sent}", priority="high")
            sent += 1
            pending += 1
        frame = client.recv(1.0)
        if frame is None:
            continue
        body = frame.get("body", {})
        if body.get("type") == "submit_reply" and \
                str(body.get("req", "")).startswith("probe-"):
            pending -= 1
            done += 1
            if body.get("ok"):
                acked += 1
    duration_s = max(1e-9, time.monotonic() - t0)
    return {"ops": ops, "concurrency": concurrency, "acked": acked,
            "duration_s": round(duration_s, 3),
            "per_s": round(acked / duration_s, 1)}


def _overload_window_stats(recs: List["OverloadRec"], multiplier: float,
                           rate_per_s: float, t0_us: int,
                           span_us: int) -> dict:
    """Fold one sweep window's ledger: goodput vs offered, per-class
    open-loop quantiles, shed rate, and the retry-after honor trail.
    Goodput counts acks landing INSIDE the arrival span over that span —
    the steady-state service rate; the drain tail (late retries settling
    after arrivals stop) is reported separately so windows with different
    retry-tail shapes stay comparable."""
    n = len(recs)
    last_end = max([r.end_us for r in recs if r.end_us is not None],
                   default=t0_us)
    span_s = max(1e-9, span_us / 1e6)
    acked = sum(1 for r in recs if r.outcome == "ack")
    acked_in_span = sum(1 for r in recs if r.outcome == "ack"
                        and r.end_us <= t0_us + span_us)
    submit_span_s = max(1e-9, (max(r.submit_us or t0_us for r in recs)
                               - t0_us) / 1e6) if recs else 1e-9
    classes: Dict[str, dict] = {}
    for pri in ("high", "normal", "best_effort"):
        sub = [r for r in recs if r.priority == pri]
        lat = sorted(max(0, r.end_us - r.intended_us) for r in sub
                     if r.outcome == "ack")

        def q(p: float) -> Optional[int]:
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None
        classes[pri] = {
            "count": len(sub), "acked": len(lat),
            "shed": sum(1 for r in sub if r.outcome == "shed"),
            "open_p50_us": q(0.50), "open_p99_us": q(0.99)}
    nacks = sum(r.qos_nacks for r in recs)
    retried = sum(r.retried for r in recs)
    honored = sum(r.honored for r in recs)
    pooled = sorted(max(0, r.end_us - r.intended_us) for r in recs
                    if r.outcome == "ack")

    def pq(p: float) -> Optional[int]:
        return pooled[min(len(pooled) - 1,
                          int(p * len(pooled)))] if pooled else None
    return {
        "multiplier": multiplier,
        "offered_per_s": round(rate_per_s, 1),
        "actual_offered_per_s": round(n / submit_span_s, 1),
        "ops": n,
        "acked": acked,
        "shed": sum(1 for r in recs if r.outcome == "shed"),
        # sheds applied at the client by flow suppression (never sent;
        # attempts == 0) — a subset of "shed", split out for transparency
        "client_shed": sum(1 for r in recs
                           if r.outcome == "shed" and r.attempts == 0),
        "failed": sum(1 for r in recs if r.outcome == "fail"),
        "pending": sum(1 for r in recs if r.outcome is None),
        "goodput_per_s": round(acked_in_span / span_s, 1),
        "drain_s": round(max(0.0, (last_end - t0_us - span_us) / 1e6), 3),
        "open_p50_us": pq(0.50), "open_p99_us": pq(0.99),
        "shed_rate": round(sum(1 for r in recs if r.outcome == "shed")
                           / n, 4) if n else 0.0,
        "qos_nacks": nacks,
        "retries": retried,
        "retry_honor_rate": round(honored / retried, 4) if retried else None,
        "classes": classes,
    }


def run_overload_tcp(profile: str = "uniform", schedule: str = "poisson",
                     seed: int = 23, nodes: int = 3, keys: int = 64,
                     n_shards: int = 4,
                     multipliers=(0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0),
                     window_s: float = 6.0, max_window_ops: int = 9000,
                     probe_ops: int = 200, probe_concurrency: int = 8,
                     capacity_per_s: Optional[float] = None,
                     high_frac: float = 0.15, normal_frac: float = 0.35,
                     max_retries: int = 2, gap_s: float = 1.5,
                     settle_timeout_s: float = 30.0,
                     want_phases: bool = True) -> OpenLoopResult:
    """The slo-overload lane: an open-loop sweep over the live TCP cluster
    from below to far past its measured capacity, with mixed tenants and
    priority classes, the client honoring every QoS nack's
    `retry_after_us` hint (jittered exponential backoff, bounded retries).

    Sequence: (1) closed-loop capacity probe anchors the multipliers;
    (2) one paced open-loop window per multiplier.  The `high` class is a
    FIXED-RATE foreground — `high_frac` of CAPACITY, constant across
    windows — while the bulk tiers (`normal_frac` `normal`, rest
    `best_effort`, across tenants t0..t2) scale with the offered
    multiplier.  That is what an SLO-protection test measures: a constant
    paying workload whose latency must hold while background load runs
    away.  (If high scaled with the multiplier, its tail at 10x would be
    dominated by high-vs-high key conflicts — which admission can never
    shed — and the measurement would say nothing about the QoS tier.)
    The default profile is UNIFORM, deliberately: this lane measures the
    ADMISSION tier, and a skewed profile's hot-key dependency chains add
    an execution-side tail (a high txn must wait for every uncommitted
    conflicting predecessor to commit — a wait no admission policy can
    shed, since those predecessors were already admitted) that drowns the
    signal being tested.  Conflict-heavy latency behavior has its own
    lanes (slo-mixed, slo-zipf1m).  Each window is drained to quiescence
    with a decay gap before the next so one window's pressure does not
    bleed into the next's ledger; (3) the full ledger folds into
    the standard SLO report plus an `overload` section: the
    goodput-vs-offered curve, per-class open-loop p99, shed rate,
    retry-after honor rate, and the exact client-side accounting identity
    (acked + shed + failed + pending == submitted, per window).

    An op nacked by QoS admission is retried after at least the hinted
    delay (open-loop latency still charges from the ORIGINAL intended
    start, so honored backoff is paid by the tail, not hidden); an op
    whose retry budget is exhausted settles as shed.  The node processes
    read ACCORD_QOS* from the ambient environment — the caller arms the
    tier, this driver only exercises it."""
    import heapq

    from accord_tpu_torch.host.tcp import TcpClusterClient

    import random as _random

    rng = RandomSource(seed)
    prof = make_profile(profile, keys=keys, seed=rng.next_long())
    origin_rng = rng.fork()
    backoff_rng = _random.Random(seed ^ 0xBACC0FF)  # stdlib .random() API
    mix_rng = rng.fork()

    def now_us() -> int:
        return int(time.time() * 1e6)

    client = TcpClusterClient(n_nodes=nodes, n_shards=n_shards)
    all_records: List[OverloadRec] = []
    windows: List[dict] = []
    summary = None
    snaps = []
    t0_us = now_us()
    try:
        probe = _probe_capacity(client, prof, origin_rng, nodes,
                                probe_ops, probe_concurrency)
        capacity = capacity_per_s if capacity_per_s else probe["per_s"]
        if capacity <= 0:
            raise RuntimeError(f"capacity probe found a dead cluster: "
                               f"{probe}")
        time.sleep(gap_s)

        for widx, mult in enumerate(multipliers):
            rate = capacity * mult
            ops = min(max_window_ops, max(40, int(rate * window_s)))
            offsets = make_offsets_us(schedule, rate, ops,
                                      seed=rng.next_long())
            # fresh profile on a DISJOINT token range per window: the
            # list registers are append-only, so re-touching the probe's
            # (or an earlier window's) hot keys would grow every read
            # reply all sweep long and later windows would measure list
            # length, not overload behavior
            tok_off = (widx + 1) * keys
            wprof = make_profile(profile, keys=keys, seed=rng.next_long())
            ops_list = []
            for _ in range(ops):
                op = wprof.next_op()
                ops_list.append(Op(
                    reads=tuple(t + tok_off for t in op.reads),
                    appends={t + tok_off: v
                             for t, v in op.appends.items()},
                    ephemeral=op.ephemeral))
            origins = [1 + origin_rng.next_int(nodes) for _ in range(ops)]
            base = (widx + 1) * 1_000_000
            t0w = now_us()
            recs: List[OverloadRec] = []
            # high is high_frac of CAPACITY, not of offered load: the
            # foreground stays constant while the bulk flood scales
            p_high = min(1.0, high_frac / mult) if mult > 0 else high_frac
            for i, off in enumerate(offsets):
                roll = mix_rng.next_float()
                pri = ("high" if roll < p_high
                       else "normal" if roll < p_high + normal_frac
                       else "best_effort")
                recs.append(OverloadRec(i, t0w + off, widx,
                                        f"t{mix_rng.next_int(3)}", pri))
            by_req = {base + i: recs[i] for i in range(ops)}

            def submit(i: int) -> None:
                rec = recs[i]
                rec.attempts += 1
                if rec.submit_us is None:
                    rec.submit_us = now_us()
                op = ops_list[i]
                client.submit(origins[i], op.reads, op.appends, base + i,
                              want_phases=want_phases, tenant=rec.tenant,
                              priority=rec.priority)

            retryq: list = []  # (due_us, req, nack_at_us, hint_us)
            unfinished = ops
            # client-side flow control: a qos nack's retry_after_us is
            # honored for the whole (origin, tenant, priority) FLOW, not
            # just the nacked op — new bulk-tier ops of a suppressed flow
            # are shed at the client without a round trip.  This is the
            # other half of admission control: without it the nack flood
            # itself saturates the host boundary at deep overload and
            # every class pays the queueing tax.  high is never
            # suppressed (the server never sheds it).  Retries are still
            # sent on their own backoff — they are the probes that
            # refresh the hint.
            suppress_until: Dict[tuple, int] = {}

            def handle(frame) -> bool:
                nonlocal unfinished
                body = frame.get("body", {})
                if body.get("type") != "submit_reply":
                    return False
                rec = by_req.get(body.get("req"))
                if rec is None:
                    return False  # stale frame from a previous window
                if rec.outcome is not None:
                    return False
                if body.get("ok"):
                    rec.end_us = now_us()
                    rec.outcome = "ack"
                    if body.get("phases"):
                        rec.phase_firsts = [(ph, at) for ph, at
                                            in body["phases"]]
                    unfinished -= 1
                    return True
                if body.get("qos"):
                    rec.qos_nacks += 1
                    if rec.priority != "high":
                        flow = (origins[rec.idx], rec.tenant, rec.priority)
                        until = now_us() + int(
                            body.get("retry_after_us") or 0)
                        if until > suppress_until.get(flow, 0):
                            suppress_until[flow] = until
                    # best_effort gets one fewer retry than the paying
                    # classes: its nacks at deep overload are near-certain
                    # to repeat, and the attempt flood is load too
                    budget = (max_retries if rec.priority != "best_effort"
                              else max(0, max_retries - 1))
                    if rec.attempts <= budget:
                        hint = int(body.get("retry_after_us") or 0)
                        back = client.qos_backoff_us(
                            body, attempt=rec.attempts, rng=backoff_rng)
                        heapq.heappush(retryq,
                                       (now_us() + back, base + rec.idx,
                                        now_us(), hint))
                        return True
                    rec.end_us = now_us()
                    rec.outcome = "shed"
                    unfinished -= 1
                    return True
                rec.end_us = now_us()
                rec.outcome = "shed" if body.get("shed") else "fail"
                unfinished -= 1
                return True

            sent = 0
            deadline = (time.monotonic() + (offsets[-1] if offsets else 0)
                        / 1e6 + settle_timeout_s)
            while unfinished > 0 and time.monotonic() < deadline:
                now = now_us()
                while retryq and retryq[0][0] <= now:
                    _due, req, nack_at, hint = heapq.heappop(retryq)
                    rec = by_req[req]
                    rec.retried += 1
                    if now - nack_at >= hint:
                        rec.honored += 1
                    submit(rec.idx)
                if sent < ops and now >= recs[sent].intended_us:
                    nrec = recs[sent]
                    if (nrec.priority != "high"
                            and suppress_until.get(
                                (origins[sent], nrec.tenant,
                                 nrec.priority), 0) > now):
                        # flow suppressed: client-side shed, attempts
                        # stays 0 (how window stats tell these apart)
                        nrec.end_us = now
                        nrec.outcome = "shed"
                        unfinished -= 1
                    else:
                        submit(sent)
                    sent += 1
                    # drain ready replies before the next arrival: when
                    # the client runs behind schedule it submits back to
                    # back, and without this the acks age unread in the
                    # inbox — inflating measured open-loop latency with
                    # client queueing, not server behavior
                    while True:
                        frame = client.recv(0)
                        if frame is None:
                            break
                        handle(frame)
                    continue
                next_due = min(
                    [recs[sent].intended_us] if sent < ops else [],
                    default=retryq[0][0] if retryq else now + 50_000)
                if retryq and retryq[0][0] < next_due:
                    next_due = retryq[0][0]
                frame = client.recv(
                    min(0.05, max(0.001, (next_due - now) / 1e6)))
                if frame is not None:
                    handle(frame)
            windows.append(_overload_window_stats(
                recs, mult, rate, t0w, offsets[-1] if offsets else 0))
            all_records.extend(recs)
            time.sleep(gap_s)  # let the lag EWMA decay between windows

        # obs snapshots AFTER the channel quiesces: the merged summary's
        # "qos" section carries the server-side accounting identity
        from accord_tpu_torch.obs.report import merge_node_snapshots
        snaps = [client.fetch_metrics(i, timeout_s=10.0)
                 for i in range(1, nodes + 1)]
        merged = merge_node_snapshots([s for s in snaps if s])
        summary = merged["summary"] if merged["nodes"] else None
    finally:
        client.close()

    total = len(all_records)
    span_s = max(1e-9, (max((r.intended_us for r in all_records),
                            default=t0_us) - t0_us) / 1e6)
    sched = {"kind": schedule, "rate_per_s": round(total / span_s, 1),
             "ops": total, "seed": seed, "host": "tcp-overload"}
    report = _collect(all_records, total / span_s, sched, summary, t0_us)

    def _w(mult: float) -> Optional[dict]:
        for w in windows:
            if w["multiplier"] == mult:
                return w
        return None
    peak = max((w["goodput_per_s"] for w in windows), default=0.0)
    at5, uncontended = _w(5.0), _w(0.5)
    counts = {"submitted": total,
              "acked": sum(w["acked"] for w in windows),
              "shed": sum(w["shed"] for w in windows),
              "failed": sum(w["failed"] for w in windows),
              "pending": sum(w["pending"] for w in windows)}
    counts["exact"] = (counts["acked"] + counts["shed"] + counts["failed"]
                       + counts["pending"] == counts["submitted"])
    retried = sum(w["retries"] for w in windows)
    honored = sum(r.honored for r in all_records)
    report["overload"] = {
        "capacity_probe": probe,
        "capacity_per_s": capacity,
        "windows": windows,
        "peak_goodput_per_s": peak,
        "goodput_at_5x_frac_of_peak":
            round(at5["goodput_per_s"] / peak, 4) if at5 and peak else None,
        # the uncontended baseline for the high class is the 0.5x window's
        # POOLED open-loop p99: nothing sheds there, so priority classes
        # are exchangeable and the pooled quantile is the same distribution
        # at ~10x the sample size of the high slice alone
        "high_p99_uncontended_us": (uncontended or {}).get("open_p99_us"),
        "high_p99_at_5x_us":
            (at5 or {}).get("classes", {}).get("high", {})
            .get("open_p99_us"),
        "retry_honor_rate": round(honored / retried, 4) if retried else None,
        "accounting": counts,
        "server_qos": (summary or {}).get("qos"),
    }
    result = OpenLoopResult(all_records, report, summary, sched)
    result.snapshots = snaps
    return result


# --------------------------------------------------------- reshard lane ----

def _window_stats(recs: List[OpRecord]) -> dict:
    """Ack rate + open-loop quantiles of one reshard window's records."""
    lat = sorted(max(0, r.end_us - r.intended_us) for r in recs
                 if r.outcome == "ack")

    def q(p: float) -> Optional[int]:
        return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None
    n = len(recs)
    return {"count": n, "acked": len(lat),
            "shed": sum(1 for r in recs if r.outcome == "shed"),
            "failed": sum(1 for r in recs if r.outcome == "fail"),
            "ack_rate": round(len(lat) / n, 4) if n else None,
            "open_p50_us": q(0.50), "open_p99_us": q(0.99)}


def _reshard_report(records: List[OpRecord], t0_us: int, begin_us: int,
                    end_us: int, bucket_us: int = 1_000_000) -> dict:
    """Fold the ledger around the reshard window: per-window stats,
    1s-bucket availability dip, and time-to-SLO-recovery measured from the
    moment the reshard began (bucket ack rate back >= 95% AND bucket open
    p99 back under max(2x the before-window p99, 100ms))."""
    windows = {
        "before": _window_stats([r for r in records
                                 if r.intended_us < begin_us]),
        "during": _window_stats([r for r in records
                                 if begin_us <= r.intended_us < end_us]),
        "after": _window_stats([r for r in records
                                if r.intended_us >= end_us]),
    }
    buckets: Dict[int, list] = {}
    for r in records:
        b = (r.intended_us - t0_us) // bucket_us
        tot_ack = buckets.setdefault(b, [0, 0, []])
        tot_ack[0] += 1
        if r.outcome == "ack":
            tot_ack[1] += 1
            tot_ack[2].append(max(0, r.end_us - r.intended_us))
    begin_b = (begin_us - t0_us) // bucket_us
    base_p99 = windows["before"]["open_p99_us"] or 0
    thresh_us = max(2 * base_p99, 100_000)
    dip_rates = [ack / tot for b, (tot, ack, _l) in sorted(buckets.items())
                 if b >= begin_b and tot > 0]
    before_rate = windows["before"]["ack_rate"] or 0.0
    recovery_s = None
    for b in sorted(buckets):
        if b < begin_b:
            continue
        tot, ack, lats = buckets[b]
        if tot == 0:
            continue
        lats.sort()
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))] if lats else 0
        if ack / tot >= 0.95 and p99 <= thresh_us:
            recovery_s = round(max(0.0, (t0_us + b * bucket_us - begin_us)
                                   / 1e6), 3)
            break
    min_rate = round(min(dip_rates), 4) if dip_rates else None
    return {
        "windows": windows,
        "availability": {
            "before_ack_rate": before_rate,
            "min_bucket_ack_rate": min_rate,
            "dip_pct": round(max(0.0, (before_rate - (min_rate or 0.0)))
                             * 100.0, 2) if min_rate is not None else None,
            "bucket_s": bucket_us / 1e6,
        },
        "time_to_slo_recovery_s": recovery_s,
    }


def run_reshard_tcp(profile: str = "zipfian", ops: int = 2400,
                    rate_per_s: float = 80.0, schedule: str = "poisson",
                    seed: int = 13, nodes: int = 3, keys: int = 48,
                    n_shards: int = 4, reshard_at_frac: float = 0.33,
                    want_phases: bool = True,
                    settle_timeout_s: float = 90.0,
                    drain_retiring: bool = True) -> OpenLoopResult:
    """The slo-reshard lane: open-loop zipfian over the live TCP cluster
    with a FULL membership change mid-window — a fresh journal-backed node
    joins and bootstraps under load (admin epoch install, one contact,
    gossip convergence), the client re-learns routing from a topology
    frame, and the founding node drains (coordination fenced, in-flight
    handed off, durability watermark awaited) and is retired.

    The ledger is folded around the reshard window into before/during/
    after ack-rate + open-loop p99, a 1s-bucket availability dip, and
    time-to-SLO-recovery; afterwards every acked append is re-read from
    the surviving membership (zero-lost-acks) and the per-node audit
    views are collected (cross-replica digest agreement at quiesce).

    Admin traffic and submit replies share the client's single reply
    inbox: the paced loop stashes non-submit frames into a dict the
    driver thread polls, and the driver only ever sends (socket writes
    are lock-serialized in TcpClusterClient._send)."""
    import threading

    from accord_tpu_torch.host.maelstrom import TOKEN_SPAN
    from accord_tpu_torch.host.tcp import TcpClusterClient

    rng = RandomSource(seed)
    prof = make_profile(profile, keys=keys, seed=rng.next_long())
    offsets = make_offsets_us(schedule, rate_per_s, ops,
                              seed=rng.next_long())
    ops_list = [prof.next_op() for _ in range(ops)]
    assert all(op.ranges is None for op in ops_list), \
        "range ops are sim-only (no wire encoding on the submit frame)"
    span_us = offsets[-1] if offsets else 0

    client = TcpClusterClient(n_nodes=nodes, n_shards=n_shards)
    admin_replies: Dict[str, dict] = {}
    events: List[list] = []  # [label, wall_us] markers from the driver
    driver_err: List[BaseException] = []
    retiring = 1

    def now_us() -> int:
        return int(time.time() * 1e6)

    def mark(label: str) -> None:
        events.append([label, now_us()])

    def admin_wait(req: str, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            body = admin_replies.pop(req, None)
            if body is not None:
                return body
            time.sleep(0.01)
        raise TimeoutError(f"no admin reply for {req}")

    def node_at_epoch(nid: int, epoch: int, deadline: float) -> dict:
        k = 0
        while time.monotonic() < deadline:
            k += 1
            req = f"rs-topo-{nid}-{k}"
            try:
                client._send(nid, {"type": "topology", "req": req})
                spec = admin_wait(req, 2.0).get("topology") or {}
            except (TimeoutError, OSError):
                continue
            if spec.get("epoch", 0) >= epoch:
                return spec
            time.sleep(0.1)
        raise TimeoutError(f"node {nid} never reached epoch {epoch}")

    def reshard_driver(t0_us: int) -> None:
        try:
            target_us = t0_us + int(reshard_at_frac * span_us)
            while now_us() < target_us:
                time.sleep(0.01)
            mark("reshard_begin")
            joined = client.add_node()
            mark("node_added")
            # epoch 2 replaces the retiring founder with the joiner:
            # replicas rotated over the surviving membership, same even
            # token split every host transport uses
            ids2 = sorted([i for i in range(1, nodes + 1)
                           if i != retiring] + [joined])
            rf = min(3, len(ids2))
            width = TOKEN_SPAN // n_shards
            shards = [[i * width,
                       TOKEN_SPAN if i == n_shards - 1 else (i + 1) * width,
                       [ids2[(i + j) % len(ids2)] for j in range(rf)]]
                      for i in range(n_shards)]
            req = "rs-epoch-2"
            client._send(retiring, {
                "type": "epoch", "req": req,
                "topology": {"epoch": 2, "shards": shards,
                             "peers": [[joined] +
                                       list(client.peers[joined])]}})
            admin_wait(req, 30.0)
            mark("epoch_acked")
            deadline = time.monotonic() + 60.0
            spec = None
            for nid in ids2 + [retiring]:
                spec = node_at_epoch(nid, 2, deadline)
            mark("epoch_converged")
            # routing refresh: the paced loop routes by owner_of, which
            # reads this spec — without it the client submits against the
            # pre-reshard ownership map forever
            client.topology_spec = spec
            mark("routing_refreshed")
            if drain_retiring:
                req = f"rs-drain-{retiring}"
                client._send(retiring, {"type": "drain", "req": req,
                                        "timeout_s": 45.0})
                body = admin_wait(req, 60.0)
                mark("drain_ok" if body.get("durable") else "drain_undurable")
                # the retiring node's own metrics, while it still answers
                req = f"rs-metrics-{retiring}"
                client._send(retiring, {"type": "metrics", "req": req})
                try:
                    retired_snaps.append(
                        admin_wait(req, 10.0).get("snapshot"))
                except TimeoutError:
                    retired_snaps.append(None)
                client.kill_node(retiring)
                mark("retired")
            mark("reshard_end")
        except BaseException as e:  # noqa: BLE001
            driver_err.append(e)
            mark("reshard_failed")

    summary = None
    snaps = []
    retired_snaps: List[Optional[dict]] = []
    audit_views = {}
    lost: List[tuple] = []
    acked_appends = 0
    verified_keys = 0
    try:
        t0_us = now_us()
        records = [OpRecord(i, t0_us + off) for i, off in enumerate(offsets)]

        def handle(frame) -> bool:
            body = frame.get("body", {})
            typ = body.get("type")
            if typ != "submit_reply":
                if typ in ("epoch_ok", "topology_reply", "drain_ok",
                           "metrics_reply"):
                    admin_replies[body.get("req")] = body
                return False
            req = body.get("req")
            if not isinstance(req, int):
                return False
            rec = records[req]
            rec.end_us = now_us()
            if body.get("ok"):
                rec.outcome = "ack"
                if body.get("phases"):
                    rec.phase_firsts = [(ph, at) for ph, at
                                        in body["phases"]]
            elif body.get("shed"):
                rec.outcome = "shed"
            else:
                rec.outcome = "fail"
            return True

        driver = threading.Thread(target=reshard_driver, args=(t0_us,),
                                  daemon=True)
        driver.start()

        sent = pending = 0
        while sent < ops:
            due_us = records[sent].intended_us
            now = now_us()
            if now < due_us:
                frame = client.recv(min(0.05, (due_us - now) / 1e6))
                if frame is not None and handle(frame):
                    pending -= 1
                continue
            op = ops_list[sent]
            tok0 = next(iter(op.reads), None)
            if tok0 is None and op.appends:
                tok0 = next(iter(op.appends))
            records[sent].submit_us = now_us()
            try:
                client.submit(client.owner_of(tok0 or 0), op.reads,
                              op.appends, sent, ephemeral=op.ephemeral,
                              want_phases=want_phases)
            except OSError:
                records[sent].end_us = now_us()
                records[sent].outcome = "fail"
                sent += 1
                continue
            sent += 1
            pending += 1
        deadline = time.monotonic() + settle_timeout_s
        while pending > 0 and time.monotonic() < deadline:
            frame = client.recv(1.0)
            if frame is not None and handle(frame):
                pending -= 1
        # keep pumping the shared inbox while the driver finishes — its
        # admin replies (epoch_ok / topology_reply / drain_ok) only reach
        # the stash through handle()
        deadline = time.monotonic() + 120.0
        while driver.is_alive() and time.monotonic() < deadline:
            frame = client.recv(0.2)
            if frame is not None and handle(frame):
                pending -= 1
        driver.join(timeout=5.0)

        # zero-lost-acks: every acked append must be readable from the
        # surviving membership (final reads through the refreshed routing)
        acked_by_key: Dict[int, List[int]] = {}
        for i, rec in enumerate(records):
            if rec.outcome == "ack":
                for tok, val in ops_list[i].appends.items():
                    acked_by_key.setdefault(tok, []).append(val)
                    acked_appends += 1
        final_reads: Dict[int, list] = {}
        outstanding = set()
        for tok in acked_by_key:
            req = f"fr-{tok}"
            client.submit(client.owner_of(tok), [tok], {}, req)
            outstanding.add(req)
        deadline = time.monotonic() + 60.0
        while outstanding and time.monotonic() < deadline:
            frame = client.recv(1.0)
            if frame is None:
                continue
            body = frame.get("body", {})
            req = body.get("req")
            if body.get("type") == "submit_reply" and req in outstanding:
                outstanding.discard(req)
                if body.get("ok"):
                    for tok, vals in (body.get("reads") or {}).items():
                        final_reads[int(tok)] = vals
        for tok, vals in sorted(acked_by_key.items()):
            got = final_reads.get(tok)
            if got is None:
                lost.append((tok, "unread", len(vals)))
                continue
            verified_keys += 1
            for val in vals:
                if val not in got:
                    lost.append((tok, "missing", val))

        # audit agreement at quiesce: the cross-replica digest rounds are
        # watermark-negotiated, so any recorded divergence is real
        live = sorted(n for n in range(1, len(client.procs) + 1)
                      if not (drain_retiring and n == retiring))
        for nid in live:
            view = client.fetch_audit(nid, timeout_s=10.0)
            if view:
                audit_views[nid] = len(view.get("divergences") or [])
        from accord_tpu_torch.obs.report import merge_node_snapshots
        snaps = [client.fetch_metrics(n, timeout_s=10.0) for n in live]
        merged = merge_node_snapshots([s for s in snaps if s])
        summary = merged["summary"] if merged["nodes"] else None
    finally:
        client.close()

    if driver_err:
        raise RuntimeError(f"reshard driver failed: {driver_err[0]!r}; "
                           f"events={events}") from driver_err[0]
    marks = dict((label, at) for label, at in events)
    begin_us = marks.get("reshard_begin", t0_us)
    end_us = marks.get("reshard_end", begin_us)
    sched = {"kind": schedule, "rate_per_s": rate_per_s, "ops": ops,
             "seed": seed, "host": "tcp-reshard"}
    report = _collect(records, rate_per_s, sched, summary, t0_us)
    reshard = _reshard_report(records, t0_us, begin_us, end_us)
    reshard["events"] = [[label, round((at - t0_us) / 1e6, 3)]
                         for label, at in events]
    reshard["lost_acks"] = len(lost)
    reshard["lost_detail"] = lost[:16]
    reshard["acked_appends"] = acked_appends
    reshard["verified_keys"] = verified_keys
    reshard["audit"] = {"divergences_by_node": audit_views,
                        "agree": all(v == 0 for v in audit_views.values())
                        and bool(audit_views)}
    reshard["joined_node"] = nodes + 1
    reshard["retired_node"] = retiring if drain_retiring else None
    report["reshard"] = reshard
    result = OpenLoopResult(records, report, summary, sched)
    result.snapshots = retired_snaps + snaps
    return result
