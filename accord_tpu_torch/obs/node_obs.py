"""NodeObs: the per-node observability facade the engine instruments on.

One registry + one span store per Node.  Coordinators call `txn_begin` /
`txn_phase` / `txn_path` / `txn_end` at protocol milestones; `Node._process`
calls `rx` for any inbound request carrying a trace id.  Everything is a
few dict ops — the <5% hot-loop budget is enforced by
tests/test_obs_budget.py.
"""

from __future__ import annotations

from typing import Callable, Optional

from accord_tpu_torch.obs.cpuprof import cpu_profiler_from_env
from accord_tpu_torch.obs.flight import FlightRecorder
from accord_tpu_torch.obs.registry import Registry
from accord_tpu_torch.obs.spans import (PHASE_ORDER, SpanStore, phase_deltas,
                                  phase_firsts, trace_key)

# milestones that each open one RPC round (fan-out + quorum wait): their
# per-txn count is the round-count histogram the ROADMAP Infer A/B
# harness prices against
ROUND_PHASES = frozenset({"preaccept", "preaccept_extend", "accept",
                          "commit", "stable", "apply", "begin_recover",
                          "get_deps", "await_commit", "invalidate",
                          "eph_deps", "eph_read"})


class NodeObs:
    """Per-node metrics registry + span store + instrumentation helpers."""

    __slots__ = ("node_id", "registry", "spans", "flight", "enabled",
                 "_clock_us", "audit_view", "cpuprof", "dc", "_dc_labels")

    def __init__(self, node_id: int = 0, registry: Optional[Registry] = None,
                 clock_us: Optional[Callable[[], int]] = None,
                 span_capacity: int = 4096, enabled: bool = True,
                 flight_capacity: int = 4096, dc: Optional[str] = None,
                 elect: Optional[str] = None):
        self.node_id = node_id
        # geo placement attribution: when this node is assigned to a DC
        # (topology/geo.GeoProfile), coordination counters/histograms carry
        # dc= (and elect= in|out, electorate membership) labels so the wan
        # report section can split fast/slow outcomes and phase latencies
        # by coordinator placement.  With dc unset (every pre-geo harness)
        # the label dicts are EMPTY and each metric row is byte-identical
        # to the pre-geo shape — the obs-budget and determinism pins hold.
        self.dc = dc
        self._dc_labels = ({"dc": dc, "elect": elect} if dc and elect
                           else {"dc": dc} if dc else {})
        self.registry = registry if registry is not None else Registry()
        self.spans = SpanStore(node_id, capacity=span_capacity)
        self.enabled = enabled
        self._clock_us = clock_us if clock_us is not None else (lambda: 0)
        # always-on bounded forensics ring (obs/flight.py) sharing the
        # node's clock — stitched across replicas on failure
        self.flight = FlightRecorder(node_id, capacity=flight_capacity,
                                     clock_us=self._clock_us)
        # live replica-state audit view: the node's Auditor (local/audit.py)
        # installs its `view` callable here so the metrics endpoint's
        # /audit route and host "audit" frames can serve it; None when no
        # auditor is attached
        self.audit_view: Optional[Callable[[], dict]] = None
        # protocol-tier CPU attribution (obs/cpuprof.py): sampled
        # per-dispatch decode/apply/cfk/reply-encode waterfall, labeled by
        # verb — off unless ACCORD_CPU_PROFILE=N is set
        self.cpuprof = cpu_profiler_from_env(self.registry)

    def now_us(self) -> int:
        return int(self._clock_us())

    def set_dc(self, dc: Optional[str], elect: Optional[str] = None) -> None:
        """(Re)bind this node's geo placement labels: the TCP host learns
        its DC only after construction (ACCORD_GEO env, or a geo profile
        riding an EpochInstall frame)."""
        self.dc = dc
        self._dc_labels = ({"dc": dc, "elect": elect} if dc and elect
                           else {"dc": dc} if dc else {})

    # -------------------------------------------------- coordination side --
    def txn_begin(self, txn_id, kind: Optional[str] = None,
                  path: str = "coordination") -> None:
        if not self.enabled:
            return
        self.registry.counter("accord_coordinate_started_total",
                              path=path).inc()
        span = self.spans.event(trace_key(txn_id), "begin", self.now_us(),
                                {"path": path, "kind": kind} if kind
                                else {"path": path})
        span.path = path

    def txn_phase(self, txn_id, phase: str, **tags) -> None:
        if not self.enabled:
            return
        self.spans.event(trace_key(txn_id), phase, self.now_us(),
                         tags or None)

    def txn_path(self, txn_id, which: str) -> None:
        """Record the decided commit path ("fast" | "slow").  Idempotent
        per trace: a coordination that re-decides after an epoch-extension
        round must not double-count its path."""
        if not self.enabled:
            return
        tid = trace_key(txn_id)
        span = self.spans.get(tid)
        if span is not None and span.first("path") is not None:
            return
        self.registry.counter("accord_path_total", path=which,
                              **self._dc_labels).inc()
        span = self.spans.event(tid, "path", self.now_us(), {"path": which})
        span.path = which

    def txn_end(self, txn_id, failure: Optional[BaseException] = None,
                path: str = "coordination") -> None:
        if not self.enabled:
            return
        outcome = "ok" if failure is None else type(failure).__name__
        self.registry.counter("accord_coordinate_outcomes_total",
                              outcome=outcome, path=path,
                              **self._dc_labels).inc()
        now = self.now_us()
        span = self.spans.event(trace_key(txn_id), "end", now,
                                {"outcome": outcome})
        begin = span.first("begin")
        if begin is not None:
            self.registry.histogram("accord_txn_latency_us",
                                    path=span.path or path,
                                    **self._dc_labels) \
                .observe(max(0, now - begin[0]))
        rounds = sum(1 for _, ph, _ in span.events if ph in ROUND_PHASES)
        if rounds:
            self.registry.histogram("accord_coordination_rounds",
                                    path=span.path or path).observe(rounds)
        self._observe_phase_latencies(span)

    def _observe_phase_latencies(self, span) -> None:
        """Delta between consecutive present milestones -> per-phase
        latency histograms (first occurrence of each milestone)."""
        for ph, dur in phase_deltas(phase_firsts(span)):
            self.registry.histogram("accord_phase_latency_us", phase=ph,
                                    **self._dc_labels).observe(dur)

    # -------------------------------------------------------- replica side --
    def rx(self, trace_id: str, verb: str, from_id: int) -> None:
        """Inbound traced request: stitch this replica into the span."""
        if not self.enabled:
            return
        self.spans.event(trace_id, f"rx:{verb}", self.now_us(),
                         {"from": from_id})

    # ------------------------------------------------------------ export --
    def snapshot(self) -> dict:
        """JSON-safe per-node snapshot (the wire/bench/burn interchange
        format; merge with obs.report.merge_node_snapshots).  When the
        protocol-CPU profiler has samples, they ride as the "cpu" key so
        the cross-node merge can compute exact-sample quantiles."""
        from accord_tpu_torch.obs.report import summarize
        cpu = self.cpuprof.export()
        metrics = self.registry.snapshot()
        snap = {"node": self.node_id, "metrics": metrics,
                "summary": summarize(metrics, cpu=cpu)}
        if cpu is not None:
            snap["cpu"] = cpu
        return snap

    def cpu_view(self) -> dict:
        """The live protocol-CPU + loop-health view (httpd `GET /top`, the
        tcp host's "top" frame, `burn --cpu-top`): this node's per-verb
        waterfall and top-verbs table plus the event-loop health gauges."""
        from accord_tpu_torch.obs.report import cpu_section, loop_section
        metrics = self.registry.snapshot()
        return {"node": self.node_id,
                "cpu": cpu_section(self.cpuprof.export()),
                "loop": loop_section(metrics)}
