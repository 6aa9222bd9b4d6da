"""Protocol-tier CPU attribution profiler + event-loop health telemetry.

Protocol CPU (~2 ms per txn per node spent in message applies in
`local/`) is the binding constraint of the multi-core host; this module is
the measurement base `local/` optimizations are judged against — the
protocol-tier sibling of the device-kernel waterfall (obs/profiler.py):

  * `CpuProfiler` — sampled 1-in-N (`ACCORD_CPU_PROFILE=N`, off by
    default) per-dispatch attribution: every inbound message a node
    processes is split into decode -> apply -> CFK/conflict-index work ->
    reply-encode stages, labeled by verb.  Fences live at the layer
    boundaries (hosts time the wire decode, `local/node.py` brackets the
    dispatch, `local/commands.py`/`local/store.py` fence the
    CommandsForKey work — PAPER.md's hot computational kernel —
    and `Node.reply` fences the reply encode).  Exact-sample p50/p99 per
    (verb, stage) come from bounded raw-sample buffers, never the log2
    buckets, for the same reason the kernel profiler keeps raw samples: a
    bucket quantile's [1x, 2x) error would false-trip a 15% gate.

  * `LoopHealth` — ALWAYS-ON event-loop health gauges for the wall-clock
    hosts (`host/tcp.py`, `host/maelstrom.py`): the loop-lag histogram
    (scheduled-vs-actual timer fire delta — the direct measurement of a
    saturated dispatch loop), tick busy duration, dispatch-burst length
    and leftover pending-queue depth, plus `loop_lag` /
    `queue_saturation` flight-recorder alarms when lag or backlog cross
    their thresholds — so saturation is visible BEFORE throughput
    collapses.

OFF-BY-DEFAULT CONTRACT: with `ACCORD_CPU_PROFILE` unset, the dispatch
hooks are one attribute check each (enforced <2% of the scalar hot loop
by tests/test_obs_budget.py).  When enabled, unsampled dispatches pay a
dict increment and a modulo.

`ACCORD_CPU_SCALE` (float, default 1) scales recorded durations — the
test hook that lets `bench.py --guard`'s per-verb regression gate be
exercised with a synthetic slowdown, mirroring `ACCORD_PROFILE_SCALE`
(tests/test_bench_guard.py).

HARD CONSTRAINT (package docstring): no jax/numpy imports; intra-package
accord_tpu_torch imports only.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

# raw-sample cap per (verb, stage) AND per-verb total: exact p50/p99
# without unbounded growth.  The caps are EQUAL so a verb's stage sample
# lists are index-aligned prefixes of its total list — per-sample
# stage <= total then implies p50(stage) <= p50(total), an invariant the
# sampled-on burn test asserts.
_MAX_SAMPLES = 256

# the additive stage set every sampled dispatch decomposes into; "apply"
# is exclusive (dispatch wall minus the nested cfk/reply_encode fences)
STAGES = ("decode", "apply", "cfk", "reply_encode")

# stages measured via nested fences INSIDE the dispatch bracket; their
# time is subtracted from the enclosing "apply" so the waterfall is
# additive: decode + apply + cfk + reply_encode == total
_NESTED_STAGES = ("cfk", "reply_encode")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class CpuProfiler:
    """Per-node protocol-CPU profiler writing into a metrics registry.

    Registry metrics (always mirrored on export for /metrics):
      accord_cpu_stage_us{verb,stage}     histogram — per-stage wall time
      accord_cpu_dispatch_us{verb}        histogram — per-dispatch total
      accord_cpu_dispatches_total{verb}   counter — ALL dispatches while
                                          enabled (the sampling denominator
                                          and the verb census)
      accord_cpu_sampled_total            counter — sampled dispatches
    """

    __slots__ = ("registry", "sample_n", "enabled", "active", "_clock",
                 "_scale", "_tick", "_verb", "_t0", "_acc",
                 "_pending_decode", "_samples", "_totals", "_dispatches",
                 "_sampled", "_stage_hists", "_total_hists")

    def __init__(self, registry, sample_n: int = 0, clock=None):
        self.registry = registry
        self.sample_n = sample_n
        self.enabled = sample_n > 0
        self.active = False  # a sampled dispatch is open RIGHT NOW
        self._clock = clock if clock is not None else time.perf_counter
        self._scale = _env_float("ACCORD_CPU_SCALE", 1.0)
        self._tick = 0
        self._verb: Optional[str] = None
        self._t0 = 0.0
        self._acc: Dict[str, float] = {}
        self._pending_decode = 0.0
        self._samples: Dict[str, Dict[str, List[float]]] = {}  # verb->stage
        self._totals: Dict[str, List[float]] = {}              # verb->[us]
        self._dispatches: Dict[str, int] = {}                  # verb->count
        self._sampled = 0
        # histogram handles cached per (verb, stage) / verb: dispatch_end
        # runs per sampled dispatch and must not pay a labeled registry
        # lookup per stage (the profiler's own overhead lands inside the
        # very p50s it reports)
        self._stage_hists: Dict[tuple, object] = {}
        self._total_hists: Dict[str, object] = {}

    # -------------------------------------------------------- decode hook --
    def note_decode(self, dur_s: float) -> None:
        """Hosts time the per-message wire decode (which happens BEFORE the
        node dispatch exists) and park it here; the next dispatch_begin
        consumes it into the sample's "decode" stage.  Native-codec TCP
        ingress decodes whole frames in the loop's parser — that cost shows
        in LoopHealth's tick duration, not here."""
        self._pending_decode = dur_s

    # ---------------------------------------------------- dispatch bracket --
    def dispatch_begin(self, verb: str) -> bool:
        """Open the per-dispatch attribution bracket in Node._process.
        Counts every dispatch (the census --guard's top-verbs table scales
        by), decides 1-in-N sampling, and folds any parked decode lap.
        Returns whether this dispatch is sampled (the caller must then pair
        it with dispatch_end)."""
        self._dispatches[verb] = self._dispatches.get(verb, 0) + 1
        decode = self._pending_decode
        if decode:
            self._pending_decode = 0.0
        if self.active:
            # a nested local apply inside an open sample is absorbed into
            # the enclosing dispatch's stages, never double-counted
            return False
        self._tick += 1
        if self._tick % self.sample_n:
            return False
        self._sampled += 1
        self.active = True
        self._verb = verb
        self._acc = {"decode": decode} if decode else {}
        self._t0 = self._clock()
        return True

    def stage_begin(self) -> float:
        """Start a nested stage fence (call only when `active`)."""
        return self._clock()

    def stage_end(self, t: float, stage: str) -> None:
        """Close a nested stage fence, accumulating into `stage`."""
        self._acc[stage] = self._acc.get(stage, 0.0) + (self._clock() - t)

    def dispatch_end(self) -> None:
        """Close the sampled dispatch: apply = wall - nested fences, then
        record every stage + the per-verb total (histograms + raw
        samples)."""
        total = self._clock() - self._t0
        self.active = False
        verb = self._verb
        acc = self._acc
        nested = 0.0
        for s in _NESTED_STAGES:
            nested += acc.get(s, 0.0)
        acc["apply"] = max(0.0, total - nested)
        total += acc.get("decode", 0.0)
        scale = self._scale
        reg = self.registry
        by_stage = self._samples.get(verb)
        if by_stage is None:
            by_stage = self._samples[verb] = {}
        for stage, dur in acc.items():
            us = round(dur * scale * 1e6, 1)
            h = self._stage_hists.get((verb, stage))
            if h is None:
                h = self._stage_hists[(verb, stage)] = reg.histogram(
                    "accord_cpu_stage_us", verb=verb, stage=stage)
            h.observe(us)
            samples = by_stage.get(stage)
            if samples is None:
                samples = by_stage[stage] = []
            if len(samples) < _MAX_SAMPLES:
                samples.append(us)
        us_total = round(total * scale * 1e6, 1)
        h = self._total_hists.get(verb)
        if h is None:
            h = self._total_hists[verb] = reg.histogram(
                "accord_cpu_dispatch_us", verb=verb)
        h.observe(us_total)
        totals = self._totals.get(verb)
        if totals is None:
            totals = self._totals[verb] = []
        if len(totals) < _MAX_SAMPLES:
            totals.append(us_total)

    # -------------------------------------------------------------- export --
    def export(self) -> Optional[dict]:
        """Raw-sample export for the cross-node merge (rides NodeObs
        snapshots as the "cpu" key; obs/report.cpu_section summarizes).
        Mirrors the census counters into the registry so /metrics carries
        them.  None when nothing was recorded (profiling off)."""
        if not self._sampled and not self._dispatches:
            return None
        reg = self.registry
        for verb, n in self._dispatches.items():
            reg.counter("accord_cpu_dispatches_total", verb=verb).value = n
        reg.counter("accord_cpu_sampled_total").value = self._sampled
        return {
            "sampled": self._sampled,
            "dispatches": dict(self._dispatches),
            "totals": {v: list(s) for v, s in self._totals.items()},
            "stages": {v: {st: list(ss) for st, ss in by.items()}
                       for v, by in self._samples.items()},
        }


def merge_cpu_exports(exports) -> Optional[dict]:
    """Pool CpuProfiler.export() dicts from several nodes into one:
    dispatch counts sum, raw sample lists concatenate (every list is
    bounded per node, so the pool is bounded by node count)."""
    exports = [e for e in exports if e]
    if not exports:
        return None
    out = {"sampled": 0, "dispatches": {}, "totals": {}, "stages": {}}
    for e in exports:
        out["sampled"] += e.get("sampled", 0)
        for verb, n in e.get("dispatches", {}).items():
            out["dispatches"][verb] = out["dispatches"].get(verb, 0) + n
        for verb, s in e.get("totals", {}).items():
            out["totals"].setdefault(verb, []).extend(s)
        for verb, by in e.get("stages", {}).items():
            dst = out["stages"].setdefault(verb, {})
            for stage, ss in by.items():
                dst.setdefault(stage, []).extend(ss)
    return out


def cpu_profiler_from_env(registry,
                          env: str = "ACCORD_CPU_PROFILE") -> CpuProfiler:
    """ACCORD_CPU_PROFILE=N -> sample 1-in-N dispatches (N=1 samples every
    dispatch); unset/0/garbage -> disabled (the hot-path default)."""
    raw = os.environ.get(env, "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        n = 0
    return CpuProfiler(registry, sample_n=max(0, n))


# ---------------------------------------------------------- loop health ----

class LoopHealth:
    """Always-on event-loop health gauges for a wall-clock host loop.

    The selector/stdio loops are each node's ONLY protocol thread: when it
    saturates, timers fire late (RPC timeouts stretch, coalescing ticks
    slip) long before throughput visibly collapses.  These gauges make
    that stage observable:

      accord_loop_lag_us          histogram — scheduled-vs-actual timer
                                  fire delta (rt.RealTimeScheduler hook)
      accord_loop_tick_us         histogram — busy (non-blocking) portion
                                  of each loop pass that did work
      accord_loop_burst_msgs      histogram — dispatch-burst length per
                                  pass (inbound frames + loopback items)
      accord_loop_depth_max       gauge — high-water leftover queue depth
                                  measured AFTER a pass (work the pass
                                  could not drain)
      accord_loop_lag_alarms_total / accord_loop_queue_saturation_total
                                  counters — threshold crossings

    Alarms also land on the flight ring (`loop_lag`, rate-limited;
    `queue_saturation`, edge-triggered) so the cross-replica forensics
    timeline shows saturation next to the traffic that caused it.
    Thresholds: `ACCORD_LOOP_LAG_ALARM_US` (default 100000) and
    `ACCORD_LOOP_SATURATION_DEPTH` (default 512)."""

    __slots__ = ("flight", "_h_lag", "_h_tick", "_h_burst", "_g_depth",
                 "_c_lag_alarms", "_c_sat_alarms", "lag_alarm_us",
                 "saturation_depth", "_clock", "_last_lag_flight",
                 "_saturated")

    def __init__(self, registry, flight, clock=None):
        self.flight = flight
        self._h_lag = registry.histogram("accord_loop_lag_us")
        self._h_tick = registry.histogram("accord_loop_tick_us")
        self._h_burst = registry.histogram("accord_loop_burst_msgs")
        self._g_depth = registry.gauge("accord_loop_depth_max")
        self._c_lag_alarms = registry.counter("accord_loop_lag_alarms_total")
        self._c_sat_alarms = registry.counter(
            "accord_loop_queue_saturation_total")
        self.lag_alarm_us = int(_env_float("ACCORD_LOOP_LAG_ALARM_US",
                                           100_000))
        self.saturation_depth = int(_env_float("ACCORD_LOOP_SATURATION_DEPTH",
                                               512))
        self._clock = clock if clock is not None else time.monotonic
        # -inf so the FIRST alarm always reaches the ring regardless of
        # the clock's epoch
        self._last_lag_flight = float("-inf")
        self._saturated = False

    def timer_lag(self, lag_s: float) -> None:
        """One timer ran `lag_s` after its deadline (the scheduler hook:
        rt.RealTimeScheduler.lag_observer).  Zero-delay timers measure pure
        queue delay, which is exactly the loop-lag semantics wanted."""
        lag_us = int(lag_s * 1e6)
        self._h_lag.observe(lag_us)
        if lag_us > self.lag_alarm_us:
            self._c_lag_alarms.inc()
            now = self._clock()
            # rate-limit the forensics record: a saturated loop runs MANY
            # late timers per pass and must not wash out its own ring
            if now - self._last_lag_flight >= 0.25:
                self._last_lag_flight = now
                self.flight.record("loop_lag", None, (lag_us,))

    @property
    def saturated(self) -> bool:
        """Current (edge-triggered, hysteresis-cleared) saturation state —
        the QoS admission tier reads this as a pressure floor."""
        return self._saturated

    def tick(self, busy_s: float, burst: int, depth: int) -> None:
        """One loop pass that did work: `busy_s` excludes the blocking
        poll, `burst` is the dispatched item count, `depth` the backlog
        left undrained when the pass ended."""
        self._h_tick.observe(int(busy_s * 1e6))
        if burst:
            self._h_burst.observe(burst)
        if depth > self._g_depth.value:
            self._g_depth.value = depth
        if depth >= self.saturation_depth:
            if not self._saturated:
                self._saturated = True
                self._c_sat_alarms.inc()
                self.flight.record("queue_saturation", None, (depth,))
        elif self._saturated and depth < self.saturation_depth // 2:
            self._saturated = False
