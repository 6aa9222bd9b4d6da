"""Per-tenant QoS admission: token buckets, priority classes, typed nack.

The QoS tier is the host boundary's OUTER admission ring.  It runs before
any coordination state or journal append is spent on a submit: a rejected
transaction was never coordinated anywhere, so the nack is retriable by
construction (same guarantee as the pipeline's `Rejected`, which this
tier's nack subclasses — existing shed accounting in burn/bench clients
keeps working unchanged).

Three mechanisms, in decision order:

  1. pressure shed — the adaptive controller (qos/controller.py) folds the
     host's real bottleneck signals (loop-lag EWMA, loop saturation, WAL
     group-commit queue depth) into one normalized scalar, maxed with the
     tier's own admitted-but-unsettled backlog (`inflight/depth_target`,
     the signal that clamps admission to the concurrency the node
     sustains instead of oscillating on after-the-fact lag); a submit whose
     priority class's threshold is at/below the current pressure is shed.
     `best_effort` sheds first, `normal` at double the pressure, and
     `high` is NEVER pressure-shed — only the pipeline's bounded queue
     (the last-resort inner ring) can reject it.
  2. tenant throttle — a per-tenant token bucket with burst credit
     (`ACCORD_QOS_RATE` / `ACCORD_QOS_BURST`; rate 0 disables the
     bucket).  Keeps one chatty tenant from starving the rest even when
     the node itself is healthy.  `high` spends from the same bucket but
     by OVERDRAFT: it is never throttled, it drives the bucket negative
     (floored at -burst) and the debt is repaid out of the bulk tiers'
     refill.  That keeps the tenant's total admitted rate bounded by the
     bucket at every offered load — which is what preserves latency
     headroom for the high class at deep overload — while still giving
     high strict priority over its own tenant's bulk traffic.
  3. inner ring — the pipeline ingest queue's depth bound stays armed
     behind the tier; its sheds are tallied here too so the exported
     accounting covers every rejection path.

Every nack carries `retry_after_us` computed from bucket refill time plus
the measured loop lag, so clients back off proportionally to how far the
node actually is from keeping up.

Single-threaded by construction on the admission side: `admit()` runs on
the owning host's loop thread (TCP selector / Maelstrom stdio / sim
virtual-time queue), like the command stores and the ingest queue.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from accord_tpu_torch.pipeline.backpressure import Rejected
from accord_tpu_torch.qos.controller import PressureController

PRIORITIES = ("high", "normal", "best_effort")

_RETRY_CAP_US = 2_000_000  # never tell a client to stay away longer than 2s


class QosRejected(Rejected):
    """QoS admission nack: the transaction was NEVER submitted to the
    protocol (no coordination state, no journal append — safe to retry).
    Carries the machine-readable hint clients use for jittered backoff."""

    def __init__(self, message: str = "", retry_after_us: int = 0,
                 tenant: str = "", priority: str = "normal",
                 reason: str = "shed"):
        super().__init__(message)
        self.retry_after_us = int(retry_after_us)
        self.tenant = tenant
        self.priority = priority
        self.reason = reason  # "shed" (pressure) | "throttle" (bucket)

    def wire_extra(self) -> Dict[str, object]:
        """Fields the wire codec re-attaches on decode (host/wire.py keeps
        only `str(exc)` for plain exceptions; the retry hint must survive
        the trip or remote clients cannot honor it)."""
        return {"retry_after_us": self.retry_after_us, "tenant": self.tenant,
                "priority": self.priority, "reason": self.reason}


class QosConfig:
    """Tunables for the QoS admission tier (env-overridable on hosts).

    Pressure is normalized so 1.0 means "the configured lag target is being
    missed" — `shed_pressure` is the `best_effort` threshold, `normal` sheds
    at `normal_pressure`, `high` has no pressure threshold at all."""

    def __init__(self, rate_per_s: float = 0.0, burst: float = 0.0,
                 shed_pressure: float = 1.0, normal_pressure: float = 2.0,
                 lag_target_us: float = 50_000.0, depth_target: float = 128.0,
                 wal_target: int = 256, ewma_half_life_s: float = 0.5,
                 retry_floor_us: int = 10_000, shard_factor: float = 2.0):
        self.rate_per_s = max(0.0, rate_per_s)
        self.burst = burst if burst > 0 else max(1.0, self.rate_per_s)
        # per-shard sub-quota slack under the worker runtime: each
        # (tenant, shard) bucket gets rate/n * shard_factor, so a skewed
        # tenant can lean on a hot shard up to factor× its fair share
        # while the node-level bucket stays the binding total cap
        self.shard_factor = max(1.0, shard_factor)
        self.shed_pressure = shed_pressure
        self.normal_pressure = max(normal_pressure, shed_pressure)
        self.lag_target_us = max(1.0, lag_target_us)
        # fractional targets are meaningful: inflight is an integer, so
        # e.g. 1.5 sheds best_effort at 2 in flight and normal at 3
        self.depth_target = max(0.25, float(depth_target))
        self.wal_target = max(1, wal_target)
        self.ewma_half_life_s = max(1e-3, ewma_half_life_s)
        self.retry_floor_us = max(0, retry_floor_us)

    @classmethod
    def from_env(cls) -> "QosConfig":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return default

        return cls(
            rate_per_s=_f("ACCORD_QOS_RATE", 0.0),
            burst=_f("ACCORD_QOS_BURST", 0.0),
            shed_pressure=_f("ACCORD_QOS_SHED_PRESSURE", 1.0),
            normal_pressure=_f("ACCORD_QOS_NORMAL_PRESSURE", 2.0),
            lag_target_us=_f("ACCORD_QOS_LAG_TARGET_US", 50_000.0),
            depth_target=_f("ACCORD_QOS_DEPTH_TARGET", 128.0),
            wal_target=int(_f("ACCORD_QOS_WAL_TARGET", 256)),
            retry_floor_us=int(_f("ACCORD_QOS_RETRY_FLOOR_US", 10_000)),
            shard_factor=_f("ACCORD_QOS_SHARD_FACTOR", 2.0))

    def pressure_limit(self, priority: str) -> float:
        """Shed threshold for a priority class; inf means never
        pressure-shed (the burn's fairness invariant — high-priority ops
        are only rejectable by the bounded inner ring)."""
        if priority == "high":
            return float("inf")
        if priority == "normal":
            return self.normal_pressure
        return self.shed_pressure

    def __repr__(self):
        return (f"QosConfig(rate={self.rate_per_s} burst={self.burst} "
                f"shed={self.shed_pressure} normal={self.normal_pressure} "
                f"lag_target_us={self.lag_target_us})")


class TokenBucket:
    """Classic leaky token bucket with burst credit, lazily refilled on the
    caller's clock (injected, so the sim's virtual time keeps admission
    deterministic)."""

    __slots__ = ("rate", "burst", "tokens", "_last_us")

    def __init__(self, rate_per_s: float, burst: float, now_us: int):
        self.rate = rate_per_s
        self.burst = burst
        self.tokens = burst  # start full: a fresh tenant gets its burst
        self._last_us = now_us

    def _refill(self, now_us: int) -> None:
        elapsed_us = now_us - self._last_us
        if elapsed_us > 0:
            self.tokens = min(self.burst,
                              self.tokens + elapsed_us * 1e-6 * self.rate)
            self._last_us = now_us

    def try_take(self, now_us: int) -> float:
        """Take one token.  Returns 0.0 on success, else the refill delay
        in microseconds until one token will be available."""
        self._refill(now_us)
        # 1e-9 epsilon: refill arithmetic like 0.1s * 10/s lands at
        # 0.999...9 and must still count as a whole token
        if self.tokens >= 1.0 - 1e-9:
            self.tokens = max(0.0, self.tokens - 1.0)
            return 0.0
        return (1.0 - self.tokens) / self.rate * 1e6

    def refund(self) -> None:
        """Return one token (a later admission stage refused the op after
        this bucket had already charged it)."""
        self.tokens = min(self.burst, self.tokens + 1.0)

    def overdraw(self, now_us: int) -> None:
        """Unconditionally spend one token, allowing the bucket to go
        negative (floored at -burst so a surge can starve the bulk tiers
        for at most burst/rate seconds after it ends).  The high class
        uses this: never throttled itself, but its spend is repaid out of
        the same tenant's refill, so the tenant's TOTAL admitted rate
        stays bounded by the bucket."""
        self._refill(now_us)
        self.tokens = max(-self.burst, self.tokens - 1.0)


class QosTier:
    """One node's QoS admission tier.

    `admit(tenant, priority)` returns None (admitted) or a `QosRejected`
    ready to settle/ship as the nack.  Counters are per (tenant, priority)
    labeled `accord_qos_*_total` registry series, so the exported
    accounting identity

        admitted + shed + throttled == submitted   (per label pair)

    holds exactly — the burn and the slo-overload lane assert it."""

    def __init__(self, config: QosConfig, registry, flight, clock_us,
                 controller: Optional[PressureController] = None,
                 n_shards: int = 0):
        self.config = config
        self.registry = registry
        self.flight = flight
        self.clock_us = clock_us
        self.controller = controller if controller is not None else \
            PressureController(config, clock_us)
        self._buckets: Dict[str, TokenBucket] = {}
        # per-(tenant, shard) sub-buckets under the worker runtime
        # (ACCORD_SHARDS >= 2): a tenant hammering ONE worker's keyspace
        # slice is throttled at factor× its fair share of that shard
        # before it can queue the whole node quota onto one event loop.
        # The node-level bucket above stays the binding total cap — a
        # shard refusal refunds it, so the identity per (tenant,
        # priority) still balances and no token leaks.
        self.n_shards = n_shards if n_shards >= 2 else 0
        self._shard_buckets: Dict[Tuple[str, int], TokenBucket] = {}
        self._shard_ctrs: Dict[Tuple[str, int], object] = {}
        self._ctrs: Dict[Tuple[str, str, str], object] = {}
        self._g_pressure = registry.gauge("accord_qos_pressure_milli")
        self._g_inflight = registry.gauge("accord_qos_inflight")
        self._c_inner = registry.counter("accord_qos_inner_shed_total")
        self._admits_since_flight = 0
        # admitted-but-unsettled ops: the host calls op_done() when the
        # submit's reply ships.  inflight/depth_target is the tier's own
        # backlog signal — loop lag alone oscillates (it only rises after
        # the damage is queued), while inflight clamps admission to the
        # concurrency the node actually sustains
        self.inflight = 0

    # ------------------------------------------------------------ signals --
    def observe_lag(self, lag_s: float) -> None:
        """Scheduler lag-observer hook (chained after LoopHealth.timer_lag
        on the loop thread)."""
        self.controller.observe_lag(lag_s)

    # ----------------------------------------------------------- decision --
    def _counter(self, kind: str, tenant: str, priority: str):
        key = (kind, tenant, priority)
        c = self._ctrs.get(key)
        if c is None:
            c = self.registry.counter(f"accord_qos_{kind}_total",
                                      tenant=tenant, priority=priority)
            self._ctrs[key] = c
        return c

    def _retry_after_us(self, now_us: int, refill_us: float = 0.0,
                        pressure: float = 0.0) -> int:
        """Backoff hint: measured loop lag, floored by retry_floor scaled
        with pressure (an inflight-clamped node has LOW lag while turning
        work away — the hint must still grow with how overloaded it is)."""
        lag_us = self.controller.lag_us(now_us)
        floor = self.config.retry_floor_us * max(1.0, pressure)
        return int(min(_RETRY_CAP_US, max(floor, lag_us) + refill_us))

    def _shard_throttle(self, tenant: str, shard: int,
                        now: int) -> float:
        """Charge the (tenant, shard) sub-bucket; 0.0 admits, else the
        refill delay in microseconds.  Lazily built at rate/n × factor —
        slack for skew, but one shard can never drain the node quota."""
        key = (tenant, shard)
        bucket = self._shard_buckets.get(key)
        if bucket is None:
            scale = self.config.shard_factor / self.n_shards
            bucket = TokenBucket(self.config.rate_per_s * scale,
                                 max(1.0, self.config.burst * scale), now)
            self._shard_buckets[key] = bucket
        return bucket.try_take(now)

    def _shard_counter(self, tenant: str, shard: int):
        key = (tenant, shard)
        c = self._shard_ctrs.get(key)
        if c is None:
            c = self.registry.counter("accord_qos_shard_throttled_total",
                                      tenant=tenant, shard=shard)
            self._shard_ctrs[key] = c
        return c

    def admit(self, tenant: str, priority: str,
              shard: Optional[int] = None) -> Optional[QosRejected]:
        """One submit's admission decision, before any state is spent.
        `shard` (worker runtime only) keys the per-(tenant, shard)
        sub-bucket; None skips that stage."""
        now = self.clock_us()
        tenant = str(tenant) if tenant else "default"
        if priority not in PRIORITIES:
            priority = "normal"
        self._counter("submitted", tenant, priority).inc()
        pressure = max(self.controller.pressure(now),
                       self.inflight / self.config.depth_target)
        self._g_pressure.value = int(pressure * 1000)
        limit = self.config.pressure_limit(priority)
        if pressure >= limit:
            retry = self._retry_after_us(now, pressure=pressure)
            self._counter("shed", tenant, priority).inc()
            if self.flight is not None:
                self.flight.record("qos_shed", None,
                                   (tenant, priority, "pressure",
                                    int(pressure * 1000)))
            return QosRejected(
                f"qos shed: pressure {pressure:.2f} >= {limit:.2f} for "
                f"{priority}; retry after {retry}us",
                retry_after_us=retry, tenant=tenant, priority=priority,
                reason="shed")
        if self.config.rate_per_s > 0:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.config.rate_per_s,
                                     self.config.burst, now)
                self._buckets[tenant] = bucket
            # strict priority WITHIN the tenant's quota: high is never
            # throttled — it overdraws the shared bucket and the debt is
            # repaid out of the bulk tiers' refill.  (A plain bypass
            # would let admitted load grow with the high arrival rate and
            # erase the latency headroom the quota exists to protect; a
            # plain shared take would let a tenant flooding best_effort
            # starve its own high ops, since tokens go in arrival order.)
            refill_us = (bucket.overdraw(now) or 0.0) if priority == "high" \
                else bucket.try_take(now)
            if refill_us > 0:
                retry = self._retry_after_us(now, refill_us,
                                             pressure=pressure)
                self._counter("throttled", tenant, priority).inc()
                if self.flight is not None:
                    self.flight.record("qos_throttle", None,
                                       (tenant, priority, retry))
                return QosRejected(
                    f"qos throttle: tenant {tenant} over "
                    f"{self.config.rate_per_s}/s; retry after {retry}us",
                    retry_after_us=retry, tenant=tenant, priority=priority,
                    reason="throttle")
            if self.n_shards and shard is not None and priority != "high":
                # shard sub-quota AFTER the node bucket (which stays the
                # binding cap); high rides its overdraft unthrottled here
                # too, for the same within-tenant strict-priority reason
                shard_refill = self._shard_throttle(tenant, shard, now)
                if shard_refill > 0:
                    bucket.refund()  # the node token was provisional
                    retry = self._retry_after_us(now, shard_refill,
                                                 pressure=pressure)
                    self._counter("throttled", tenant, priority).inc()
                    self._shard_counter(tenant, shard).inc()
                    if self.flight is not None:
                        self.flight.record("qos_throttle", None,
                                           (tenant, priority, retry, shard))
                    return QosRejected(
                        f"qos throttle: tenant {tenant} over shard {shard} "
                        f"sub-quota; retry after {retry}us",
                        retry_after_us=retry, tenant=tenant,
                        priority=priority, reason="throttle")
        self._counter("admitted", tenant, priority).inc()
        self.inflight += 1
        self._g_inflight.value = self.inflight
        self._admits_since_flight += 1
        if self.flight is not None and (self._admits_since_flight >= 64
                                        or self._admits_since_flight == 1):
            self.flight.record("qos_admit", None,
                               (tenant, priority, self._admits_since_flight))
            if self._admits_since_flight >= 64:
                self._admits_since_flight = 0
        return None

    # --------------------------------------------------------- inner ring --
    def note_inner_shed(self, depth: int) -> None:
        """The pipeline's bounded ingest queue (last-resort inner ring)
        shed a txn that this tier had admitted — tally it so the exported
        accounting covers every rejection path."""
        self._c_inner.inc()
        if self.flight is not None:
            self.flight.record("qos_shed", None,
                               ("", "", "inner", depth))

    def op_done(self) -> None:
        """An admitted submit settled (ack OR failure reply shipped) — the
        host calls this exactly once per admitted op, from the loop thread,
        so `inflight` tracks the true unsettled backlog."""
        if self.inflight > 0:
            self.inflight -= 1
        self._g_inflight.value = self.inflight

    # ------------------------------------------------------------ inspect --
    def pressure(self) -> float:
        return max(self.controller.pressure(self.clock_us()),
                   self.inflight / self.config.depth_target)
