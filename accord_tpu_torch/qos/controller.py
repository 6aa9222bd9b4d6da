"""Adaptive shed-pressure controller for the QoS admission tier.

Folds the host's REAL bottleneck signals into one normalized pressure
scalar (1.0 == "the lag target is being missed"), instead of a static
queue-depth bound:

  * loop-lag EWMA — fed by the scheduler's `lag_observer` hook (the same
    loop-health signal behind `accord_loop_lag_us`), decayed toward zero
    with a configurable half-life so a recovered loop stops shedding without
    needing new timer fires to prove it;
  * loop saturation — `LoopHealth.saturated` (edge-triggered backlog
    alarm) floors pressure into the normal-shed band: a saturated loop
    sheds `normal` traffic too, not just `best_effort`;
  * WAL group-commit queue depth — when journaling is on, fsync is often
    the true bottleneck before the loop itself lags; depth/`wal_target`
    contributes linearly;
  * extra sources — arbitrary `() -> float` normalized-pressure callables.
    The sim wires the pipeline ingest depth here (its only deterministic
    backlog signal: virtual time never produces real loop lag).

Pressure is the MAX of the contributions — shedding tracks whichever
resource is the bottleneck right now.

Thread shape: `observe_lag` runs on the loop thread (scheduler hook);
`pressure()` runs on the loop thread too (from `QosTier.admit`).  The WAL
depth read crosses into the journal flush thread's territory — a lock-free
`len()` of the commit buffer, intentionally approximate (see
journal/wal.py `queue_depth`).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional


class PressureController:
    """Normalized admission pressure from live host signals."""

    __slots__ = ("config", "clock_us", "loop_health", "wal", "sources",
                 "_lag_ewma_us", "_lag_stamp_us")

    def __init__(self, config, clock_us, loop_health=None, wal=None,
                 sources: Iterable[Callable[[], float]] = ()):
        self.config = config
        self.clock_us = clock_us
        self.loop_health = loop_health
        self.wal = wal
        self.sources: List[Callable[[], float]] = list(sources)
        self._lag_ewma_us = 0.0
        self._lag_stamp_us = int(clock_us())

    # ------------------------------------------------------------ lag ewma --
    def _decayed(self, now_us: int) -> float:
        """Decay the lag EWMA by elapsed wall/virtual time (half-life from
        config) — recovery must not wait for the next late timer."""
        dt_s = (now_us - self._lag_stamp_us) * 1e-6
        if dt_s > 0:
            self._lag_ewma_us *= 0.5 ** (dt_s / self.config.ewma_half_life_s)
            self._lag_stamp_us = now_us
        return self._lag_ewma_us

    def observe_lag(self, lag_s: float) -> None:
        """One timer fired `lag_s` late (scheduler hook, loop thread)."""
        now = int(self.clock_us())
        current = self._decayed(now)
        lag_us = lag_s * 1e6
        if lag_us > current:
            # rise fast (half the gap per observation), decay on the clock
            self._lag_ewma_us = current + 0.5 * (lag_us - current)

    def lag_us(self, now_us: Optional[int] = None) -> float:
        """Current decayed loop-lag estimate, for retry_after hints."""
        if now_us is None:
            now_us = int(self.clock_us())
        return self._decayed(now_us)

    # ------------------------------------------------------------ pressure --
    def pressure(self, now_us: Optional[int] = None) -> float:
        if now_us is None:
            now_us = int(self.clock_us())
        cfg = self.config
        p = self._decayed(now_us) / cfg.lag_target_us
        lh = self.loop_health
        if lh is not None and lh.saturated:
            p = max(p, cfg.normal_pressure)
        wal = self.wal
        if wal is not None:
            p = max(p, wal.queue_depth() / cfg.wal_target)
        for src in self.sources:
            p = max(p, src())
        return p
