"""Scheduler SPI implementation over the simulated queue (reference: the burn
Cluster implements accord.api.Scheduler — Cluster.java:102)."""

from __future__ import annotations

from typing import Callable

from accord_tpu_torch.api.spi import Scheduler
from accord_tpu_torch.sim.queue import PendingQueue


class SimScheduler(Scheduler):
    def __init__(self, queue: PendingQueue):
        self.queue = queue

    def once(self, delay_s: float, fn: Callable[[], None]):
        return self.queue.add(int(delay_s * 1e6), fn)

    def recurring(self, delay_s: float, fn: Callable[[], None]):
        return self.queue.add_recurring(int(delay_s * 1e6), fn)

    def now(self, fn: Callable[[], None]) -> None:
        self.queue.add(0, fn)

    def now_s(self) -> float:
        return self.queue.clock.now_s()
