"""Real-time single-threaded runtime for external hosts.

The simulator drives nodes from a virtual-time PendingQueue; a host process
drives the same Node from wall time: a monotonic timer heap polled by the
host's select loop. Single-threaded by construction, so the command stores
keep the simulator's logically-single-threaded execution model without
locks (the reference pins stores to executors for the same guarantee).
"""

from __future__ import annotations

import heapq
import itertools
import sys
import time
from typing import Callable, List, Optional, Tuple

from accord_tpu_torch.api.spi import Scheduler


class TimerHandle:
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class RealTimeScheduler(Scheduler):
    """Scheduler SPI over a wall-clock timer heap; the owning loop calls
    `run_due()` between IO waits and sleeps until `next_deadline()`."""

    def __init__(self, on_error: Optional[Callable] = None):
        self._heap: List[Tuple[float, int, TimerHandle, Callable]] = []
        self._seq = itertools.count()
        # a raising timer must not kill the loop (the simulator routes timer
        # failures to the drive loop the same way, sim/queue.py)
        self.on_error: Callable = on_error if on_error is not None else (
            lambda e: print(f"timer error: {e!r}", file=sys.stderr,
                            flush=True))
        # loop-health hook (obs/cpuprof.LoopHealth.timer_lag): called with
        # (now - deadline) seconds for every due timer run — the
        # scheduled-vs-actual fire delta that makes loop saturation
        # measurable.  None (the default) costs one attribute check.
        self.lag_observer: Optional[Callable[[float], None]] = None

    def once(self, delay_s: float, fn: Callable[[], None]) -> TimerHandle:
        h = TimerHandle()
        heapq.heappush(self._heap,
                       (time.monotonic() + max(0.0, delay_s),
                        next(self._seq), h, fn))
        return h

    def recurring(self, delay_s: float, fn: Callable[[], None]) -> TimerHandle:
        h = TimerHandle()

        def tick():
            if h.cancelled:
                return
            try:
                fn()
            finally:  # a raising tick must not disarm the recurrence
                heapq.heappush(self._heap,
                               (time.monotonic() + delay_s, next(self._seq),
                                h, tick))

        heapq.heappush(self._heap,
                       (time.monotonic() + delay_s, next(self._seq), h, tick))
        return h

    def now(self, fn: Callable[[], None]) -> None:
        self.once(0.0, fn)

    def now_s(self) -> float:
        return time.monotonic()

    # ---------------------------------------------------------- loop hooks --
    def next_deadline(self) -> Optional[float]:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def run_due(self, limit: int = 1000) -> int:
        ran = 0
        now = time.monotonic()
        observer = self.lag_observer
        while self._heap and ran < limit:
            deadline, _, handle, fn = self._heap[0]
            if deadline > now:
                break
            heapq.heappop(self._heap)
            if handle.cancelled:
                continue
            if observer is not None:
                observer(now - deadline)
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                self.on_error(e)
            ran += 1
        return ran
