"""Virtual-time pending queue (reference: accord-core test
impl/basic/RandomDelayQueue.java:19, PendingQueue, PropagatingPendingQueue).

A single heap of (virtual_time_us, seq) ordered Pending items; seq breaks ties
deterministically in insertion order. Assertion failures raised inside items
propagate out of the drive loop (PropagatingPendingQueue semantics).
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

from accord_tpu_torch.utils.random_source import RandomSource


class Pending:
    __slots__ = ("at_us", "seq", "fn", "cancelled")

    def __init__(self, at_us: int, seq: int, fn: Callable[[], None]):
        self.at_us = at_us
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Pending"):
        return (self.at_us, self.seq) < (other.at_us, other.seq)


class RecurringHandle:
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class SimClock:
    """Virtual microsecond clock owned by the queue."""

    __slots__ = ("now_us",)

    def __init__(self):
        self.now_us = 0

    def now_s(self) -> float:
        return self.now_us / 1e6


class PendingQueue:
    def __init__(self, random: RandomSource = None):
        self.clock = SimClock()
        self._heap: List[Pending] = []
        self._seq = 0
        self._failures: List[BaseException] = []
        self.random = random or RandomSource(0)
        self.processed = 0

    # -- scheduling --
    def add(self, delay_us: int, fn: Callable[[], None]) -> Pending:
        p = Pending(self.clock.now_us + max(0, delay_us), self._seq, fn)
        self._seq += 1
        heapq.heappush(self._heap, p)
        return p

    def add_recurring(self, period_us: int, fn: Callable[[], None]
                      ) -> RecurringHandle:
        handle = RecurringHandle()

        def run():
            if handle.cancelled:
                return
            fn()
            if not handle.cancelled:
                self.add(period_us, run)

        self.add(period_us, run)
        return handle

    def add_random_delay(self, min_us: int, max_us: int,
                         fn: Callable[[], None]) -> Pending:
        delay = min_us if max_us <= min_us else self.random.next_int(min_us, max_us)
        return self.add(delay, fn)

    def fail(self, failure: BaseException) -> None:
        """Record a failure to propagate out of the drive loop."""
        self._failures.append(failure)

    # -- draining --
    @property
    def size(self) -> int:
        return len(self._heap)

    def is_empty(self) -> bool:
        return not self._heap

    def process_one(self) -> bool:
        """Run the next pending item; returns False when drained."""
        while self._heap:
            p = heapq.heappop(self._heap)
            if p.cancelled:
                continue
            self.clock.now_us = max(self.clock.now_us, p.at_us)
            self._run(p)
            self._raise_failures()
            return True
        self._raise_failures()
        return False

    def _run(self, p: Pending) -> None:
        self.processed += 1
        try:
            p.fn()
        except BaseException as e:  # noqa: BLE001 - propagate via drive loop
            self._failures.append(e)

    def _raise_failures(self) -> None:
        if self._failures:
            failure = self._failures[0]
            for extra in self._failures[1:]:
                try:
                    failure.__context__ = extra
                except Exception:
                    pass
            self._failures = []
            raise failure

    def drain(self, until_us: Optional[int] = None, max_items: int = 10_000_000
              ) -> int:
        """Process items until empty / virtual deadline / item budget."""
        n = 0
        while self._heap and n < max_items:
            if until_us is not None and self._heap[0].at_us > until_us:
                break
            if not self.process_one():
                break
            n += 1
        return n
