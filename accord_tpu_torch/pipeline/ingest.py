"""Admission queue: coalesce client transactions into micro-batches.

The continuous-batching admission layer of the ingest pipeline: incoming
client transactions enqueue here and are released to the batch coordinator
as deadline-bounded micro-batches — the same amortization discipline an
inference server applies to model steps (admit continuously, close a batch
when it is full OR its deadline expires, never park a lone request longer
than `max_wait_us`).

A batch closes when either
  * depth reaches `max_batch` (closed immediately, no timer wait), or
  * the oldest admitted txn has waited its effective deadline.

The deadline is ADAPTIVE to queue depth: a deepening queue is evidence of
arrival pressure, so the effective wait shrinks linearly toward
`max_wait_us / 8` as depth approaches `max_batch` — light traffic pays the
full window (maximum coalescing per dispatch), heavy traffic closes early
(the batch will fill again immediately; waiting only adds latency).

Single-threaded by construction: owned by the node's loop thread (TCP/
Maelstrom hosts) or the virtual-time queue (sim), like the command stores.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Deque, Optional

from accord_tpu_torch.pipeline.backpressure import (AdmissionController,
                                              PipelineStats, Rejected)
from accord_tpu_torch.utils.async_chains import AsyncResult


class PipelineConfig:
    """Tunables for the ingest pipeline (env-overridable on hosts)."""

    def __init__(self, max_batch: int = 8, max_wait_us: int = 2000,
                 max_queue: int = 256, adaptive: bool = True):
        self.max_batch = max(1, max_batch)
        self.max_wait_us = max(0, max_wait_us)
        self.max_queue = max(1, max_queue)
        self.adaptive = adaptive

    @classmethod
    def from_env(cls) -> "PipelineConfig":
        def _int(name: str, default: int) -> int:
            try:
                return int(os.environ.get(name, default))
            except ValueError:
                return default

        return cls(
            max_batch=_int("ACCORD_PIPELINE_MAX_BATCH", 8),
            max_wait_us=_int("ACCORD_PIPELINE_MAX_WAIT_US", 2000),
            max_queue=_int("ACCORD_PIPELINE_MAX_QUEUE", 256),
            adaptive=os.environ.get("ACCORD_PIPELINE_ADAPTIVE", "1") != "0")

    def __repr__(self):
        return (f"PipelineConfig(max_batch={self.max_batch} "
                f"max_wait_us={self.max_wait_us} max_queue={self.max_queue} "
                f"adaptive={self.adaptive})")


class Admitted:
    """One admitted transaction: the txn, its client-facing result, and the
    admission timestamp (for queue-wait accounting)."""

    __slots__ = ("txn", "result", "admitted_us")

    def __init__(self, txn, result: AsyncResult, admitted_us: int):
        self.txn = txn
        self.result = result
        self.admitted_us = admitted_us


class IngestQueue:
    """Deadline-bounded micro-batching admission queue.

    `dispatch(items)` is invoked with each closed batch (a list of Admitted,
    in admission order — the batch coordinator starts coordinations in this
    order, so conflicting txns admitted together witness each other in
    admission order on every replica that processes the batch envelope).
    """

    def __init__(self, scheduler, dispatch: Callable, config: PipelineConfig,
                 stats: Optional[PipelineStats] = None,
                 trace=None, flight=None, qos=None):
        from accord_tpu_torch.utils.tracing import NO_TRACE
        self.scheduler = scheduler
        self.dispatch = dispatch
        self.config = config
        self.stats = stats if stats is not None else PipelineStats()
        self.admission = AdmissionController(config.max_queue)
        self.trace = trace if trace is not None else NO_TRACE
        # node's flight recorder (obs/flight.py); admission decisions land
        # on the forensics ring so a shedding node's timeline explains a
        # client's Rejected.  None on bare queues (unit tests).
        self.flight = flight
        # the host's QoS tier (qos/admission.py), when enabled: this queue
        # is its LAST-RESORT inner ring, so its sheds are tallied there too
        # and the exported accounting covers every rejection path
        self.qos = qos
        self._q: Deque[Admitted] = deque()
        self._timer = None
        self._deadline_us: Optional[int] = None

    # ------------------------------------------------------------- client --
    def now_us(self) -> int:
        return int(self.scheduler.now_s() * 1e6)

    def submit(self, txn) -> AsyncResult:
        """Admit (or shed) one client transaction; returns its result.

        Shedding settles the result immediately with `Rejected` — the txn
        was never coordinated, so the client may retry after backoff."""
        result: AsyncResult = AsyncResult()
        if not self.admission.admit(len(self._q)):
            self.stats.record_shed()
            if self.trace.enabled:
                self.trace.event("pipeline_shed", depth=len(self._q))
            if self.flight is not None:
                self.flight.record("pipeline_shed", None, (len(self._q),))
            if self.qos is not None:
                self.qos.note_inner_shed(len(self._q))
            result.try_failure(Rejected(
                f"ingest queue full ({self.config.max_queue}); retry later"))
            return result
        self._q.append(Admitted(txn, result, self.now_us()))
        self.stats.record_admit(len(self._q))
        if self.flight is not None:
            self.flight.record("pipeline_admit", None, (len(self._q),))
        if len(self._q) >= self.config.max_batch:
            self._close(by_deadline=False)
        else:
            self._arm()
        return result

    # -------------------------------------------------------------- close --
    def effective_wait_us(self, depth: int) -> int:
        """Deadline for the batch at the current depth: the full window when
        the queue is shallow, shrinking linearly to max_wait_us/8 as depth
        approaches max_batch (arrival pressure => close sooner)."""
        cfg = self.config
        if not cfg.adaptive or cfg.max_batch <= 1:
            return cfg.max_wait_us
        frac = 1.0 - (depth - 1) / cfg.max_batch
        return max(cfg.max_wait_us // 8, int(cfg.max_wait_us * frac))

    def _arm(self) -> None:
        """(Re)arm the deadline timer at the current depth's effective wait,
        anchored to the OLDEST admitted txn — adaptivity can only pull the
        deadline earlier, never push an already-waiting txn later."""
        if not self._q:
            return
        oldest = self._q[0].admitted_us
        deadline = oldest + self.effective_wait_us(len(self._q))
        if self._timer is not None:
            if self._deadline_us is not None and deadline >= self._deadline_us:
                return  # existing timer already fires at/before this
            self._timer.cancel()
        self._deadline_us = deadline
        delay_s = max(0.0, (deadline - self.now_us()) / 1e6)
        self._timer = self.scheduler.once(delay_s, self._on_deadline)

    def _on_deadline(self) -> None:
        self._timer = None
        self._deadline_us = None
        if self._q:
            self._close(by_deadline=True)

    def _close(self, by_deadline: bool) -> None:
        """Pop up to max_batch items and dispatch them; re-arm for any
        remainder (repeatedly, so a deep backlog drains as full batches)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            self._deadline_us = None
        while self._q:
            n = min(len(self._q), self.config.max_batch)
            if n < self.config.max_batch and not by_deadline:
                break  # partial batch: wait for its deadline
            batch = [self._q.popleft() for _ in range(n)]
            now = self.now_us()
            waited = sum(now - a.admitted_us for a in batch)
            self.stats.record_batch(n, by_deadline, waited)
            if self.trace.enabled:
                self.trace.event("pipeline_batch", size=n,
                                 depth=len(self._q),
                                 by_deadline=by_deadline,
                                 waited_us=waited)
            if self.flight is not None:
                self.flight.record("pipeline_batch", None,
                                   (n, by_deadline))
            self.dispatch(batch)
            by_deadline = False  # only the first pop is deadline-credited
        # the admission-queue depth gauge tracks drains as well as admits
        self.stats._g_depth.value = len(self._q)
        if self._q:
            self._arm()

    @property
    def depth(self) -> int:
        return len(self._q)
