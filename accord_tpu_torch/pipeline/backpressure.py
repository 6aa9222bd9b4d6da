"""Backpressure and admission control for the ingest pipeline.

The continuous-batching ingest layer (pipeline/ingest.py) must never let an
unbounded client backlog grow inside the coordinator process: a bounded
admission queue sheds load the moment depth exceeds the configured bound,
replying with a typed `Rejected` failure the client can distinguish from a
protocol failure (retry-after semantics, like an HTTP 503, rather than a
Timeout that might mean the txn committed).  The same module carries the
pipeline's per-stage counters — queue depth, batch size, queue-wait and
service latency — surfaced through `utils.tracing.Trace` events and a
`snapshot()` dict for harness assertions and the bench.
"""

from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.coordinate.errors import CoordinationFailed
from accord_tpu_torch.obs.views import MetricView, bind_metric_views


class Rejected(CoordinationFailed):
    """Load-shed reply: the admission queue was full, the transaction was
    NEVER submitted to the protocol (safe to retry after backoff — unlike a
    Timeout, no partial coordination state exists anywhere)."""


class AdmissionController:
    """Bounded-queue admission decision (the shed policy, split from the
    queue mechanics so hosts can tune or replace it)."""

    def __init__(self, max_queue: int = 256):
        self.max_queue = max_queue

    def admit(self, depth: int) -> bool:
        return depth < self.max_queue


class PipelineStats:
    """Per-stage counters for the ingest pipeline.  Mutated only from the
    owning node's loop thread (the pipeline is single-threaded by
    construction, like the command stores).

    Registry-backed (obs/): the attribute names are read-through views over
    the node's metrics registry, so existing harness reads (`stats.shed`,
    `stats.batches`) and the snapshot() dict keep working while the same
    numbers flow to the Prometheus endpoint and bench/burn snapshots."""

    submitted = MetricView("accord_pipeline_submitted_total")
    admitted = MetricView("accord_pipeline_admitted_total")
    shed = MetricView("accord_pipeline_shed_total")
    batches = MetricView("accord_pipeline_batches_total")
    dispatched = MetricView("accord_pipeline_dispatched_total")
    completed = MetricView("accord_pipeline_completed_total")
    failed = MetricView("accord_pipeline_failed_total")
    deadline_closes = MetricView("accord_pipeline_deadline_closes_total")
    size_closes = MetricView("accord_pipeline_size_closes_total")
    depth_max = MetricView("accord_pipeline_depth_max", kind="gauge")
    batch_size_max = MetricView("accord_pipeline_batch_size_max",
                                kind="gauge")

    def __init__(self, registry=None, **labels):
        if registry is None:  # standalone (tests, bare queues)
            from accord_tpu_torch.obs.registry import Registry
            registry = Registry()
        bind_metric_views(self, registry, **labels)
        self._g_depth = registry.gauge("accord_pipeline_queue_depth",
                                      **labels)
        self._h_batch_size = registry.histogram(
            "accord_pipeline_batch_size", **labels)
        # per-txn queue wait (admission -> dispatch): the pipeline's slice
        # of the open-loop SLO lanes' "admission" phase — surfaced as
        # pipeline.queue_wait_us in obs/report.summarize (burn --metrics,
        # bench rows)
        self._h_queue_wait = registry.histogram(
            "accord_pipeline_queue_wait_us", **labels)
        self._queue_wait_us_sum = 0   # admission -> dispatch
        self._service_us_sum = 0      # dispatch -> settle
        self._latency_n = 0

    # ------------------------------------------------------------- record --
    def record_admit(self, depth: int) -> None:
        self.submitted += 1
        self.admitted += 1
        self.depth_max = max(self.depth_max, depth)
        self._g_depth.value = depth

    def record_shed(self) -> None:
        self.submitted += 1
        self.shed += 1

    def record_batch(self, size: int, by_deadline: bool,
                     queue_wait_us_total: int) -> None:
        self.batches += 1
        self.dispatched += size
        self.batch_size_max = max(self.batch_size_max, size)
        self._h_batch_size.observe(size)
        self._h_queue_wait.observe(queue_wait_us_total // max(1, size))
        if by_deadline:
            self.deadline_closes += 1
        else:
            self.size_closes += 1
        self._queue_wait_us_sum += queue_wait_us_total

    def record_done(self, ok: bool, service_us: int) -> None:
        if ok:
            self.completed += 1
        else:
            self.failed += 1
        self._service_us_sum += max(0, service_us)
        self._latency_n += 1

    # ------------------------------------------------------------ inspect --
    @property
    def batch_size_mean(self) -> float:
        return self.dispatched / self.batches if self.batches else 0.0

    @property
    def queue_wait_us_mean(self) -> float:
        return (self._queue_wait_us_sum / self.dispatched
                if self.dispatched else 0.0)

    @property
    def service_us_mean(self) -> float:
        return (self._service_us_sum / self._latency_n
                if self._latency_n else 0.0)

    def snapshot(self) -> Dict[str, float]:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "shed": self.shed,
            "batches": self.batches,
            "dispatched": self.dispatched,
            "completed": self.completed,
            "failed": self.failed,
            "deadline_closes": self.deadline_closes,
            "size_closes": self.size_closes,
            "depth_max": self.depth_max,
            "batch_size_max": self.batch_size_max,
            "batch_size_mean": round(self.batch_size_mean, 2),
            "queue_wait_us_mean": round(self.queue_wait_us_mean, 1),
            "service_us_mean": round(self.service_us_mean, 1),
        }

    def __repr__(self):
        return (f"PipelineStats(batches={self.batches} "
                f"dispatched={self.dispatched} shed={self.shed} "
                f"batch_max={self.batch_size_max})")


class SendBackoff:
    """Exponential backoff schedule for transport send retries (host/tcp.py
    peer writers): attempt -> seconds to wait before retrying, capped."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 1.0,
                 max_attempts: int = 4):
        self.base_s = base_s
        self.cap_s = cap_s
        self.max_attempts = max_attempts

    def delay_s(self, attempt: int) -> Optional[float]:
        """Delay before retry `attempt` (1-based), or None when the frame
        should be dropped instead (RPC timeouts + the progress log heal,
        exactly like a lossy link)."""
        if attempt >= self.max_attempts:
            return None
        return min(self.cap_s, self.base_s * (2 ** (attempt - 1)))
