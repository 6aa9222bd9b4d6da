"""Continuous micro-batching ingest pipeline (coordinator side).

The device tier amortizes kernel dispatch across a flush window; this
package amortizes the COORDINATOR's costs the same way, at admission:

  * `ingest.IngestQueue` — coalesces incoming client transactions into
    deadline-bounded micro-batches (`max_batch` / `max_wait_us`, adaptive
    to queue depth);
  * `batch_coordinator.BatchCoordinator` — starts each batch's
    coordinations under one sink coalescing window, so the batch's fan-out
    leaves as one `MultiPreAccept` wire envelope per replica and its
    self-addressed slice resolves as one fused device probe window;
  * `backpressure` — bounded admission with a typed `Rejected` shed reply
    and per-stage depth/latency/batch-size counters.

Hosts enable it with `ACCORD_PIPELINE=1` (host/tcp.py, host/maelstrom.py);
the deterministic burn drives it via `SimCluster(pipeline=True)` /
`python -m accord_tpu_torch.sim.burn --pipeline`.
"""

from __future__ import annotations

import os
from typing import Optional

from accord_tpu_torch.pipeline.backpressure import (PipelineStats, Rejected,
                                              SendBackoff)
from accord_tpu_torch.pipeline.batch_coordinator import BatchCoordinator
from accord_tpu_torch.pipeline.ingest import IngestQueue, PipelineConfig


def pipeline_enabled() -> bool:
    """The host-side gate: ACCORD_PIPELINE=1 (default off)."""
    return os.environ.get("ACCORD_PIPELINE", "") == "1"


class Pipeline:
    """Facade wiring IngestQueue -> BatchCoordinator for one node."""

    def __init__(self, node, scheduler=None,
                 config: Optional[PipelineConfig] = None, qos=None):
        self.node = node
        self.config = config if config is not None else PipelineConfig()
        # per-stage counters live in the node's metrics registry (obs/)
        registry = getattr(getattr(node, "obs", None), "registry", None)
        self.stats = PipelineStats(registry=registry)
        self.batcher = BatchCoordinator(node, self.stats)
        self.ingest = IngestQueue(
            scheduler if scheduler is not None else node.scheduler,
            self.batcher.coordinate_batch, self.config, self.stats,
            trace=node.trace,
            flight=getattr(getattr(node, "obs", None), "flight", None),
            qos=qos)

    def submit(self, txn):
        """Admit one client transaction; returns its AsyncResult (settled
        with `Rejected` immediately when the admission queue sheds it)."""
        return self.ingest.submit(txn)
