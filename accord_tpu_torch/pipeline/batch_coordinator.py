"""Batch coordinator: run one micro-batch's coordinations as one window.

Takes the admission queue's closed batches (pipeline/ingest.py) and starts
every transaction's coordination inside ONE sink coalescing window, so the
whole batch's first-round fan-out leaves the process as one wire envelope
per replica (messages/multi.MultiPreAccept) instead of batch_size separate
frames — and the self-addressed slice of that fan-out arrives at the local
command stores as one dispatch, which the batched device tier resolves as
one fused probe window (impl/device_store.py hold_flush/release_flush).

The coordinations themselves are completely unchanged — each transaction
still runs coordinate/transaction.py's fast/slow-path state machine with
its own tracker, callbacks and timeouts; only the transport framing and the
device dispatch are amortized across the batch.  Coordinations are started
in admission order, so conflicting transactions admitted to the same batch
reach every replica in that order and witness each other accordingly
(batching coalesces delivery; it never reorders within a batch).
"""

from __future__ import annotations

from typing import List, Optional

from accord_tpu_torch.pipeline.backpressure import PipelineStats
from accord_tpu_torch.pipeline.ingest import Admitted


class BatchCoordinator:
    """Starts a batch of coordinations under one sink coalescing window."""

    def __init__(self, node, stats: Optional[PipelineStats] = None):
        self.node = node
        self.stats = stats if stats is not None else PipelineStats()

    def now_us(self) -> int:
        return int(self.node.scheduler.now_s() * 1e6)

    def coordinate_batch(self, items: List[Admitted]) -> None:
        sink = self.node.sink
        coalesce = hasattr(sink, "batch_begin")
        if coalesce:
            sink.batch_begin()
        try:
            for item in items:
                self._start_one(item)
        finally:
            if coalesce:
                # one MultiPreAccept per destination carries everything the
                # batch's coordinations sent during start (PreAccepts; plus
                # any Commits/Applies a same-tick reply burst produced when
                # the host loop holds a window open across dispatches)
                sink.batch_flush()

    def _start_one(self, item: Admitted) -> None:
        dispatched_us = self.now_us()

        def done(value, failure):
            self.stats.record_done(failure is None,
                                   self.now_us() - dispatched_us)
            if failure is not None:
                item.result.try_failure(failure)
            else:
                item.result.try_success(value)

        try:
            self.node.coordinate(item.txn).add_callback(done)
        except BaseException as e:  # noqa: BLE001 — one malformed txn must
            done(None, e)          # not poison the rest of the batch
