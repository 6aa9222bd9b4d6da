"""Device timing on the card with CUDA events."""

from __future__ import annotations

import statistics

import torch


def median_ms(fn, reps: int, per_batch: int = 1) -> float:
    """Median device ms of `fn` over `reps` batches of `per_batch` calls, each
    batch between two CUDA events on the current stream.  A sleep kernel
    queued first keeps the card busy while the host enqueues the batch, so
    host overhead between calls does not show up as device time."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)
