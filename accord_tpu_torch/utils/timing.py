"""Device timing on the card with CUDA events."""

from __future__ import annotations

import statistics

import torch


def median_ms(fn, reps: int, per_batch: int = 1) -> float:
    """Median device ms of `fn` over `reps` batches of `per_batch` calls
    (``event_times_ms``)."""
    return statistics.median(event_times_ms(fn, reps, per_batch))


def event_times_ms(fn, reps: int, per_batch: int = 1) -> list:
    """Device ms a call of `fn` for each of `reps` batches of `per_batch`
    calls, each batch between two CUDA events on the current stream.  A
    sleep kernel queued first keeps the card busy while the host enqueues
    the batch, so host overhead between calls does not show up as device
    time."""
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
    return times


def median_ms_cards(fn, devices, reps: int) -> float:
    """Median device ms of `fn`, whose work spans the cards `devices`.  In
    each of `reps` runs every card gets a sleep kernel and then an event
    on its current stream before the call and one after it; the run's time
    is the longest card's interval (a step that ends in an all-reduce ends
    on every card after the slowest card's work)."""
    times = []
    for _ in range(reps):
        starts, ends = [], []
        for dev in devices:
            with torch.cuda.device(dev):
                torch.cuda._sleep(5_000_000)
                starts.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
        fn()
        for dev in devices:
            with torch.cuda.device(dev):
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
        for dev in devices:
            torch.cuda.synchronize(dev)
        times.append(max(s.elapsed_time(e) for s, e in zip(starts, ends)))
    return statistics.median(times)
