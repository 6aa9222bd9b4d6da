"""Kernel-level profiler: fenced wall timers, shape ledger, flush waterfall.

A copy of ``accord_tpu/obs/profiler.py``.  Three blind spots it closes:

  * per-kernel wall time — every device-store precompute (deps, recovery,
    range-stab, wavefront, sharded) is split into encode / device / decode
    laps, each ended by a host pull or an injected fence so the timer
    measures the kernel, not the dispatch;
  * shape buckets — a ledger keyed by the encoded-shape buckets of
    impl/device_store._note_compile_shape (in the JAX package each first
    sighting is one XLA compile; in the port, which compiles each kernel
    once, it counts shapes), counted ALWAYS (a set lookup), independent of
    sampling;
  * the flush-window waterfall — queue-wait -> encode -> device -> decode
    per drained window, so the latency tax of the batching tier is
    decomposable instead of one opaque number.

OFF BY DEFAULT on the hot path: `ACCORD_PROFILE=N` samples 1-in-N flush
windows (N=1 profiles every window; unset/0 disables timing entirely —
only the retrace ledger stays on).  When a window is not sampled, `begin`
returns None and every `lap` is a single early-returning call.

No torch or numpy imports here.  Fencing is the CALLER's job — device
layers end each lap with a host copy (``.cpu()``) or pass an explicit fence
callable to `lap`; this module only reads the clock.

`ACCORD_PROFILE_SCALE` (float, default 1) scales measured durations — a
test hook letting the bench's `--guard` regression gate be exercised with
a synthetic slowdown (the JAX package's tests/test_bench_guard.py).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

# raw-sample cap per kernel: exact p50/p99 without unbounded growth (the
# registry histograms keep the full log2-bucketed stream regardless)
_MAX_SAMPLES = 512


class Profiler:
    """Per-store (or per-bench) profiler writing into a metrics registry.

    Registry metrics:
      accord_profile_kernel_us{kernel=...}   histogram — per-lap wall time
      accord_profile_window_us{stage=...}    histogram — waterfall stages
      accord_profile_retraces_total{kernel=...}  counter — shape-bucket
                                                 first-sightings (compiles)
      accord_profile_windows_sampled_total   counter — sampled windows
    """

    __slots__ = ("registry", "sample_n", "enabled", "_clock", "_scale",
                 "_tick", "_window_active", "_stage_acc", "_samples",
                 "_shapes")

    def __init__(self, registry, sample_n: int = 0, clock=None):
        self.registry = registry
        self.sample_n = sample_n
        self.enabled = sample_n > 0
        self._clock = clock if clock is not None else time.perf_counter
        try:
            self._scale = float(os.environ.get("ACCORD_PROFILE_SCALE", "1"))
        except ValueError:
            self._scale = 1.0
        self._tick = 0
        self._window_active = False
        self._stage_acc: Dict[str, float] = {}
        self._samples: Dict[str, List[float]] = {}
        self._shapes: Dict[str, set] = {}

    # ------------------------------------------------------ retrace ledger --
    def note_retrace(self, kernel: str, shapes) -> None:
        """First sighting of an encoded-shape bucket for `kernel`.  Always
        on — one set lookup per flush window."""
        seen = self._shapes.get(kernel)
        if seen is None:
            seen = self._shapes[kernel] = set()
        if shapes not in seen:
            seen.add(shapes)
            self.registry.counter("accord_profile_retraces_total",
                                  kernel=kernel).inc()

    # ------------------------------------------------------- window timing --
    def window_begin(self, opened_at: Optional[float]) -> bool:
        """Called at flush start with the wall time of the window's first
        _submit (or None).  Decides sampling for this window and records
        the queue-wait waterfall stage.  Returns whether sampling is on."""
        if not self.enabled:
            return False
        self._tick += 1
        if self._tick % self.sample_n:
            self._window_active = False
            return False
        self._window_active = True
        self._stage_acc = {}
        self.registry.counter("accord_profile_windows_sampled_total").inc()
        if opened_at is not None:
            self._observe_stage("queue_wait",
                                self._clock() - opened_at)
        return True

    def window_end(self) -> None:
        """Flush the sampled window's accumulated waterfall stages."""
        if not self._window_active:
            return
        for stage, dur in self._stage_acc.items():
            self._observe_stage(stage, dur)
        self._stage_acc = {}
        self._window_active = False

    def begin(self) -> Optional[float]:
        """Start a lap; None when this window is not sampled (making every
        subsequent `lap` a no-op)."""
        return self._clock() if self._window_active else None

    def lap(self, t: Optional[float], kernel: str,
            stage: Optional[str] = None, fence=None) -> Optional[float]:
        """End a lap started at `t`: record wall time for `kernel` (and
        accumulate into waterfall `stage`).  Returns the new lap start.
        `fence` (e.g. torch.cuda.synchronize) runs INSIDE the lap — the
        caller injects synchronization.  Callers whose lap already ends in
        a host copy pass no fence: the copy IS the fence."""
        if t is None:
            return None
        if fence is not None:
            fence()
        now = self._clock()
        dur = (now - t) * self._scale
        us = dur * 1e6
        self.registry.histogram("accord_profile_kernel_us",
                                kernel=kernel).observe(us)
        samples = self._samples.get(kernel)
        if samples is None:
            samples = self._samples[kernel] = []
        if len(samples) < _MAX_SAMPLES:
            samples.append(us)
        if stage is not None:
            self._stage_acc[stage] = self._stage_acc.get(stage, 0.0) + dur
        return now

    def _observe_stage(self, stage: str, dur_s: float) -> None:
        self.registry.histogram("accord_profile_window_us", stage=stage) \
            .observe(dur_s * self._scale * 1e6)

    # ------------------------------------------------------------- summary --
    def summary(self) -> dict:
        """The per-kernel p50/p99 + retrace summary the bench records into
        its emitted row and BENCH_HISTORY.json (`--guard` diffs these).
        Quantiles come from the raw-sample cap, not the log2 buckets, so a
        15% regression threshold is meaningful."""
        kernels = {}
        for kernel, samples in self._samples.items():
            if not samples:
                continue
            s = sorted(samples)
            kernels[kernel] = {
                "count": len(s),
                "p50": round(s[len(s) // 2], 1),
                "p99": round(s[min(len(s) - 1, int(len(s) * 0.99))], 1),
            }
        return {
            "kernels": kernels,
            "retraces": {k: len(v) for k, v in self._shapes.items() if v},
        }


def profiler_from_env(registry, env: str = "ACCORD_PROFILE") -> Profiler:
    """ACCORD_PROFILE=N -> sample 1-in-N flush windows; unset/0/garbage ->
    timing disabled (retrace ledger only)."""
    raw = os.environ.get(env, "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        n = 0
    if n > 0:
        return Profiler(registry, sample_n=n)
    return Profiler(registry, sample_n=0)
