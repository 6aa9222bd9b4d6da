"""Kernel-level profiler: fenced wall timers, shape ledger, trace spans.

A copy of ``accord_tpu/obs/profiler.py``, less its flush-window waterfall
(the laps cover its encode, device and decode stages), plus the port's
span hook.  What it gives:

  * per-kernel wall time — every device-store precompute (deps, recovery,
    range-stab, wavefront, sharded) is split into encode / device / decode
    laps, each ended by a host pull or an injected fence so the timer
    measures the kernel, not the dispatch;
  * shape buckets — a ledger keyed by the encoded-shape buckets of
    impl/device_store._note_compile_shape (in the JAX package each first
    sighting is one XLA compile; in the port, which compiles each kernel
    once, it counts shapes), counted ALWAYS (a set lookup), independent of
    sampling;
  * trace spans — `span(name)` opens a range of the factory that
    `set_tracer` installed, so the store's phases (``accord.flush``,
    ``accord.deps.*``, ``accord.waves.*``, ``accord.op.*``) land on the
    timeline of whatever records those ranges (``torch.profiler``'s trace
    under ``torch._C._profiler._RecordFunctionFast`` or
    ``torch.autograd.profiler.record_function``, Nsight under
    ``torch.cuda.nvtx.range``).  With no tracer installed `span` hands back
    one shared null context: no clock read, no allocation, no registry.

OFF BY DEFAULT on the hot path: `ACCORD_PROFILE=N` samples 1-in-N flush
windows (N=1 profiles every window; unset/0 disables timing entirely —
only the retrace ledger stays on).  When a window is not sampled, `begin`
returns None and every `lap` is a single early-returning call.

No torch or numpy imports here: whoever turns tracing on passes the
factory in.  Fencing is the CALLER's job — device layers end each lap
with a host copy (``.cpu()``) or pass an explicit fence callable to
`lap`; this module only reads the clock.

`ACCORD_PROFILE_SCALE` (float, default 1) scales measured durations — a
test hook letting the bench's `--guard` regression gate be exercised with
a synthetic slowdown (the JAX package's tests/test_bench_guard.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, ContextManager, Dict, List, Optional

# raw-sample cap per kernel: exact p50/p99 without unbounded growth (the
# registry histograms keep the full log2-bucketed stream regardless)
_MAX_SAMPLES = 512

# the context every span site enters while no tracer is installed; entering
# a nullcontext does nothing, so one instance serves every site and thread
_NULL_SPAN = contextlib.nullcontext()
# name -> context manager, or None: process-wide, as the profilers that
# record the ranges are
_tracer: Optional[Callable[[str], ContextManager]] = None


def set_tracer(factory: Optional[Callable[[str], ContextManager]]) -> None:
    """Install `factory` (name -> context manager) as the range every
    `span` opens, or remove it with None."""
    global _tracer
    _tracer = factory


def span(name: str) -> ContextManager:
    """A range called `name` of the installed tracer, or the shared null
    context when none is installed.  Sites put no span inside a per-key or
    per-dep loop."""
    factory = _tracer
    return _NULL_SPAN if factory is None else factory(name)


class Profiler:
    """Per-store (or per-bench) profiler writing into a metrics registry.

    Registry metrics:
      accord_profile_kernel_us{kernel=...}   histogram — per-lap wall time
      accord_profile_retraces_total{kernel=...}  counter — shape-bucket
                                                 first-sightings (compiles)
    """

    __slots__ = ("registry", "sample_n", "enabled", "_clock", "_scale",
                 "_tick", "_window_active", "_samples", "_shapes")

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
    def window_begin(self) -> bool:
        """Called at flush start: decides whether this window is sampled.
        Returns whether sampling is on."""
        if not self.enabled:
            return False
        self._tick += 1
        self._window_active = self._tick % self.sample_n == 0
        return self._window_active

    def window_end(self) -> None:
        """End the window: laps are off until the next sampled one."""
        self._window_active = False

    def begin(self) -> Optional[float]:
        """Start a lap; None when this window is not sampled (making every
        subsequent `lap` a no-op)."""
        return self._clock() if self._window_active else None

    def lap(self, t: Optional[float], kernel: str,
            fence=None) -> Optional[float]:
        """End a lap started at `t`: record wall time for `kernel`.
        Returns the new lap start.
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
        return now

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
