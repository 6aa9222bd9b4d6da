"""The traced run: spans around the calls into the program, and the
reduction of ``torch.profiler``'s trace to what the per-layer readers read.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark's own code around the program's calls: ``serve.<op>`` around
each op's transition, ``flush.deps``, ``flush.ranges`` and ``flush.waves``
around the store's deps precompute, range stab and wave plan, and, inside
the flush, ``bench.deps`` (succ_w and the deps tile), ``bench.graph`` (the
in-window graph), ``bench.waves`` (K2) and ``bench.ranges`` (the range
index's [Q, N] stab, plain torch).  The device steps'
launches are attributed to the ``bench.*`` span open when the host
launched them (by the CUDA correlation id), and each launch's shapes are
recorded for its least bytes (``roofline.py``).
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

from accord_bench import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("serve.", "flush.")


class StepRecorder:
    """Wraps the program's device steps as the store calls them: each call
    runs inside a ``bench.*`` span and adds its least bytes."""

    def __init__(self, record_function):
        self.rf = record_function
        self.least_bytes: Dict[str, int] = defaultdict(int)

    def wrap(self, module) -> None:
        deps, graph, waves, stab = (module.batched_active_deps_cuda,
                                    module.in_batch_graph,
                                    module.execution_waves_cuda,
                                    module.range_stab_mask)

        def deps_step(*args):
            e, (b, k) = args[0].shape[-1], args[7].shape
            self.least_bytes["bench.deps"] += roofline.deps_bytes(b, k, e)
            with self.rf("bench.deps"):
                return deps(*args)

        def graph_step(rank, wmask, kind, touches):
            b, k = touches.shape
            self.least_bytes["bench.graph"] += roofline.graph_bytes(b, k)
            with self.rf("bench.graph"):
                return graph(rank, wmask, kind, touches)

        def waves_step(dep_bb, txn_rank=None, stats=None):
            self.least_bytes["bench.waves"] += roofline.waves_bytes(
                dep_bb.shape[0])
            with self.rf("bench.waves"):
                return waves(dep_bb, txn_rank, stats)

        def ranges_step(starts, ends, q_starts, q_ends):
            self.least_bytes["bench.ranges"] += roofline.range_bytes(
                q_starts.shape[0], starts.shape[0])
            with self.rf("bench.ranges"):
                return stab(starts, ends, q_starts, q_ends)

        module.batched_active_deps_cuda = deps_step
        module.in_batch_graph = graph_step
        module.execution_waves_cuda = waves_step
        module.range_stab_mask = ranges_step


def span_factory(record_function):
    """-> span(name): a record_function range, or nothing when untraced."""
    if record_function is None:
        return lambda name: nullcontext()
    return record_function


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _lookup(spans):
    """spans: sorted, non-overlapping (start, end, name) -> at(t), the name
    of the span that holds t, or None."""
    starts = [s for s, _, _ in spans]

    def at(t: float) -> Optional[str]:
        i = bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None
    return at


def _split(spans, g0: float, g1: float):
    """(name, µs) of [g0, g1) under each of the sorted, non-overlapping
    host spans, and the rest under "harness"."""
    out = []
    i = max(0, bisect_right(spans, (g0,)) - 1)
    covered = 0.0
    while i < len(spans) and spans[i][0] < g1:
        s, e, name = spans[i]
        part = min(e, g1) - max(s, g0)
        if part > 0:
            out.append((name, part))
            covered += part
        i += 1
    if g1 - g0 > covered:
        out.append(("harness", g1 - g0 - covered))
    return out


def reduce_trace(events: List[dict], window: Tuple[float, float]) -> dict:
    """Chrome-trace events (µs) and the measured window's bounds -> the
    device's busy seconds in the window, its kernel seconds, the kernel
    seconds of each ``bench.*`` step, the ten device ops that took most
    time, and the ten host spans under which the device idled longest."""
    t0, t1 = window
    launches: Dict[int, float] = {}
    steps, host, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), \
            float(ev.get("dur", 0))
        args = ev.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation":
            name = ev["name"]
            if name.startswith("bench."):
                steps.append((ts, ts + dur, name))
            elif name.startswith(HOST_SPANS):
                host.append((ts, ts + dur, name))
        elif cat in DEVICE_CATS and t0 < ts + dur and ts < t1:
            device.append((ts, ts + dur, ev["name"], cat,
                           args.get("correlation")))
    step_at = _lookup(sorted(steps))
    host.sort()
    by_step: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    for s, e, name, cat, corr in device:
        by_op[name] += e - s
        if cat == "kernel":
            kernel_us += e - s
            at = launches.get(corr)
            step = step_at(at) if at is not None else None
            if step is not None:
                by_step[step] += e - s
    busy = _merge([(max(s, t0), min(e, t1)) for s, e, *_ in device])
    busy_us = sum(e - s for s, e in busy)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        for name, us in _split(host, g0, g1):
            gaps[name] += us
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "step_s": {k: v / 1e6 for k, v in by_step.items()},
        "device_ops": [[n, v / 1e6] for n, v in top],
        "idle_gaps": [[n, v / 1e6] for n, v in top_gaps],
    }


def export_events(prof) -> List[dict]:
    """The profiler's trace as chrome-trace events, through a file in the
    temporary directory that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def window_bounds(events: List[dict], name: str) -> Tuple[float, float]:
    """The start and end (µs) of the span called `name`."""
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == name \
                and ev.get("cat") == "user_annotation":
            return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    raise RuntimeError(f"the trace holds no span {name!r}")
