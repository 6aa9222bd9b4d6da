"""The program's own spans and counters over one traced run of a cell.

    python3 -m accord_bench.spans --workload <cell> --seed <n>
                                  --seconds <s> [run.py's other options]

runs ``run.py``'s traced run (``--trace 1`` is implied) with the
program's span hook (``accord_tpu_torch.obs.profiler.set_tracer``)
installed while the profiler records, prints ``run.py``'s line as it
is, and then one more JSON line:

- ``spans``: each ``accord.*`` range of the measured window, by name:
  ``count``, ``total_s`` and ``self_s`` (its duration less what its
  child ranges cover);
- ``idle_by_span``: the card's idle seconds in the window, each idle
  instant under the innermost ``accord.*`` range open then and the rest
  under ``outside``, so that the parts sum to ``idle_s``;
  ``harness_by_span`` splits the same way the idle time outside every
  harness span (``trace.HOST_SPANS``), which the accepted breakdown
  calls ``harness``;
- ``counters``: the store's counters' deltas over the window (the bytes
  of the flushes' copies each way, the entries the deps encoder wrote,
  the deps served from the card's probes, the wave plans and the sum of
  their depths);
- ``metrics``: the six layers of ``PER_TXN``, each the self seconds of
  its spans in ms a transaction applied.

``run.py`` installs no tracer of its own, so its traced run measures the
program with every span site at its shared null context.  This module
reaches the run through the functions ``run.main`` calls:
``trace.span_factory`` (given ``record_function`` once the warm-up is
over, just before the profiler starts), ``run._entries`` (given the
store as the measured window opens and once the profiler has stopped),
``trace.export_events`` and ``trace.reduce_trace``.  On a program
without the hook or the counters it prints what it finds and raises
nothing.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
from bisect import bisect_right
from typing import Dict, List, Tuple

from accord_bench import run, trace

PREFIX = "accord."
# each layer's spans, read from their self seconds (ms a txn applied)
PER_TXN = {
    "encode_ms_per_txn": ("accord.deps.snapshot", "accord.deps.encode",
                          "accord.waves.encode"),
    "copy_host_ms_per_txn": ("accord.deps.upload", "accord.deps.download",
                             "accord.waves.upload", "accord.waves.download"),
    "decode_ms_per_txn": ("accord.deps.decode", "accord.deps.install"),
    "op_deps_ms_per_txn": ("accord.op.deps",),
    "op_index_ms_per_txn": ("accord.op.index",),
    "op_execute_ms_per_txn": ("accord.op.waiting_on", "accord.op.execute"),
}
# the store's integer counters read, by attribute
COUNTERS = ("device_encoded_entries", "device_served_deps", "device_hits",
            "device_flush_windows", "device_wave_batches")


def tracer_factory():
    """The cheapest range ``torch.profiler`` records: ``_RecordFunctionFast``
    where this torch has it, else ``record_function``."""
    try:
        from torch._C._profiler import _RecordFunctionFast
        return _RecordFunctionFast
    except ImportError:
        from torch.autograd.profiler import record_function
        return record_function


def _ranges(events: List[dict], t0: float, t1: float):
    """The host ``accord.*`` ranges, the device's ops and the harness's
    host spans that overlap the window, clipped to it: (sorted (start,
    end, name), [(start, end)], [(start, end)])."""
    ranges, device, harness = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts = ev.get("cat", ""), float(ev["ts"])
        end = ts + float(ev.get("dur", 0))
        if end <= t0 or ts >= t1:
            continue
        if cat in trace.DEVICE_CATS:
            device.append((max(ts, t0), min(end, t1)))
        elif cat.startswith("gpu_"):
            continue
        elif ev.get("name", "").startswith(PREFIX):
            ranges.append((max(ts, t0), min(end, t1), ev["name"]))
        elif ev.get("name", "").startswith(trace.HOST_SPANS):
            harness.append((max(ts, t0), min(end, t1)))
    ranges.sort(key=lambda r: (r[0], -r[1]))
    return ranges, device, harness


def _flatten(ranges):
    """Nested ranges of one thread, sorted by start and longest first ->
    ({name: [count, total µs, µs its children cover]}, the disjoint
    (start, end, name) pieces of time under each innermost range)."""
    stats: Dict[str, List[float]] = {}
    pieces: List[Tuple[float, float, str]] = []
    stack: List[list] = []  # [end, name, cursor]: cursor, the time placed

    def close():
        end, name, cursor = stack.pop()
        if end > cursor:
            pieces.append((cursor, end, name))
        if stack:
            stack[-1][2] = end

    for start, end, name in ranges:
        while stack and stack[-1][0] <= start:
            close()
        if stack:
            parent = stack[-1]
            end = min(end, parent[0])
            if start > parent[2]:
                pieces.append((parent[2], start, parent[1]))
            stats[parent[1]][2] += end - start
        s = stats.setdefault(name, [0, 0.0, 0.0])
        s[0] += 1
        s[1] += end - start
        stack.append([end, name, start])
    while stack:
        close()
    return stats, pieces


def _uncovered(pieces, intervals, t0: float, t1: float) -> Dict[str, float]:
    """µs of each name's pieces, and of the rest of [t0, t1) (``outside``),
    that none of `intervals` covers."""
    merged = trace._merge(intervals)
    starts = [s for s, _ in merged]

    def within(s: float, e: float) -> float:
        i = max(0, bisect_right(starts, s) - 1)
        covered = 0.0
        while i < len(merged) and merged[i][0] < e:
            covered += max(0.0, min(merged[i][1], e) - max(merged[i][0], s))
            i += 1
        return covered
    out: Dict[str, float] = {}
    for s, e, name in pieces:
        out[name] = out.get(name, 0.0) + (e - s) - within(s, e)
    total = (t1 - t0) - sum(e - s for s, e in merged)
    out["outside"] = total - sum(out.values())
    return out


def reduce_spans(events: List[dict], window: Tuple[float, float]) -> dict:
    """Chrome-trace events (µs) and the measured window's bounds -> each
    ``accord.*`` name's count, total and self seconds, and the card's
    idle seconds under each innermost span (``outside`` for the rest)."""
    t0, t1 = window
    ranges, device, harness = _ranges(events, t0, t1)
    stats, pieces = _flatten(ranges)
    idle = _uncovered(pieces, device, t0, t1)
    return {
        "spans": {n: {"count": int(c), "total_s": tot / 1e6,
                      "self_s": (tot - child) / 1e6}
                  for n, (c, tot, child) in sorted(stats.items())},
        "idle_by_span": _seconds(idle),
        "idle_s": sum(idle.values()) / 1e6,
        "harness_by_span": _seconds({
            n: v for n, v in
            _uncovered(pieces, device + harness, t0, t1).items() if v}),
        "window_s": (t1 - t0) / 1e6,
    }


def _seconds(us: Dict[str, float]) -> Dict[str, float]:
    return {n: v / 1e6 for n, v in sorted(us.items(), key=lambda kv: -kv[1])}


def per_txn(spans: dict, txns: int) -> dict:
    """The six layers' ms a txn applied, from `spans`' self seconds; a
    layer none of whose spans ran is left out."""
    out = {}
    for metric, names in PER_TXN.items():
        found = [spans[n]["self_s"] for n in names if n in spans]
        if found and txns:
            out[metric] = sum(found) * 1e3 / txns
    return out


def store_counters(store) -> dict:
    """The store's counters this module reads, those it has."""
    out = {n: int(getattr(store, n)) for n in COUNTERS if hasattr(store, n)}
    copies = getattr(store, "device_copy_bytes", None)
    if copies is not None:
        out.update({f"copy_bytes_{d}": int(v) for d, v in copies.items()})
    depths = getattr(store, "device_wave_depths", None)
    if depths is not None:
        out["wave_plans"], out["wave_depth_sum"] = depths.count, depths.sum
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        from accord_tpu_torch.obs.profiler import set_tracer
    except ImportError:
        set_tracer = None
    seen = {"counters": []}
    factory, export, reduce_, entries = (
        trace.span_factory, trace.export_events, trace.reduce_trace,
        run._entries)

    def span_factory(record_function):
        if record_function is not None and set_tracer is not None:
            set_tracer(tracer_factory())
        return factory(record_function)

    def export_events(prof):
        if set_tracer is not None:
            set_tracer(None)
        return export(prof)

    def reduce_trace(events, window):
        seen["spans"] = reduce_spans(events, window)
        return reduce_(events, window)

    def count_entries(store):
        seen["counters"].append(store_counters(store))
        return entries(store)

    trace.span_factory, trace.export_events = span_factory, export_events
    trace.reduce_trace, run._entries = reduce_trace, count_entries
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main([*argv, "--trace", "1"])
    finally:
        trace.span_factory, trace.export_events = factory, export
        trace.reduce_trace, run._entries = reduce_, entries
        if set_tracer is not None:
            set_tracer(None)
    printed = out.getvalue()
    sys.stdout.write(printed)
    if rc != 0 or "spans" not in seen:
        return rc
    line = json.loads(printed.strip().splitlines()[-1])
    found = seen["spans"]
    first, last = seen["counters"]  # as the window opened, as it closed
    found["counters"] = {k: v - first[k] for k, v in last.items()}
    found["metrics"] = per_txn(found["spans"], line["info"]["txns"])
    found["txns"] = line["info"]["txns"]
    print(json.dumps(found), flush=True)
    return 0


if __name__ == "__main__":
    if any(os.environ.get(k) != v for k, v in run.STEADY_ENV.items()):
        os.execve(sys.executable,
                  [sys.executable, "-m", "accord_bench.spans", *sys.argv[1:]],
                  {**os.environ, **run.STEADY_ENV})
    sys.exit(main())
