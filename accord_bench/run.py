"""One run of one benchmark cell.

    python3 -m accord_bench.run --workload <cell> --seed <n> --seconds <s>
                                --trace <0|1>

The cell (an entry of ``BENCHMARK.json`` ``workloads``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the per-layer metrics are read by
``metrics/<metric>.py``, each found by its name.  A run:

1. draws the cell's transactions from the seed (``generate.py``);
2. builds one replica's ``DeviceCommandStore`` on the card, builds every
   op's messages ahead, and warms the store with the mix's warm-up
   windows, which also builds and loads every kernel (set-up,
   ``setup_s``);
3. runs the lifecycle's flush windows back to back, each started when the
   last has drained (the measured window).  The window is a fixed amount
   of work sized to ``--seconds``: ``--seconds`` times the mix's
   ``windows_per_s`` flush windows, the rate the port sustained on the
   H100 when the mix was written.  The store's conflict index grows
   through a run (nothing prunes it), so a window of fixed length would
   give a faster program more windows at a larger index; a fixed number
   gives both sides of a comparison the same work.  A run that takes four
   times ``--seconds`` ends its window there;
4. holds every answer of every window against the plain reference
   (``check.py``), and prints each number compared beside its limit, on
   standard error and as the result's ``checks``;
5. prints one JSON line last: with ``--trace 0`` the cell's end-to-end
   metrics, with ``--trace 1`` its per-layer metrics, read from
   ``torch.profiler``'s trace of the window and the store's profiler laps.

It exits 2 without a result where no CUDA card is present or fewer than
the cell asks for, and 3 where ``jax``, ``jaxlib``, ``flax`` or
``accord_tpu`` were loaded.  ``--device cpu`` runs the same path on the
CPU for the tests: its line says ``"platform": "cpu"`` and carries no
device metric.  ``--warmup-windows`` and ``--max-windows`` set the
windows for the tests.
"""

from __future__ import annotations

import os
import sys
import time

# one process with few threads and a fixed string hash, so that two runs
# of one seed do the same work the same way: the run starts over in this
# environment before anything is timed
STEADY_ENV = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
if __name__ == "__main__" and any(os.environ.get(k) != v
                                  for k, v in STEADY_ENV.items()):
    os.execve(sys.executable,
              [sys.executable, "-m", "accord_bench.run", *sys.argv[1:]],
              {**os.environ, **STEADY_ENV})

_T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from accord_bench import check, trace  # noqa: E402
from accord_bench.driver import (LifecycleRunner, StoreNode,  # noqa: E402
                                 store_kit)
from accord_bench.generate import Traffic  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "accord_tpu")
# a window that runs this many times --seconds ends there
OVERRUN = 4
MISS_CAUSES = ("no_probe", "version", "key_cover")


def load_cell(name: str, root: Path = ROOT):
    """-> (cell, config, mix, end-to-end metrics, per-layer metrics) of the
    cell called `name` in ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = dict(cells[name], run_seconds=bench["run_seconds"])
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def here(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return cell, config, mix, here(bench["end_to_end"]), \
        here(bench["per_layer"])


def measured_windows(mix: dict, seconds: float) -> int:
    """The flush windows a measured window of `seconds` runs."""
    return max(1, round(seconds * mix["windows_per_s"]))


def read_metric(name: str, run) -> object:
    """The reader ``metrics/<name>.py``'s ``read(run)``: a number, or None
    where the run has nothing for it to read."""
    spec = importlib.util.spec_from_file_location(
        f"accord_bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> object:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def parse_args(argv):
    p = argparse.ArgumentParser(prog="accord_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--warmup-windows", type=int, default=None)
    p.add_argument("--max-windows", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell, config, mix, end_to_end, per_layer = load_cell(args.workload)
    import torch
    cuda = args.device == "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and cards < cell["chips"]:
        print(f"accord_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    from accord_tpu_torch.host.tcp import hold_off_full_collections
    from accord_tpu_torch import native
    from accord_tpu_torch.impl import device_store
    from accord_tpu_torch.obs.profiler import Profiler
    from accord_tpu_torch.obs.registry import Registry, parse_labels
    from accord_tpu_torch.ops import cuda_kernels

    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        # the kernels a store's flush launches: succ_w, the deps tile, K2
        cuda_kernels.build([cuda_kernels.SUCC_W, cuda_kernels.DEPS_TILE,
                            cuda_kernels.WAVEFRONT])
    traffic = Traffic(config, mix, args.seed)
    warm = traffic.warmup_windows if args.warmup_windows is None \
        else args.warmup_windows
    measure = measured_windows(mix, args.seconds) \
        if args.max_windows is None else args.max_windows
    traffic.ops(warm + measure - 1)
    kit = store_kit()
    node = StoreNode(kit)
    store = device_store.DeviceCommandStore(
        0, node, kit.Ranges.of(tuple(config["span"])), device=device)
    runner = LifecycleRunner(store, node, traffic.txns)
    runner.prepare(len(traffic.txns))
    span = trace.span_factory(None)
    got = SimpleNamespace(replies=[], applied=[], served=[], plans=[],
                          misses=[])
    planned = _record_plans(store)
    causes = store.device_miss_causes
    starts, ends = [], []

    def window(w: int) -> None:
        n0, h0 = len(node.applied), store.device_hits
        m0 = [causes[c] for c in MISS_CAUSES]
        planned.clear()
        starts.append(time.perf_counter())
        got.replies.append(runner.run_window(traffic.ops(w)))
        ends.append(time.perf_counter())
        got.applied.append([h for h, _ in node.applied[n0:]])
        got.served.append(store.device_hits - h0)
        got.misses.append([causes[c] - m for c, m in zip(MISS_CAUSES, m0)])
        got.plans.append({tid.hlc: wave for plan in planned
                          for tid, (wave, _eat) in plan.items()})

    for w in range(warm):
        window(w)
    if cuda:
        torch.cuda.synchronize(device)
    # as a node process does once it is built and its card warmed
    hold_off_full_collections()
    setup_s = time.perf_counter() - _T0

    prof = profiler = recorder = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        span = trace.span_factory(record_function)
        runner.span = span
        recorder = trace.StepRecorder(record_function)
        recorder.wrap(device_store)
        for attr, name in (("_precompute", "flush.deps"),
                           ("_plan_waves", "flush.waves")):
            setattr(store, attr, _spanned(getattr(store, attr), span, name))
        profiler = store.profiler = Profiler(Registry(), sample_n=1)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    entries_first = _entries(store)
    w = warm
    with span("window"):
        t_start = time.perf_counter()
        while w < warm + measure:
            window(w)
            w += 1
            if time.perf_counter() - t_start >= OVERRUN * args.seconds:
                break
        if cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    entries_last = _entries(store)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's answers, then its state freed before the reference runs
    hlc_index = {spec[2]: i for i, spec in enumerate(traffic.txns)}
    done = [(hlc_index[h], t) for h, t in node.applied if t >= t_start]
    # lifecycles wholly inside the window: from the start of the window
    # that submitted the PreAccept to the Apply's execution
    lifecycle_ms = [(t - starts[i // traffic.window]) * 1e3 for i, t in done
                    if i // traffic.window >= warm]
    due = sum(len(traffic.applied_batch(v)) for v in range(warm, w))
    got.data = node.data_store.snapshot()
    got.writes = node.writes
    got.store_faults = int(store.device_disabled) + len(node.agent.failures)
    laps_s = {}
    if profiler is not None:
        hists = profiler.registry.snapshot()["histograms"].get(
            "accord_profile_kernel_us", {})
        laps_s = {parse_labels(k)["kernel"]: h["sum"] / 1e6
                  for k, h in hists.items()}
    summary = None
    if prof is not None:
        events = trace.export_events(prof)
        summary = trace.reduce_trace(events,
                                     trace.window_bounds(events, "window"))
        del events
    del runner, store, prof

    t_check = time.perf_counter()
    numbers = check.judge(traffic, got)
    check_s = time.perf_counter() - t_check
    correct = check.is_correct(numbers)

    run = SimpleNamespace(
        device=device.type, seconds=t_end - t_start, txns=len(done),
        windows=w - warm, laps_s=laps_s, lifecycle_ms=lifecycle_ms,
        trace=summary,
        least_bytes=dict(recorder.least_bytes) if recorder else {})
    metrics = {}
    if args.trace:
        for m in per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"txn_per_s": len(done) / run.seconds, "setup_s": setup_s}
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    if summary is not None and cuda:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    line = {"correct": correct, "attempted": due,
            "failed": max(0, due - len(done)), "metrics": metrics,
            "device": dev}
    if summary is not None and cuda:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    measured = slice(warm, w)
    line["info"] = {
        "windows": run.windows, "windows_planned": measure,
        "txns": run.txns, "seconds": run.seconds,
        "warmup_windows": warm, "entries_first": entries_first,
        "entries_last": entries_last, "setup_s": setup_s,
        "check_s": check_s,
        "lifecycle_p50_ms": statistics.median(lifecycle_ms)
        if lifecycle_ms else None,
        "card": power_limit() if cuda else None,
        "laps_s": laps_s,
        "step_s": summary["step_s"] if summary else None,
        "least_bytes": run.least_bytes,
        # the first, the median and the last measured flush window's
        # seconds
        "window_s": _first_median_last([e - s for s, e in zip(
            starts[measured], ends[measured])]),
        # the deps scans each measured window served from the card, and
        # those it served on the host, by cause
        "device_hits": got.served[measured],
        "device_misses": dict(zip(MISS_CAUSES, map(list, zip(
            *got.misses[measured])))),
        "native": {"sorted_arrays": native.AVAILABLE,
                   "cfk": native.get_cfk() is not None}}
    line["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                      for k, v in numbers.items()}

    found = forbidden_modules()
    if found:
        print(f"accord_bench: modules loaded that the benchmark may not "
              f"load: {found}", file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _first_median_last(values: list) -> list:
    return [values[0], statistics.median(values), values[-1]] \
        if values else []


def _record_plans(store) -> list:
    """Keep each wave plan the store makes (its return value) in the list
    returned."""
    plans = []
    plan_waves = store._plan_waves

    def record(window):
        plan = plan_waves(window)
        if plan is not None:
            plans.append(plan)
        return plan
    store._plan_waves = record
    return plans


def _spanned(fn, span, name):
    def call(*a, **kw):
        with span(name):
            return fn(*a, **kw)
    return call


def _entries(store) -> int:
    """E: the conflict-index entries of the store's keys."""
    return sum(c.size() for c in store.cfks.values())


if __name__ == "__main__":
    sys.exit(main())
