#!/usr/bin/env python3
"""What holds a node process's loop in the bench lanes over node processes.

    python3 node_probe.py                     (from the repository root, on a card)
    python3 node_probe.py --device cpu --runs 1

The node processes start with two steps (``host.tcp._warm_card`` runs every
step of a store's flush once, ``workload.warm_flush_path``; and
``host.tcp.hold_off_full_collections`` freezes the heap and makes full
collections rarer).  Each probe runs with both steps, as the host does, and
with each taken out: this script writes a ``sitecustomize`` module into a
temporary directory on the node processes' PYTHONPATH that replaces
``warm_flush_path`` or ``gc.freeze`` and ``gc.set_threshold`` with no-ops
in them, and that logs every full (generation-2) collection a process
makes.  The program itself has no switch for either step.

1. ``laps``: the multicore lane's in-loop node and the tcp lane's three
   nodes (ACCORD_PROFILE=1): each node's deps_kernel, deps_encode and
   wavefront_kernel laps, their count, mean and log2-µs histogram, with and
   without the warm-up;
2. ``overload``: the slo-overload lane with device stores and with scalar
   stores, each with and without the hold-off: its verdicts, each window's
   goodput, pooled and high-class p99, and the nodes' full collections
   (count, median and largest pause);
3. ``timeout``: the tcp lane at the 1 s RPC timeout, with and without the
   warm-up: acked of 400, or the error that ended it.

Each result is one JSON line with the hardware it ran on.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

SITECUSTOMIZE = '''
import gc, os, sys, time
if os.environ.get("NODE_PROBE_NO_HOLD_OFF"):
    gc.freeze = lambda: None
    gc.set_threshold = lambda *args: None
if os.environ.get("NODE_PROBE_GC_LOG"):
    _start = []
    def _log(phase, info):
        if phase == "start":
            _start[:] = [time.perf_counter()]
        elif info.get("generation") == 2 and _start:
            print("node_probe gc2 %d %.3f" % (
                os.getpid(), (time.perf_counter() - _start[0]) * 1e3),
                file=sys.stderr, flush=True)
    gc.callbacks.append(_log)
if os.environ.get("NODE_PROBE_NO_WARM"):
    import importlib.abc, importlib.util
    class _NoWarm(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name != "accord_tpu_torch.workload":
                return None
            sys.meta_path.remove(self)
            spec = importlib.util.find_spec(name)
            run = spec.loader.exec_module
            def exec_module(module):
                run(module)
                module.warm_flush_path = lambda device: None
            spec.loader.exec_module = exec_module
            return spec
    sys.meta_path.insert(0, _NoWarm())
'''

PROBE_ENV = ("NODE_PROBE_NO_HOLD_OFF", "NODE_PROBE_GC_LOG",
             "NODE_PROBE_NO_WARM")


class NodeEnv:
    """The node processes' sitecustomize on PYTHONPATH and the probe's
    settings for one run; node stderr into a file, read back by
    ``collections``."""

    def __init__(self, hook_dir: str, **settings):
        self.hook_dir = hook_dir
        self.settings = settings

    def __enter__(self):
        self.saved = {k: os.environ.get(k)
                      for k in (*PROBE_ENV, "PYTHONPATH")}
        for k in PROBE_ENV:
            os.environ.pop(k, None)
        os.environ.update({k: "1" for k, on in self.settings.items() if on})
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (self.hook_dir, os.getcwd(), self.saved["PYTHONPATH"])
            if p)
        fd, self.err_path = tempfile.mkstemp(prefix="node-probe-",
                                             suffix=".err")
        os.close(fd)
        sys.stderr.flush()
        self.saved_fd = os.dup(2)
        err = os.open(self.err_path, os.O_WRONLY | os.O_TRUNC)
        os.dup2(err, 2)
        os.close(err)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self.saved_fd, 2)
        os.close(self.saved_fd)
        with open(self.err_path) as f:
            self.stderr = f.read()
        os.unlink(self.err_path)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def collections(self) -> dict:
        pauses = [float(line.split()[3]) for line in self.stderr.splitlines()
                  if line.startswith("node_probe gc2 ")]
        return {"full_collections": len(pauses),
                "median_ms": statistics.median(pauses) if pauses else None,
                "max_ms": max(pauses) if pauses else None}


def lap_stats(snaps) -> list:
    from accord_tpu_torch.obs.registry import parse_labels
    out = []
    for snap in snaps:
        hists = snap["metrics"]["histograms"].get("accord_profile_kernel_us",
                                                  {})
        laps = {}
        for labels, h in hists.items():
            kernel = parse_labels(labels)["kernel"]
            if kernel in ("deps_kernel", "deps_encode", "wavefront_kernel"):
                laps[kernel] = {"count": h["count"],
                                "mean_ms": h["sum"] / max(1, h["count"]) / 1e3,
                                "log2_us": h["buckets"]}
        out.append({"node": snap["node"], "laps": laps})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--runs", type=int, default=2,
                    help="runs of each overload arm and timeout arm")
    ap.add_argument("--probes", default="laps,overload,timeout")
    ns = ap.parse_args(argv)
    import torch

    from accord_tpu_torch import bench
    from accord_tpu_torch.workload import openloop
    on_card = ns.device is None
    if on_card and not torch.cuda.is_available():
        print("node_probe: no CUDA device is available", file=sys.stderr)
        return 2
    if on_card:
        from accord_tpu_torch.ops import cuda_kernels
        cuda_kernels.build()
    hardware = (bench.card_name_and_power_limit() if on_card else "cpu")
    probes = ns.probes.split(",")
    hook_dir = tempfile.mkdtemp(prefix="node-probe-")
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(SITECUSTOMIZE)

    def emit(row):
        print(json.dumps({"hardware": hardware, **row}), flush=True)

    # every lane function passes its snapshots to per_node_rows: keep them
    seen = []
    rows_of = bench.per_node_rows

    def keep_rows(snaps):
        seen.append(snaps)
        return rows_of(snaps)

    bench.per_node_rows = keep_rows
    os.environ["ACCORD_PROFILE"] = "1"

    if "laps" in probes:
        for warm in (True, False):
            for name, lane in (
                    ("multicore in-loop",
                     lambda: bench.multicore_lane(ns.device, shards_list=(1,))),
                    ("tcp", lambda: bench.tcp_lane(ns.device))):
                seen.clear()
                with NodeEnv(hook_dir, NODE_PROBE_NO_WARM=not warm):
                    out = lane()
                emit({"probe": "laps", "lane": name, "warm_up": warm,
                      "txn_per_s": out["value"],
                      "nodes": lap_stats(seen[-1])})

    if "overload" in probes:
        runs = []
        run_overload = openloop.run_overload_tcp

        def keep_run(**kwargs):
            runs.append(run_overload(**kwargs))
            return runs[-1]

        openloop.run_overload_tcp = keep_run
        for _ in range(ns.runs):
            for stores in ("device", "scalar"):
                for hold_off in (True, False):
                    with NodeEnv(hook_dir, NODE_PROBE_GC_LOG=True,
                                 NODE_PROBE_NO_HOLD_OFF=not hold_off) as env:
                        try:
                            bench.slo_overload_lane(
                                ns.device, scalar_stores=stores == "scalar")
                            verdicts = "held"
                        except AssertionError as e:
                            verdicts = str(e)[:300]
                    ov = runs[-1].report["overload"]
                    emit({"probe": "overload", "stores": stores,
                          "hold_off": hold_off, "verdicts": verdicts,
                          "high_p99_at_5x_us": ov["high_p99_at_5x_us"],
                          "high_p99_uncontended_us":
                              ov["high_p99_uncontended_us"],
                          "goodput_at_5x_frac_of_peak":
                              ov["goodput_at_5x_frac_of_peak"],
                          "windows": [
                              {"x": w["multiplier"],
                               "goodput": w["goodput_per_s"],
                               "p99_us": w["open_p99_us"],
                               "high_p99_us":
                                   w["classes"]["high"]["open_p99_us"]}
                              for w in ov["windows"]],
                          **env.collections()})
        openloop.run_overload_tcp = run_overload

    if "timeout" in probes:
        for warm in (True, False):
            for _ in range(ns.runs):
                t0 = time.perf_counter()
                with NodeEnv(hook_dir, NODE_PROBE_NO_WARM=not warm):
                    try:
                        out = bench.tcp_lane(
                            ns.device,
                            env={"ACCORD_HOST_RPC_TIMEOUT_S": "1"})
                        result = {"acked": out["acked"], "ops": out["ops"],
                                  "txn_per_s": out["value"]}
                    except Exception as e:  # noqa: BLE001 — the probe's datum
                        result = {"error": repr(e)[:300]}
                emit({"probe": "timeout", "rpc_timeout_s": 1,
                      "warm_up": warm,
                      "seconds": time.perf_counter() - t0, **result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
