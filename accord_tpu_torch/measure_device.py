#!/usr/bin/env python
"""Device-tier measurement harness on the port's device stores: the three
experiments behind the reference's BASELINE.md tables (the wavefront A/B,
the flush-window latency tax, hit rate against contention).

Each experiment runs same-seed in-process BurnRuns (deterministic
discrete-event simulator: latencies are VIRTUAL time, immune to host load)
across its arms and prints a markdown table.  The tables are therefore the
reference harness's on any backend; what the device changes is the wall
time, printed last with the card's name and power limit.

Usage: python -m accord_tpu_torch.measure_device [waves|latency|hitrate|all]
           [--device cuda|cpu] [--out RAW.json]
       (the stores run on the CUDA card by default, and fail without one;
       --out writes the raw rows as JSON)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from accord_tpu_torch.local import commands
from accord_tpu_torch.sim.burn import BurnRun

SEEDS = (9101, 9102, 9103)
OPS = 150


def run_burn(seed, *, store_factory=None, keys=20, drop=0.10,
             partitions=True, stores=2, ops=OPS):
    commands.reset_work_counters()
    run = BurnRun(seed, ops, nodes=3, keys=keys, n_shards=4,
                  drop_prob=drop, partitions=partitions,
                  num_command_stores=stores, store_factory=store_factory)
    stats = run.run()
    work = dict(commands.WORK)
    dev = {}
    for node in run.cluster.nodes.values():
        for s in node.command_stores.all():
            for attr in ("device_hits", "device_misses",
                         "device_recovery_hits", "device_recovery_misses",
                         "device_range_hits", "device_range_misses",
                         "device_wave_batches", "device_wave_planned",
                         "device_wave_executed"):
                if hasattr(s, attr):
                    dev[attr] = dev.get(attr, 0) + getattr(s, attr)
    return {
        "acks": stats.acks, "nacks": stats.nacks,
        "p50_ms": stats.latency_us(50) / 1e3,
        "p95_ms": stats.latency_us(95) / 1e3,
        "p99_ms": stats.latency_us(99) / 1e3,
        "events": run.cluster.queue.processed,
        "virtual_s": run.cluster.now_s,
        "work": work, "dev": dev,
    }


def avg(rows, key_fn):
    vals = [key_fn(r) for r in rows]
    return sum(vals) / max(1, len(vals))


# ------------------------------------------------------------ experiment 1
def waves_ab(device="cuda"):
    """Same-seed A/B: device store with the wavefront plan ON vs OFF.
    Reports the scalar listener-walk work (Commands WORK counters), wave
    stats, and client latency."""
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    print("## Wavefront plan A/B (device store, same seeds, "
          f"{OPS} ops x {len(SEEDS)} seeds, 10% loss + partitions)\n")
    print("| arm | maybe_execute | notify | wave_planned | wave_executed |"
          " p50 ms | p95 ms | acks |")
    print("|---|---|---|---|---|---|---|---|")
    results = {}
    for label, plan in (("plan ON", True), ("plan OFF", False)):
        rows = [run_burn(s, store_factory=DeviceCommandStore.factory(
            flush_window_us=300, verify=True, plan_waves=plan,
            device=device))
            for s in SEEDS]
        results[label] = rows
        print(f"| {label} "
              f"| {avg(rows, lambda r: r['work']['maybe_execute']):.0f} "
              f"| {avg(rows, lambda r: r['work']['notify']):.0f} "
              f"| {avg(rows, lambda r: r['dev'].get('device_wave_planned', 0)):.0f} "
              f"| {avg(rows, lambda r: r['dev'].get('device_wave_executed', 0)):.0f} "
              f"| {avg(rows, lambda r: r['p50_ms']):.1f} "
              f"| {avg(rows, lambda r: r['p95_ms']):.1f} "
              f"| {avg(rows, lambda r: r['acks']):.1f} |")
    on = avg(results["plan ON"], lambda r: r["work"]["maybe_execute"])
    off = avg(results["plan OFF"], lambda r: r["work"]["maybe_execute"])
    delta = (on - off) / off * 100 if off else 0.0
    print(f"\nmaybe_execute delta plan-ON vs OFF: {delta:+.1f}%")
    return results


# ------------------------------------------------------------ experiment 2
def latency_tax(device="cuda"):
    """Client-visible commit latency: scalar store vs device store at
    flush_window_us in {0, 300, 800}, same seeds (virtual time)."""
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    print("## Flush-window latency tax (same seeds, virtual-time "
          f"latencies, {OPS} ops x {len(SEEDS)} seeds, 10% loss)\n")
    print("| store | p50 ms | p95 ms | p99 ms | acks |")
    print("|---|---|---|---|---|")
    arms = [("scalar", None)] + [
        (f"device fw={w}us", DeviceCommandStore.factory(
            flush_window_us=w, verify=True, device=device))
        for w in (0, 300, 800)]
    out = {}
    for label, factory in arms:
        rows = [run_burn(s, store_factory=factory) for s in SEEDS]
        out[label] = rows
        print(f"| {label} | {avg(rows, lambda r: r['p50_ms']):.1f} "
              f"| {avg(rows, lambda r: r['p95_ms']):.1f} "
              f"| {avg(rows, lambda r: r['p99_ms']):.1f} "
              f"| {avg(rows, lambda r: r['acks']):.1f} |")
    return out


# ------------------------------------------------------------ experiment 3
def hit_rates(device="cuda"):
    """Device-serve hit rates vs contention: keys in {4, 16, 64}."""
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    print("## Device hit rates vs contention "
          f"({OPS} ops x {len(SEEDS)} seeds, 10% loss + partitions)\n")
    print("| keys | deps hit% | recovery hit% | range hit% | acks |")
    print("|---|---|---|---|---|")
    out = {}
    for keys in (4, 16, 64):
        rows = [run_burn(s, keys=keys,
                         store_factory=DeviceCommandStore.factory(
                             flush_window_us=300, verify=True,
                             device=device))
                for s in SEEDS]
        out[keys] = rows

        def rate(h, m):
            th = sum(r["dev"].get(h, 0) for r in rows)
            tm = sum(r["dev"].get(m, 0) for r in rows)
            return 100.0 * th / max(1, th + tm)

        print(f"| {keys} "
              f"| {rate('device_hits', 'device_misses'):.1f} "
              f"| {rate('device_recovery_hits', 'device_recovery_misses'):.1f} "
              f"| {rate('device_range_hits', 'device_range_misses'):.1f} "
              f"| {avg(rows, lambda r: r['acks']):.1f} |")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m accord_tpu_torch.measure_device")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("waves", "latency", "hitrate", "all"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the stores: the CUDA card (default; "
                         "fails without one) or the CPU")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the raw rows as JSON to FILE")
    ns = ap.parse_args(argv)
    which, device = ns.which, ns.device
    if device == "cuda":
        from accord_tpu_torch.ops import cuda_kernels
        from accord_tpu_torch.utils.backend import (
            card_name_and_power_limit, resolve_device)
        resolve_device("cuda")
        cuda_kernels.build()
        platform = card_name_and_power_limit()
    else:
        platform = "cpu"
    print(f"platform: {platform}\n")
    t0 = time.perf_counter()
    results = {}
    if which in ("waves", "all"):
        results["waves"] = waves_ab(device)
        print()
    if which in ("latency", "all"):
        results["latency"] = latency_tax(device)
        print()
    if which in ("hitrate", "all"):
        results["hitrate"] = hit_rates(device)
    wall = time.perf_counter() - t0
    print(f"\nwall: {wall:.1f} s ({which}, stores on {platform})")
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump({"platform": platform, "wall_s": wall,
                       "results": results}, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
