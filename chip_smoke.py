#!/usr/bin/env python3
"""Proof on one H100 that the port builds and resolves a full flush window,
the full TPC-C new-order replay, a recovery window and the rangestress lane
through its hand-written CUDA kernels, serves the protocol store's flush
windows through them, runs the reference's flagship burn through them,
serves a three-node real-socket cluster with its device stores on the card,
and runs the bench lanes over node processes and shard workers with every
store on the card.

    python3 chip_smoke.py          (from the repository root, on a CUDA card)

Phases; any failure raises, exits non-zero and prints no result lines:
 1. build the port's three native C++ extensions (accord_tpu_torch/native/:
    the sorted arrays, the CommandsForKey core and the wire codec, g++ at
    first use next to their sources) and fail with g++'s message if one is
    missing or the interpreter's Python.h is absent; then the five kernels
    from accord_tpu_torch/csrc/ (one nvcc per source, all started together);
    print each build's seconds and ptxas' report;
 2. K1, the deps tile: kernel == plain torch on the card for three seeds of
    a small random world and for a world with K > 16384 (also cut to an E
    and a B that are not multiples of 4); K6, succ_w: kernel == plain torch
    on every workload.succ_w_case (one hot key, all writes, no writes,
    equal eats, a single entry, pads alone, the encoder's key blocks) at
    phase 4's E = 128,768, flat and stacked in 8 shards of 16,096;
 3. K2, the wavefront: kernel == plain torch == waves_oracle on random DAGs
    over permuted ranks at B = 512 (8%), 1001, 1152 and 2048, and on chains
    1024, 1152 and 2048 deep (the 2048 window's working set does not fit in
    shared memory, so it takes the global-scratch path; B = 1001 is not a
    multiple of 32: the ballot packing), each once with its ranks (K2 must
    take its forward pass) and once without (the forward pass where the
    rows are in triangular order, else the fixpoint, as K2 reports it), and
    on a DAG with a cycle (the fixpoint; rows on it keep -1);
 4. the main path at full size: entry()'s example window on cuda == on the
    CPU; then workload.build_world() (seed 42: 1024 keys, 65,536-txn
    conflict index, 512-txn window) through the default bench lane's
    counting run (bench.default_window: encoded and resolved by one
    resolve_step on cuda), with the launch counts zeroed just before and
    read just after; deps == the scalar oracle, edge count == the scalar
    scan's == 1,152,177, every wave >= 0, the three kernels of the step
    launched (K6's launches == K1's), and K2 takes its forward pass on the
    window;
 5. timing at the main path's shapes: each kernel's median ms (CUDA events),
    its bound, its plain version's ms, K1's two launches apart (the packing
    pass, the tile) beside a memset of its output, K2's forward pass and
    fixpoint on phase 3's B = 512 random DAG, K6 == plain on the window and
    its ms beside its bound and the plain succ_w's ms, its four steps apart
    (count, scatter, sort and merge, search), the plain step's ms,
    and the default lane's report (bench.default_report: the step's median
    ms, the rate and the per-kernel profile, each kernel's count, p50 and
    p99 in us over 24 reps) with the step's split into K6, K1, the graph and
    K2;
 6. K4, the key-set windows: kernel == plain torch == the scalar
    window_oracle on the tests/test_pallas.py inputs (W=3, B=128, P=11) for
    three seeds, on a B = 2048 window over a small key domain (a DAG 784
    waves deep), on B = 1000 with permuted ranks, on workload.keyset_cases
    (tied ranks, keys at 0 and 2**31-1, all rows padded, one key in every
    row, P = 1, P = 5, 22,528 key slots at B = 2048, P = 11 and at
    B = 1408, P = 16, and the large-window kernel's B = 4096, P = 11 and
    B = 1200, P = 20) and on one hot key held by all 2048 rows;
 7. the TPC-C replay at full size (1M txns, 64 warehouses, 489 windows of
    2048): tpcc.prepare, then tpcc.resolve with the launch counts zeroed
    just before and read just after; the counts == bench_tpcc's on the CPU
    (constants below), K4 launched once per K bucket, K4 == plain on every
    bucket, window_oracle == K4 on windows 0, 244 and 488;
 8. timing of the lane: K4's median ms for each K bucket and over both,
    its bound (from the bytes and a key-to-rows scan's operations on this
    run's data), the kernel's own work (slots sorted, pair checks, sweeps x
    slots, counted by the kernel) and its plain ms, the cross-window
    gather's ms, the whole pass's ms, txns/s and the host preparation
    seconds; then the same replay cut into windows of 4096 (K4's
    large-window kernel): K4 == plain on every window, window_oracle on
    three, and K4's ms over the pass;
 9. the recovery window (workload.recovery_world: 512 probes over a random
    world of 1024 keys and 16,384 txns, E = 32,896 entries, about the
    largest power-of-two world whose int32 codes the encoder admits):
    batched_recovery_scans on the card == on the CPU for all four masks,
    and, probe by probe, the reject masks folded with any() and the two id
    lists decoded == the scalar scans on all 512 probes; its median ms;
10. K5, the range stab counts: kernel == plain torch on workload.range_cases
    (N and Q no multiple of any tile, N = 1 and Q = 1, bounds at -2**31 and
    2**31-1, touching bounds, [0, 0) pads against negative queries) and on
    workload.range_index_cases (every interval inverted, every query
    inverted, [0, 0) intervals against [0, 0) queries, one q_end for all
    queries, one hot bin, three query tiles, a mix of inverted, empty and
    extreme bounds, N = 0, Q = 1, N = 1);
11. the rangestress lane at full size (1,000,000 intervals, 10,000 queries,
    seed 42): its counting run (bench.rangestress_counts), with the launch
    counts zeroed just before and read just after: one K5 launch and no
    other, the total == 15,193,250, the lane's host sample check; K5 == the
    chunked plain version, == a count by sorting and == K5's algorithm in
    plain torch (stab_counts_by_query_index) on all 10,000 counts; then its
    report (bench.rangestress_report: K5's median ms and the lane's rates),
    K5's four steps apart, its bound, the chunked plain version's ms, a
    yardstick of library calls (torch.sort of the starts and of the ends
    and two torch.searchsorted), K5 on the lane's first 10^4 intervals (its
    fixed cost) and on three stress inputs, each == the plain versions:
    10^6 copies of one interval (one hot bin), the store's
    127 [0, 0) pad intervals and 127 pad queries added to the lane's, and
    every query inverted (the pairwise pass over all 10^10 pairs);
12. the sharded step on phase 4's build_world window split into 8 key-range
    shards (ShardedEncoder, pad 8), stacked on the card: with the launch
    counts zeroed just before and read just after, one make_sharded_step
    call launches K6 once, K1 once and K2 once; the decoded deps == the scalar
    oracle, the summed counts == 1,152,177, graph and waves == phase 4's
    resolve_step; K1's stacked launch == its per-shard plain loop at full
    size (and with the shards' E cut by 8, the other 16-byte alignment of
    the planes' rows); K6 on the stack == the plain sharded succ_w; S = 1
    on phase 4's arrays == resolve_step; the deps step on the same window
    as probes (ShardedEncoder.for_probes, pad 128), one K6 and one K1
    launch and no other, decode_key_deps == BatchEncoder.for_probes's
    decode through resolve_step; entry.dryrun_multichip(8) on the card,
    with its protocol leg (the JAX dry run's hostile verify=True burn
    served by mesh stores of 8 shards: no op lost or pending, acks, hits).
    Then the stacked step's median ms at S = 8 and S = 1 beside
    resolve_step's, K1's stacked ms at both alignments beside its byte
    bound and a memset of its [S, B, E] output, the deps step's ms, and
    the padding factor S*E_shard / E.
13. the protocol store tier (bench.StoreBench): the default cell's shape,
    1024 keys at Zipf(0.99), as a store history of 4,096 txns (16,384
    before phase 17 needed the time; workload.default_store_plan: flush
    windows of 512 preaccepts, with
    every txn accepted one window later in one case of 8, committed stable
    and applied two windows later) through store.execute and the local state
    machine's transitions, into a flat DeviceCommandStore and a
    MeshDeviceCommandStore at S = 8 on the card in lockstep (verify on for
    the last 8 windows). Then the measured windows, each with verify on
    (every served scan checked inline against the scalar scan), each store
    checked after every window for a disabled device tier or a failure its
    agent recorded, and the launch counts zeroed just before it and read
    just after: the PreAccept window (512 preaccepts in one flush: one K6
    and one K1 launch and no other; the version gate serves exactly the
    window's first-touch preaccepts and misses the rest, as the JAX store
    does on the CPU), the same window through the mesh store (one stacked
    K6 and one stacked K1 launch; results and counters == the flat
    store's), a recovery window (512 BeginRecovery probes: every recovery
    scan served, one K6 and one K1 launch for their deps), a commit window
    and the Apply window (1536 Applies in one flush: one K2 launch and no
    other, the waves == the host oracle, every planned Apply executed), then 1024 range txns registered and a range
    window (448 key-domain and 64 range-domain preaccepts, the range arm
    served). It prints the history's seconds, E, and per window the wall ms
    split into the profiler's encode, kernel and decode laps and the rest,
    hits, misses and their causes; and K1 on the PreAccept window's probes
    and the copies of its mask and of phase 4's [512, 128,768] mask to the
    host, timed alone.
14. the protocol on the card: the protocol cells' burns
    (workload.PROTOCOL_BURNS) through the port's burn CLI,
    accord_tpu_torch.sim.burn.main, with the stores on the card, the
    profiler sampling every flush window (ACCORD_PROFILE=1) and the launch
    counts zeroed just before each burn and read just after.  The flagship
    (-s 1 -o 1000 --device-store --device-verify --drop 0.1 --partitions
    --drift --stores 4): its summary line == the JAX package's, byte for
    byte; every store still on its device tier and no agent failure; K1's
    (and K6's) launches == the deps flushes that reached it (deps_kernel
    laps), which
    with the recovery flushes (recovery_kernel laps) make device_batches;
    K2's launches == wave_batches (6); K4 and K5 not launched.  The mesh
    store's burns (its stacked K1, sharded_kernel laps) run in phases 16
    (delayed_mesh) and 18 (seed 58000).  It prints
    each burn's wall seconds, acked ops per wall second, the launches, and
    every store's encode, kernel and decode laps summed, beside the wall.
    Phases 13 and 14 run on the native tier and print it beside their times.
15. the real-socket host on the card (host.tcp, ACCORD_TCP_DEVICE_STORE=1),
    with the profiler sampling every flush window (ACCORD_PROFILE=1):
    (a) three TcpHost nodes in this process, every command store a
    DeviceCommandStore on the card with verify on and a 500 us flush
    window, the JAX package's 20 appends over 3 keys round-robin
    (tests/test_tcp_host.py::test_tcp_cluster_with_device_stores), with
    the launch counts zeroed just before and read just after: every txn
    acked, the history strictly serializable, every store on its device
    tier with device hits, no exception reported by a node's agent, the
    native tier on; K1's launches == the deps flushes (deps_kernel laps)
    > 0, K2's == wave_batches, K4 and K5 not launched; (b) the tcp+device
    lane at its defaults (python -m accord_tpu_torch.bench --config tcp:
    three node processes on real sockets, 100 keys, 400 ops, client depth
    16, seed 7, 1000 us flush windows): verified strictly serializable, at
    least 360 of 400 acked, no traceback or agent-reported exception on any
    process's stderr, and in every node the native tier (its ready line)
    and deps_kernel laps > 0 (a node's K1 launches: kernel launches in
    other processes are counted by their laps), which with its
    recovery_kernel laps make its device_batches, and wavefront_kernel laps
    == its wave_batches.  It prints the lane's acked txns a wall second, the
    client's p50 and p99 ack latency, its wall seconds, each node's
    tiers, device counters and laps (counts and summed ms), and the nodes'
    merged fast-path ratio, txn and phase latencies and loop health.
16. the bounded-memory store and the burn's remaining arms on the card,
    the profiler sampling every flush window (ACCORD_PROFILE=1) and the
    launch counts zeroed just before each run and read just after:
    (a) the slo-zipf1m lane (bench.slo_zipf1m_run: 1,000,000 keys, 4,000
    zipfian ops, Poisson at 300/s, seed 17, 50 resident commands a store,
    25 s of virtual time to settle) with every store a DeviceCommandStore
    on the card (300 us windows, verify on): the lane's verdicts (no lost,
    failed or pending op; evictions on every node; resident high water at
    most 2 * cap + 64 and under 10% of the working set; refaults, CFK
    evictions, audit agreement, no leak alarm), its fingerprint
    (workload.open_loop_fingerprint: counts, open-loop quantiles in
    virtual us, the paging section, each node's paging stats and device
    counters) == the JAX package's (workload.ZIPF1M_DEVICE_FINGERPRINT),
    K1's launches == the deps_kernel laps of all stores, which with the
    recovery laps make device_batches, and K2's == wave_batches; (b) four
    more protocol arms through the burn CLI as in phase 14
    (workload.PROTOCOL_BURNS: the delayed-executor stores over the flat
    and the mesh store, a crash-restart whose replayed node resolves a
    window of at least 45 probes through K1 and a wave plan through one K2
    launch, the geo profile with a narrowed electorate and DC partitions):
    each line == the JAX package's, K1 == the deps flushes (stacked K1 for
    the mesh store), K2 == wave_batches, K4 and K5 not launched.  It prints
    each run's wall seconds, launches and laps, and (a)'s paging stats.
17. the bench lanes over node processes and shard workers, each through
    its own process (python -m accord_tpu_torch.bench --config X, with
    ACCORD_PROFILE=1), every command store a DeviceCommandStore on the
    card: pipeline (the tcp lane with the ingest pipeline, client 64
    deep), slo-tcp, ephemeral and slo-journal (open-loop over three node
    processes, the pipeline on; slo-journal with the WAL), slo-reshard (a
    node joins under load, node 1 drains and retires), slo-overload (0.5x
    to 10x of 120 txn/s, QoS armed) and multicore (one node, its stores in
    1, 2 and 4 shard workers; the JAX lane's keys all lie in worker 0's
    slice, so the others must show no flush), then multicore at 4 workers
    with the keys spread over the span.  Each lane keeps its JAX verdicts
    (it raises otherwise), no process reports a traceback or an exception
    on stderr, and every node process or shard worker (its row read from
    its metrics, a worker's from its stats frame) has DeviceCommandStores
    on cuda, none off its device tier, deps_kernel laps > 0 that with its
    recovery laps make its device_batches, K1's launches in the process ==
    its deps laps and K2's == its wave batches, K4 and K5 none.  It prints
    each lane's acked txns a wall second, p50 and p99 (the client's ack
    latency for pipeline, open-loop from the intended start for the rest)
    and wall seconds, and each process's launches, widest flush window,
    widest K1 batch and summed laps.
18. two seeds of the hostile-seed soak (accord_tpu_torch/soak.py) through
    the burn CLI as in phase 14, their arguments and the JAX package's
    lines from the soak's expected-lines file (soak_lines.json): seed 57012
    of device-loss25-rangeheavy-part (the reference's worst-class fault of
    its first soak wave) and seed 58000 of
    mesh-loss25-part-drift-8stores-contended (8 mesh stores a node, each
    deps flush one stacked K1 launch).  Each line == the JAX package's, no
    store left its device tier, no agent failure, K1 == the deps flushes,
    K2 == wave_batches, K4 and K5 not launched; it prints each run's wall
    seconds, launches and laps, and the phase's seconds.
19. the bench's regression gate (accord_tpu_torch/bench_guard.py): (a) the
    dry run of every config over the committed history
    (accord_tpu_torch/BENCH_HISTORY.json): each exits 0 and names its
    baseline; (b) on the card, against a scratch history in a temporary
    directory: phase 5's default row is emitted as the baseline, then the
    lane's report on phase 4's window again with ACCORD_PROFILE_SCALE=2:
    run_guard returns 2, names "kernel deps_kernel", and leaves the failed
    row retired (stale, guard_failed) and the baseline restored; then with
    a scale of 0.5, no kernel problem.  It prints the baselines, the
    gate's messages and the phase's seconds.
20. the sharded step over a list of cards (ops/sharded.py, devices=), on
    the one card here: phase 12's window in 8 shards over [cuda:0], its
    counts and key-sharing products summed by an NCCL all-reduce over the
    one card; with the launch counts zeroed just before and read just
    after, the stacked step's launches, and every output == the stacked
    step's; the one-card NCCL sums == the plain sums;
    entry.dryrun_sharded_step(8, devices=[cuda:0]); the step's median ms
    beside the stacked step's.  The four-card form runs in
    accord_tpu_torch/multichip.py.
Every K1 launch on the path comes with one K6 launch before it (succ_w, which
the tile reads), so from phase 4 on each count of K1's launches is held ==
K6's as well.  The tolerance everywhere is exact equality: every output is
integer or bool.

Then, on lines of their own: the card's name and power limit (nvidia-smi),
the kernels JSON object, and last {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and the 32-bit integer
# rate of the kernels' operations: 132 SMs of 64 INT32 lanes (NVIDIA's
# Hopper white paper) at the 1.98 GHz boost clock that the data sheet's
# 67 TFLOP/s in float32 implies (132 SMs x 128 lanes x 2 flops an FMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

# bench.bench_tpcc() with its defaults (seed 42), run on the CPU with the JAX
# package: the full replay's counts, the only tie to the reference on a
# machine without JAX
TPCC_WINDOWS = 489
TPCC_EDGES = 7_545_444
TPCC_CROSS = 5_929_224
TPCC_IN_WINDOW = 1_616_220
TPCC_MAX_WAVE = 13
# bench.bench_default()'s world: the scalar scan's edge count
DEFAULT_EDGES = 1_152_177
# phase 13's store history (txns), cut from 16,384 so that phase 17 fits
# in the script's time
STORE_HISTORY = 4_096
# the stage of a store's profiler lap, by the lap's suffix
LAP_STAGES = {"encode": "encode", "kernel": "device", "decode": "decode"}
# phase 18's soak seeds: (arm, seed, the kernel lap of its deps flushes).
# 57012 is the range-heavy 25%-loss seed that failed the reference's first
# soak wave (SOAK_NOTES.md:164-198); 58000 runs the 8-store contended mesh
# arm through the stacked K1
SOAK_SEEDS = (("device-loss25-rangeheavy-part", 57012, "deps_kernel"),
              ("mesh-loss25-part-drift-8stores-contended", 58000,
               "sharded_kernel"))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


NATIVE_SOURCES = {"sorted_arrays": ("_sorted_arrays.cpp", "_accord_native"),
                  "cfk": ("_cfk_core.cpp", "_accord_cfk"),
                  "wire": ("_wire_codec.cpp", "_accord_wire")}


def build_native() -> dict:
    """Build (or load) the port's three C++ extensions and time each; raise
    with g++'s message when one is missing.  It must run before anything
    else of the package is imported: the sorted arrays build when
    ``accord_tpu_torch.native`` is first imported.  -> {name: seconds}"""
    for knob, off in (("ACCORD_NO_NATIVE", "1"), ("ACCORD_NATIVE", "0")):
        check(os.environ.get(knob) != off,
              f"{knob}={off} selects the Python tier; the card runs native")
    include = sysconfig.get_paths()["include"]
    check(os.path.exists(os.path.join(include, "Python.h")),
          f"no Python.h under {include}: the native tier cannot build")
    t0 = time.perf_counter()
    from accord_tpu_torch import native
    seconds = {"sorted_arrays": time.perf_counter() - t0}
    for name, get in (("cfk", native.get_cfk), ("wire", native.get_wire)):
        t0 = time.perf_counter()
        get()
        seconds[name] = time.perf_counter() - t0
    loaded = {"sorted_arrays": native.get(), "cfk": native.get_cfk(),
              "wire": native.get_wire()}
    for name, mod in loaded.items():
        if mod is None:  # the package fell back: build again for the message
            try:
                native._build_and_load(*NATIVE_SOURCES[name])
                why = "it built now, but did not load at first use"
            except subprocess.CalledProcessError as e:
                why = e.stderr.decode(errors="replace")
            except Exception as e:  # noqa: BLE001 — reported, then raised
                why = repr(e)
            raise AssertionError(f"the native {name} extension is missing: "
                                 f"{why}")
    return seconds


NATIVE = {"sorted_arrays": "native", "cfk": "native", "wire": "native"}


def real_socket_host(card: str, device=None):
    """Phase 15: (a) three TcpHost nodes in this process, (b) the tcp+device
    lane's three node processes at its defaults.  `device` None is the card;
    "cpu" rehearses the phase without one."""
    from accord_tpu_torch import bench
    from accord_tpu_torch.host import tcp
    from accord_tpu_torch.host.tcp import native_tiers
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.workload import tcp_cluster_txns

    on_card = device is None
    # (a) three TcpHost nodes in this process, their stores on the card
    tcp_env = {"ACCORD_TCP_DEVICE_STORE": "1", "ACCORD_TCP_DEVICE_VERIFY": "1",
               "ACCORD_TCP_FLUSH_US": "500", "ACCORD_PROFILE": "1"}
    saved = {k: os.environ.get(k) for k in (*tcp_env, "ACCORD_TCP_DEVICE")}
    os.environ.update(tcp_env)
    if on_card:
        os.environ.pop("ACCORD_TCP_DEVICE", None)  # unset: the card
    else:
        os.environ["ACCORD_TCP_DEVICE"] = device
    agent_err = io.StringIO()
    try:
        ck.reset_launch_counts()
        warmed = dict(tcp.WARM_LAUNCHES)
        with contextlib.redirect_stderr(agent_err):
            cl = tcp_cluster_txns()
        if on_card:
            torch.cuda.synchronize()
        # the hosts' own launches: the card's warm-up's (once a process,
        # done here already by an earlier phase) taken out
        tcp_launches = {k.name: k.launches - tcp.WARM_LAUNCHES.get(k.name, 0)
                        + warmed.get(k.name, 0) for k in ck.KERNELS}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(native_tiers() == NATIVE, f"host tiers {native_tiers()}")
    stores = cl["stores"]
    check(len(stores) == 3
          and all(type(s) is DeviceCommandStore and s.verify
                  and s.device.type == ("cuda" if on_card else "cpu")
                  for s in stores),
          f"TCP host stores {[(type(s).__name__, s.device) for s in stores]}")
    check(not any(s.device_disabled for s in stores)
          and sum(s.device_hits for s in stores) > 0,
          "a TCP host store left its device tier or served no scan")
    check(not any(b in agent_err.getvalue()
                  for b in ("Traceback", "uncaught:", "handled:")),
          f"a TCP host's agent reported an exception:\n"
          f"{agent_err.getvalue()}")
    laps = bench.summed_profile_laps(n.obs.registry.snapshot()
                                     for n in cl["nodes"])
    summed = {c: sum(getattr(s, c) for s in stores)
              for c in ("device_batches", "device_wave_batches",
                        "device_hits", "device_misses",
                        "device_flush_windows")}
    k1_flushes = laps.get("deps_kernel", (0, 0))[0]
    # plain torch on the CPU launches nothing
    check(tcp_launches["deps_tile"] == tcp_launches["succ_w"]
          == (k1_flushes if on_card else 0) and k1_flushes > 0
          and k1_flushes + laps.get("recovery_kernel", (0, 0))[0]
          == summed["device_batches"],
          f"TCP host K1 launches {tcp_launches['deps_tile']}, laps {laps}, "
          f"{summed}")
    check(tcp_launches["wavefront"]
          == (summed["device_wave_batches"] if on_card else 0),
          f"TCP host K2 launches {tcp_launches['wavefront']}, {summed}")
    check(not tcp_launches["keyset_windows"]
          and not tcp_launches["range_stab"],
          f"TCP host launches {tcp_launches}")
    log(f"[tcp] {card}: three TcpHost nodes in this process, host tiers "
        f"{native_tiers()}, 20 appends over 3 keys in {cl['seconds']:.3f} s "
        f"({20 / cl['seconds']:.3f} acked txns a wall second), strictly "
        f"serializable; device counters {summed}; launches "
        f"{ {k: v for k, v in tcp_launches.items() if v} }; laps (count, ms) "
        + ", ".join(f"{k} ({c}, {ms:.3f})" for k, (c, ms) in
                    sorted(laps.items())))

    # (b) the tcp+device lane: three node processes, their stores on the
    # card, through the lane's command line
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ACCORD_TCP_", "ACCORD_BENCH_TCP_"))
           and k not in ("ACCORD_SHARDS", "ACCORD_PIPELINE")}
    env["ACCORD_PROFILE"] = "1"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "accord_tpu_torch.bench", "--config", "tcp",
         *(() if on_card else ("--device", device))],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    bad = [b for b in ("Traceback", "uncaught:", "handled:")
           if b in out.stderr]
    check(out.returncode == 0 and not bad,
          f"tcp lane: exit {out.returncode}, {bad}; stderr tail:\n"
          f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    nodes = line["per_node"]
    check(line["verified"] == "strict-serializable"
          and line["device"] == ("cuda" if on_card else "cpu")
          and line["ops"] == 400 and line["acked"] >= 360
          and len(nodes) == 3,
          f"tcp lane: {line}")
    for n in nodes:
        c, nl = n["device"], n["laps"]
        check(n["native"] == NATIVE, f"tcp lane node {n['node']}: {n}")
        check(nl.get("deps_kernel", 0) > 0
              and nl["deps_kernel"] + nl.get("recovery_kernel", 0)
              == c["device_batches"]
              and nl.get("wavefront_kernel", 0) == c["device_wave_batches"],
              f"tcp lane node {n['node']}: counters {c}, laps {nl}")
    lane_laps = {}
    for n in nodes:
        for k, v in n["laps"].items():
            lane_laps[k] = lane_laps.get(k, 0) + v
    check(lane_laps.get("wavefront_kernel", 0) > 0,
          f"tcp lane: no flush of 2 or more Applies reached K2: {lane_laps}")
    rate = (f"{line['value']:.3f} acked txns a wall second, ack p50 "
            f"{line['ack_p50_ms']:.3f} ms, p99 {line['ack_p99_ms']:.3f} ms, "
            f"{line['wall_seconds']:.3f} s of traffic" if on_card
            else "no rate on the CPU")
    log(f"[tcp] {card}: tcp+device lane, {line['ops']} ops, "
        f"{line['acked']} acked, strictly serializable; {rate}; "
        f"{wall:.1f} s with the processes' start; per node "
        + "; ".join(f"node {n['node']} {n['native']} {n['device']} laps "
                    f"{n['laps']}" for n in nodes)
        + f"; K1 launches {lane_laps['deps_kernel']}, K2 launches "
        f"{lane_laps['wavefront_kernel']} (laps summed over the nodes)")
    obs = line["obs"]
    log(f"[tcp] {card}: tcp+device lane, where the time goes: each node's "
        f"laps summed (ms) "
        + "; ".join(f"node {n['node']} "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                sorted(n["lap_ms"].items()))
                    for n in nodes)
        + "; the nodes' merged summary: "
        + json.dumps({k: obs[k] for k in ("fast_path_ratio", "recoveries",
                                          "txn_latency_us",
                                          "phase_latency_us", "loop")}))
    log(f"[tcp] lane line: "
        f"{json.dumps({k: v for k, v in line.items() if k != 'obs'})}")


def paged_store_on_card(card: str, tier: str, device=None):
    """Phase 16 (a): the slo-zipf1m lane with its stores DeviceCommandStores
    on the card, paging on.  `device` None is the card; "cpu" rehearses the
    phase without one."""
    from accord_tpu_torch import bench
    from accord_tpu_torch.local.paging import node_paging_stats
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.workload import (ZIPF1M_DEVICE_FINGERPRINT,
                                           open_loop_fingerprint)

    on_card = device is None
    saved = os.environ.get("ACCORD_PROFILE")
    os.environ["ACCORD_PROFILE"] = "1"
    try:
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        result, run = bench.slo_zipf1m_run(device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k.name: k.launches for k in ck.KERNELS}
    finally:
        if saved is None:
            del os.environ["ACCORD_PROFILE"]
        else:
            os.environ["ACCORD_PROFILE"] = saved
    cluster = run.cluster
    stores = [s for n in cluster.nodes.values()
              for s in n.command_stores.all()]
    check(len(stores) > 0 and all(
        s.pager is not None and s.verify
        and s.device.type == ("cuda" if on_card else "cpu") for s in stores),
        f"zipf1m stores {[(type(s).__name__, s.device) for s in stores]}")
    check(not any(s.device_disabled for s in stores)
          and not any(a.failures for a in cluster.agents.values()),
          "zipf1m: a store left its device tier or an agent failed")
    fp = open_loop_fingerprint(run, node_paging_stats)
    check(fp == ZIPF1M_DEVICE_FINGERPRINT,
          f"zipf1m fingerprint != the JAX package's: {fp}")
    laps = bench.summed_profile_laps(n.obs.registry.snapshot()
                                     for n in cluster.nodes.values())
    summed = {c: sum(getattr(s, c) for s in stores)
              for c in ("device_batches", "device_wave_batches",
                        "device_hits", "device_misses",
                        "device_range_batches")}
    k1_flushes = laps.get("deps_kernel", (0, 0))[0]
    check(launched["deps_tile"] == launched["succ_w"]
          == (k1_flushes if on_card else 0)
          and k1_flushes > 0 and "sharded_kernel" not in laps
          and k1_flushes + laps.get("recovery_kernel", (0, 0))[0]
          == summed["device_batches"],
          f"zipf1m K1 launches {launched['deps_tile']}, laps {laps}, "
          f"{summed}")
    check(launched["wavefront"]
          == (summed["device_wave_batches"] if on_card else 0)
          and laps.get("wavefront_kernel", (0, 0))[0]
          == summed["device_wave_batches"],
          f"zipf1m K2 launches {launched['wavefront']}, laps {laps}, "
          f"{summed}")
    check(not launched["keyset_windows"] and not launched["range_stab"],
          f"zipf1m launches {launched}")
    paging = result["slo"]["paging"]
    log(f"[paging] {card}, {tier}: slo-zipf1m, {result['ops']} ops over "
        f"1,000,000 keys, {result['acked']} acked, cap {paging['cap']} "
        f"commands a store, {len(stores)} stores; {wall:.1f} s wall "
        f"(lane, 25 s settle, refault probe, audit), "
        f"{result['acked'] / wall:.3f} acked ops per wall second; virtual "
        f"{result['value']} txn/s, open p99 {result['open_p99_ms']} ms; "
        f"launches {({k: v for k, v in launched.items() if v})}; device "
        f"counters {summed}; laps (count, ms) "
        + ", ".join(f"{k} ({c}, {ms:.1f})" for k, (c, ms) in
                    sorted(laps.items()))
        + f"; paging {paging}; per node "
        + "; ".join(f"{nid}: {n['paging']}"
                    for nid, n in fp["nodes"].items()))
    return result


# phase 17's lanes, in the order they run: (name, the bench's --config, or
# for the multicore lane with its keys spread over the span the call's
# arguments)
NODE_PROCESS_LANES = ("pipeline", "slo-tcp", "ephemeral", "slo-journal",
                      "slo-reshard", "slo-overload", "multicore",
                      "multicore-spread")


@contextlib.contextmanager
def _stderr_into(path: str):
    """File descriptor 2 of this process, and so of every process it
    starts, into `path` for the block."""
    sys.stderr.flush()
    saved = os.dup(2)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def _run_lane(name: str, device=None) -> tuple:
    """One phase-17 lane, the profiler sampling every flush window in its
    node processes (ACCORD_PROFILE=1) -> (its JSON object, wall seconds
    with the processes' start).  Fails on a traceback or an exception that
    the lane, a node process or a node's agent reported on stderr."""
    import tempfile
    from accord_tpu_torch import bench
    from accord_tpu_torch.host.maelstrom import TOKEN_SPAN

    if name == "multicore-spread":
        lane = functools.partial(bench.multicore_lane, shards_list=(4,),
                                 key_stride=TOKEN_SPAN // 50)
    else:
        lane = bench.LANES[name]
    fd, err_path = tempfile.mkstemp(prefix="lane-", suffix=".err")
    os.close(fd)
    saved = os.environ.get("ACCORD_PROFILE")
    os.environ["ACCORD_PROFILE"] = "1"
    t0 = time.perf_counter()
    try:
        with _stderr_into(err_path):
            line = lane(device=device)
        wall = time.perf_counter() - t0
        with open(err_path) as f:
            err = f.read()
    finally:
        os.unlink(err_path)
        if saved is None:
            del os.environ["ACCORD_PROFILE"]
        else:
            os.environ["ACCORD_PROFILE"] = saved
    bad = [b for b in ("Traceback", "uncaught:", "handled:") if b in err]
    check(not bad, f"{name} lane: {bad} on stderr:\n{err[-4000:]}")
    return line, wall


def node_process_lanes(card: str, device=None,
                       names=NODE_PROCESS_LANES) -> dict:
    """Phase 17: the bench lanes over node processes and shard workers
    (`names`, by default all of them), every command store a
    DeviceCommandStore on the card.  `device` None is the card; "cpu"
    rehearses the phase without one.  -> {lane: K1 launches summed over its
    processes}"""
    from accord_tpu_torch import bench
    from accord_tpu_torch.host.maelstrom import TOKEN_SPAN

    where = "cpu" if device is not None else "cuda"
    k1 = {}
    for name in names:
        line, wall = _run_lane(name, device)
        check(line["device"] == where, f"{name}: {line['device']}")
        if name.startswith("multicore"):
            counts = [int(n) for n in line["per_shards"]]
            check(counts == ([4] if name == "multicore-spread"
                             else [1, 2, 4]), f"{name}: {counts}")
            rows = []
            for n in counts:
                row = line["per_shards"][str(n)]
                owning = row["workers_with_keys"]
                want = ([0, 1, 2, 3] if name == "multicore-spread"
                        else [0])
                check(owning == want, f"{name} at {n}: {owning}")
                check(row["acked"] > 180, f"{name} at {n}: {row['acked']}")
                bench.check_per_node(
                    row["per_node"], where, workers=n if n >= 2 else 0,
                    idle=set(range(n)) - set(owning) if n >= 2 else ())
                rows += row["per_node"]
            rates = "; ".join(
                f"{n} {'worker' if n > 1 else 'in-loop'}"
                f"{'s' if n > 1 else ''}: "
                + (f"{line['per_shards'][str(n)]['aggregate_txn_per_s']:.3f}"
                   f" acked txns a wall second, "
                   f"{line['per_shards'][str(n)]['wall_seconds']:.3f} s"
                   if where == "cuda" else "no rate on the CPU")
                for n in counts)
        else:
            rows = line["per_node"]
            bench.check_per_node(rows, where)
            check(sorted(r["node"] for r in rows)
                  == ([1, 2, 3, 4] if name == "slo-reshard" else [1, 2, 3]),
                  f"{name}: nodes {[r['node'] for r in rows]}")
            if name == "pipeline":
                check(line["verified"] == "strict-serializable"
                      and line["acked"] > 360, f"pipeline: {line['acked']}")
                p50, p99 = line["ack_p50_ms"], line["ack_p99_ms"]
            else:
                p50, p99 = line["open_p50_ms"], line["open_p99_ms"]
            rates = (f"{line['value']:.3f} "
                     + ("peak goodput txns a wall second"
                        if name == "slo-overload" else
                        "acked txns a wall second")
                     + f", p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
                     f"{line['wall_seconds']:.3f} s of traffic"
                     if where == "cuda" else "no rate on the CPU")
        k1[name] = sum(r["launches"]["deps_tile"] for r in rows)
        extra = {k: line[k] for k in (
            "acked", "ops", "shed", "widest_flush_window_txns",
            "widest_k1_batch", "lost_acks", "availability_dip_pct",
            "goodput_at_5x_frac_of_peak", "high_p99_at_5x_us",
            "high_p99_uncontended_us", "verdicts", "cpus_available",
            "scaling_first_to_last") if k in line}
        log(f"[lanes] {card}: {name}, {rates}; {wall:.1f} s with the "
            f"processes' start; {extra}; K1 launches {k1[name]} == deps "
            f"flushes, K2 launches "
            f"{sum(r['launches']['wavefront'] for r in rows)}; per process "
            + "; ".join(
                f"node {r['node']}"
                + ("" if r["shard"] is None else f" shard {r['shard']}")
                + f" {r['stores'][0]['device']} launches "
                f"{ {k: v for k, v in r['launches'].items() if v} } "
                f"window_txn_max {r['device']['device_window_txn_max']} "
                f"max_batch {r['device']['device_max_batch']} lap ms "
                + ", ".join(f"{k} {v:.1f}"
                            for k, v in sorted(r["lap_ms"].items())
                            if k in ("deps_kernel", "wavefront_kernel",
                                     "deps_encode", "deps_decode"))
                for r in rows))
    return k1


def bench_gate(card: str, win, baseline: dict) -> None:
    """Phase 19: (a) ``run_guard_dry`` of every config over the committed
    history; (b) the gate against a scratch history: `baseline` (phase 5's
    default row) emitted, then the default lane's report on `win` (phase
    4's window) with ``ACCORD_PROFILE_SCALE`` 2, which must fail on
    ``kernel deps_kernel`` with the failed row retired and the baseline
    restored, and 0.5, which must report no kernel problem."""
    from accord_tpu_torch import bench, bench_guard

    committed = os.path.join(os.path.dirname(bench_guard.__file__),
                             "BENCH_HISTORY.json")
    saved = bench_guard.HISTORY_PATH
    scratch = tempfile.mkdtemp(prefix="guard-")
    try:
        # (a) the dry run over the committed history
        bench_guard.HISTORY_PATH = committed
        listed = []
        for config in sorted(bench.LANES):
            key = bench_guard.history_key(config)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = bench_guard.run_guard_dry(key)
            line = json.loads(out.getvalue())
            check(rc == 0 and line["metric"] == f"{key}_guard"
                  and line["baselines"], f"dry run of {key}: {line}")
            listed.append(f"{key} " + ", ".join(
                f"{b['pclass']} {b['value']}" for b in line["baselines"]))
        log(f"[guard] dry run of {len(listed)} configs over the committed "
            f"history, each exit 0: " + "; ".join(listed))

        # (b) the gate on the card against a scratch history
        bench_guard.HISTORY_PATH = os.path.join(scratch, "history.json")

        def emitted(row: dict) -> None:
            with contextlib.redirect_stdout(io.StringIO()):
                bench_guard.emit(row, "default", record=True)

        def recorded_lane() -> dict:
            with open(bench_guard.HISTORY_PATH) as f:
                return json.load(f)["default"]

        emitted(dict(baseline))
        recorded = recorded_lane()
        check(list(recorded) == ["device"]
              and recorded["device"]["platform"] == card,
              f"baseline row: {recorded}")
        base_k = baseline["profile"]["kernels"]
        for scale in ("2", "0.5"):
            os.environ["ACCORD_PROFILE_SCALE"] = scale
            try:
                row = bench.default_report(win)
            finally:
                del os.environ["ACCORD_PROFILE_SCALE"]
            emitted(row)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = bench_guard.run_guard(row, "default")
            problems = [ln for ln in err.getvalue().splitlines()
                        if ln.startswith("# GUARD REGRESSION (default): ")]
            kernels = [p for p in problems if ": kernel " in p]
            lane = recorded_lane()
            if scale == "2":
                check(rc == 2 and any(": kernel deps_kernel: " in p
                                      for p in kernels),
                      f"2x profile: rc {rc}, {err.getvalue()}")
                last = lane["superseded"][-1]
                check(lane["device"] == recorded["device"]
                      and last.get("guard_failed") and last.get("stale"),
                      f"2x profile: the history after the gate {lane}")
            else:
                check(not kernels, f"0.5x profile: {err.getvalue()}")
            log(f"[guard] {card}: ACCORD_PROFILE_SCALE={scale}: run_guard "
                f"{rc}; p50 us " + ", ".join(
                    f"{k} {base_k[k]['p50']} -> {v['p50']}"
                    for k, v in sorted(row["profile"]["kernels"].items()))
                + f"; {problems}")
    finally:
        bench_guard.HISTORY_PATH = saved
        shutil.rmtree(scratch, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    # ---- 1. build: the native C++ tier first (importing the package builds
    # it), then the CUDA kernels
    native_s = build_native()
    log(f"[build] native tier (g++): "
        + ", ".join(f"{n} {s:.1f}s" for n, s in native_s.items())
        + f"; Python.h under {sysconfig.get_paths()['include']}")
    from accord_tpu_torch import bench, tpcc
    from accord_tpu_torch.bench import StoreBench
    from accord_tpu_torch.entry import (dryrun_multichip,
                                        dryrun_sharded_step, entry)
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.ops import (deps_kernel, keyset, range_kernel,
                                      wavefront)
    from accord_tpu_torch.ops.encode import (PAD, WRITE_KIND_MASK,
                                             BatchEncoder,
                                             scalar_deps_oracle,
                                             window_to_tensors)
    from accord_tpu_torch.ops.sharded import (ShardedEncoder,
                                              all_reduce_sum,
                                              make_sharded_deps_step,
                                              make_sharded_step, resolve_step,
                                              shard_to_devices)
    from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                      batched_recovery_scans,
                                                      scalar_predicates)
    from accord_tpu_torch.utils.backend import card_name_and_power_limit
    from accord_tpu_torch.utils.random_source import RandomSource
    from accord_tpu_torch.utils.timing import median_ms
    from accord_tpu_torch.sim import burn
    from accord_tpu_torch.soak import EXPECTED_LINES as SOAK_LINES
    from accord_tpu_torch.soak import load_expected
    from accord_tpu_torch.workload import (PROTOCOL_BURNS, SUCC_W_CASES,
                                           build_world, device_counters,
                                           first_touch_preaccepts,
                                           keyset_cases, random_world,
                                           range_cases, range_index_cases,
                                           rangestress_inputs, recovery_world,
                                           succ_w_case)

    dev = torch.device("cuda", 0)
    sys.setrecursionlimit(20000)  # waves_oracle recurses along DAG chains
    err = {"deps_tile": 0, "wavefront": 0, "keyset_windows": 0,
           "range_stab": 0, "succ_w": 0}

    t0 = time.perf_counter()
    seconds = ck.build()
    log(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in seconds.items())}; "
        f"wall {time.perf_counter() - t0:.1f}s")
    for k in ck.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {k.name}: {line.strip()}")
        k.lib()

    log(f"[phase] 2 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 2. K1 == plain
    def deps_vs_plain(label, args):
        m_k, c_k = ck.deps_tile_cuda(*args)
        m_p, c_p = deps_kernel.deps_tile(*args)
        torch.cuda.synchronize()
        e = max(max_abs_err(m_k, m_p), max_abs_err(c_k, c_p))
        err["deps_tile"] = max(err["deps_tile"], e)
        check(e == 0, f"K1 != plain on {label}")
        return m_k, c_k

    def deps_case(label, cfks, batch, ragged=False):
        enc = BatchEncoder(cfks, batch)
        (er, eer, ek, es, ekd, tr, twm, _tk, touches) = window_to_tensors(
            enc.state, enc.dbatch, dev)
        succ = deps_kernel.successor_write_eat(er, eer, ek, es, ekd)
        args = (touches, ek, er, eer, es, ekd, succ, tr, twm)
        m_k, c_k = deps_vs_plain(label, args)
        if ragged:
            # E and B off the encoder's multiples of 128 (and of 4 and 32)
            e, b = er.shape[0] - 3, tr.shape[0] - 5
            deps_vs_plain(f"{label}, E={e} B={b}",
                          (touches[:b],) + tuple(a[:e] for a in args[1:7])
                          + (tr[:b], twm[:b]))
        got = enc.decode_deps(m_k.cpu().numpy())
        check(got == scalar_deps_oracle(cfks, batch),
              f"K1 deps != scalar oracle on {label}")
        log(f"[K1] {label}: B={touches.shape[0]} E={er.shape[0]} "
            f"K={touches.shape[1]} edges={int(c_k.sum())} == plain == oracle")

    for seed in range(3):
        cfks, batch = random_world(RandomSource(500 + seed), n_keys=40,
                                   n_existing=400, n_batch=200)
        deps_case(f"random world seed {500 + seed}", cfks, batch)
    cfks, batch = build_world(n_keys=16500, n_existing=3000, n_batch=256,
                              seed=11)
    deps_case("K=16500 world", cfks, batch, ragged=True)

    # ---- 2. K6 == plain
    def succ_w_vs_plain(label, arrays, n_keys):
        """K6 on `arrays` (the five entry arrays, flat or stacked) == the
        plain succ_w on the same CUDA tensors."""
        got = ck.successor_write_eat_cuda(*arrays, n_keys)
        want = deps_kernel.sharded_successor_write_eat(*arrays, n_keys) \
            if arrays[0].dim() == 2 else \
            deps_kernel.successor_write_eat(*arrays)
        torch.cuda.synchronize()
        e_ = max_abs_err(got, want)
        err["succ_w"] = max(err["succ_w"], e_)
        check(e_ == 0, f"K6 != plain on {label}")
        return int((got != 2 ** 31 - 1).sum())

    for name in SUCC_W_CASES:
        for shards, e_case in ((0, 128_768), (8, 16_096)):
            arrays, n_keys = succ_w_case(name, e_case, shards)
            found = succ_w_vs_plain(
                f"{name}, S = {shards}",
                tuple(torch.from_numpy(a).to(dev) for a in arrays), n_keys)
            log(f"[K6] {name}: {'flat' if not shards else f'S = {shards}'} "
                f"E={arrays[0].shape[-1]} Ks={n_keys}: {found} entries "
                f"with a successor write == plain")

    log(f"[phase] 3 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 3. K2 == plain == oracle, and the path it takes
    def waves_run(label, dep, rank, want_forward):
        stats = torch.zeros(3, dtype=torch.int32, device=dev)
        w_k = ck.execution_waves_cuda(dep, rank, stats=stats)
        w_p = wavefront.execution_waves(dep)
        torch.cuda.synchronize()
        e = max_abs_err(w_k, w_p)
        err["wavefront"] = max(err["wavefront"], e)
        check(e == 0, f"K2 != plain on {label}")
        forward, sorted_ranks, steps = stats.tolist()
        check(forward == want_forward,
              f"K2 took its {'forward pass' if forward else 'fixpoint'} on "
              f"{label}")
        return w_k, f"{'forward' if forward else 'fixpoint'} " \
            f"{'(ranks sorted) ' if sorted_ranks else ''}{steps} steps"

    def waves_case(label, dep_np, rank_np, depth=None):
        """With the ranks K2 must take its forward pass; without them, its
        forward pass exactly when the rows are in triangular order."""
        dep = torch.from_numpy(dep_np).to(dev)
        w_r, how_r = waves_run(f"{label} with ranks", dep,
                               torch.from_numpy(rank_np).to(dev), 1)
        w_n, how_n = waves_run(f"{label} without ranks", dep, None,
                               int(not np.triu(dep_np).any()))
        rows = [list(np.nonzero(r)[0]) for r in dep_np]
        check(w_r.cpu().tolist() == wavefront.waves_oracle(rows),
              f"K2 != waves_oracle on {label}")
        check(depth is None or int(w_r.max()) == depth,
              f"K2 max wave on {label} is not {depth}")
        mode = "shared" if ck.wavefront_bits_in_smem(dep_np.shape[0]) \
            else "global"
        log(f"[K2] {label}: B={dep_np.shape[0]} working set in {mode} memory, "
            f"max wave {int(w_r.max())} == plain == oracle; with ranks "
            f"{how_r}, without {how_n}")

    rng = np.random.default_rng(600)
    random_dags = {}
    for n, p in ((512, 0.08), (1001, 0.03), (1152, 0.02), (2048, 0.01)):
        rank = rng.permutation(n).astype(np.int32)
        dag = (rng.random((n, n)) < p) & (rank[None, :] < rank[:, None])
        random_dags[n] = (dag, rank)
        waves_case(f"random {p:.0%} DAG", dag, rank)
    n = 1024
    chain = np.zeros((n, n), bool)
    chain[np.arange(1, n), np.arange(n - 1)] = True
    chain |= (rng.random((n, n)) < 0.02) & np.tri(n, n, -1, dtype=bool)
    waves_case("1024-deep chain", chain, np.arange(n, dtype=np.int32),
               depth=n - 1)
    for n in (1152, 2048):
        dag = np.zeros((n, n), bool)
        dag[np.arange(1, n), np.arange(n - 1)] = True
        waves_case(f"{n}-deep chain", dag, np.arange(n, dtype=np.int32),
                   depth=n - 1)
    dag, rank = random_dags[512]
    cyc = dag.copy()
    cyc[np.argmin(rank), np.argmax(rank)] = True
    w_c, how_c = waves_run("random DAG with a cycle", torch.from_numpy(cyc).to(dev),
                           torch.from_numpy(rank).to(dev), 0)
    on_cycle = int((w_c == -1).sum())
    check(on_cycle > 0, "no row of the cycle case kept -1")
    log(f"[K2] random DAG with a cycle: B=512, {on_cycle} rows on or behind "
        f"the cycle keep -1 == plain; {how_c}")

    log(f"[phase] 4 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 4. the main path at full size
    fn, small_args = entry()
    small_out = fn(*small_args)
    small_ref = fn(*(a.cpu() for a in small_args))
    for got, want in zip(small_out, small_ref):
        check(torch.equal(got.cpu(), want), "entry() window: cuda != cpu")
    log("[main] entry() example window: cuda == cpu on all four outputs")

    t0 = time.perf_counter()
    cfks, batch = world = build_world(seed=42)
    log(f"[main] build_world {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    # raises unless the edge count == the scalar scan's
    win = bench.default_window(world, dev)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ck.KERNELS}
    enc, args = win.encoder, win.args
    log(f"[main] encode, resolve_step and the scalar scan "
        f"{time.perf_counter() - t0:.1f}s: B={args[5].shape[0]} "
        f"E={args[0].shape[0]} K={args[8].shape[1]}")
    check(launches["deps_tile"] > 0 and launches["wavefront"] > 0
          and launches["succ_w"] == launches["deps_tile"],
          f"a kernel of the flush-window path was not launched, or K6 not "
          f"with each K1: {launches}")

    dep_mask, dep_count, dep_bb, waves = win.out
    n = len(batch)
    oracle = scalar_deps_oracle(cfks, batch)
    check(enc.decode_deps(dep_mask.cpu().numpy()) == oracle,
          "deps != scalar oracle")
    scalar_eps, edges = win.scalar_edges_per_sec, win.edges
    check(edges == DEFAULT_EDGES, f"edges {edges} != {DEFAULT_EDGES}")
    check(bool((waves[:n] >= 0).all()), "a txn was left without a wave")
    check(torch.equal(waves, wavefront.execution_waves(dep_bb)),
          "main-path waves != plain")
    max_wave = int(waves.max())
    _, how = waves_run("the main window", dep_bb, args[5], 1)
    log(f"[main] deps == scalar oracle; edges {edges} == scalar == "
        f"{DEFAULT_EDGES}; "
        f"in-window edges {int(dep_bb.sum())}; max wave {max_wave}; "
        f"launches {launches}; K2 with the window's ranks: {how}")

    log(f"[phase] 5 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 5. timing at the main path's shapes
    er, eer, ek, es, ekd, tr, twm, tk, touches = args
    succ = ck.successor_write_eat_cuda(er, eer, ek, es, ekd, touches.shape[1])
    err["succ_w"] = max(err["succ_w"], max_abs_err(
        succ, deps_kernel.successor_write_eat(er, eer, ek, es, ekd)))
    check(err["succ_w"] == 0, "K6 != plain at full size")
    k1_args = (touches, ek, er, eer, es, ekd, succ, tr, twm)
    m_k, c_k = ck.deps_tile_cuda(*k1_args)
    m_p, c_p = deps_kernel.deps_tile(*k1_args)
    err["deps_tile"] = max(err["deps_tile"], max_abs_err(m_k, m_p),
                           max_abs_err(c_k, c_p))
    check(err["deps_tile"] == 0, "K1 != plain at full size")
    w_k = ck.execution_waves_cuda(dep_bb, tr)
    err["wavefront"] = max(err["wavefront"],
                           max_abs_err(w_k, wavefront.execution_waves(dep_bb)))
    check(err["wavefront"] == 0, "K2 != plain at full size")

    k1_ms = median_ms(lambda: ck.deps_tile_cuda(*k1_args), reps=15,
                      per_batch=10)
    k1_pack, k1_tile = ck.deps_tile_phases(*k1_args)
    k1_pack()
    k1_pack_ms = median_ms(k1_pack, reps=15, per_batch=10)
    k1_tile_ms = median_ms(k1_tile, reps=15, per_batch=10)
    k1_plain_ms = median_ms(lambda: deps_kernel.deps_tile(*k1_args), reps=7)
    # a yardstick for K1's write stream (not its function): zeroing its
    # [B, E] output
    memset_ms = median_ms(lambda: m_k.zero_(), reps=15, per_batch=10)
    # as resolve_step calls it: with the window's ranks
    k2_ms = median_ms(lambda: ck.execution_waves_cuda(dep_bb, tr), reps=15,
                      per_batch=10)
    k2_plain_ms = median_ms(lambda: wavefront.execution_waves(dep_bb),
                            reps=7)
    # phase 3's B = 512 random DAG: rows in permuted rank order
    dag = torch.from_numpy(random_dags[512][0]).to(dev)
    dag_rank = torch.from_numpy(random_dags[512][1]).to(dev)
    k2_dag_forward_ms = median_ms(
        lambda: ck.execution_waves_cuda(dag, dag_rank), reps=15, per_batch=10)
    k2_dag_fixpoint_ms = median_ms(
        lambda: ck.execution_waves_cuda(dag), reps=15, per_batch=10)
    k6_ms = median_ms(lambda: ck.successor_write_eat_cuda(
        er, eer, ek, es, ekd, touches.shape[1]), reps=15, per_batch=10)
    k6_steps = ck.succ_w_steps(er, eer, ek, es, ekd, touches.shape[1])
    succ_plain_ms = median_ms(
        lambda: deps_kernel.successor_write_eat(er, eer, ek, es, ekd), reps=7)

    def plain_step():
        """The step in its plain versions on the card (K3's plain ms)."""
        deps_kernel.batched_active_deps(er, eer, ek, es, ekd, tr, twm,
                                        touches)
        return wavefront.execution_waves(
            deps_kernel.in_batch_graph(tr, twm, tk, touches))

    step_plain_ms = median_ms(plain_step, reps=5)
    # the step and its parts, timed by the default lane's report
    dl = bench.default_report(win)
    step_ms = dl["step_ms"]
    graph_ms = dl["profile"]["kernels"]["in_batch_graph"]["p50"] / 1e3
    log(f"[default] {json.dumps(dl)}")
    log("[time] no single PyTorch call computes K1's, K2's or K6's "
        "function, so library_ms is null for each")

    b, e, k = touches.shape[0], er.shape[0], touches.shape[1]
    # K1 moves each input once (touches B*K bytes, six int32 [E] vectors,
    # two int32 [B]) and writes the B*E mask and the int32 counts.  Its
    # function needs one test a (b, e) pair (does txn b touch e's key) and,
    # for the pairs this run's data lets through, eight more (the rank
    # compare, the witness shift and mask, the elision compare, four ands);
    # the per-entry terms are E-sized and left out
    k1_touched = int(touches[:, ek].sum(dtype=torch.int64))
    k1_bytes = b * k + 6 * 4 * e + 2 * 4 * b + b * e + 4 * b
    k1_ops = b * e + 8 * k1_touched
    # K2 reads the B*B matrix and the int32 [B] ranks once and writes int32
    # [B]; the longest path over this run's DAG needs one max a row and one
    # an edge
    k2_bytes = b * b + 4 * b + 4 * b
    k2_ops = b + int(dep_bb.sum())

    def bound(nbytes, ops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    # K6 reads five int32 [E] vectors and writes one; its function needs
    # the committed-write filter and a key compare an entry (six
    # operations), and this run's writes ordered within their keys (w log2
    # w compares for the w writes of a key)
    succ_bytes = 6 * 4 * e
    is_write = (es >= 4) & (es <= 6) & (er >= 0) \
        & (((WRITE_KIND_MASK >> ekd) & 1) == 1)
    per_key = torch.bincount(ek[is_write].long()).double()
    succ_ops = 6 * e + int((per_key * torch.log2(per_key.clamp(min=1)))
                           .ceil().sum())
    k6_bound, k6_by = bound(succ_bytes, succ_ops)
    # the step (K3): the sum of its four steps' byte bounds, each counting
    # its own inputs read once and outputs written once: succ_w as above,
    # the graph reads three int32 [B] vectors and touches and writes the
    # B*B graph
    graph_bytes = 3 * 4 * b + b * k + b * b
    step_bound = (succ_bytes + k1_bytes + graph_bytes + k2_bytes) \
        / PEAK_BYTES_PER_S * 1e3
    log(f"[time] K1 deps tile  {k1_ms:.4f} ms (plain {k1_plain_ms:.4f} ms, "
        f"bound {k1_bound:.4f} ms by {k1_by}); apart: packing pass "
        f"{k1_pack_ms:.4f} ms, tile {k1_tile_ms:.4f} ms; a memset of its "
        f"output {memset_ms:.4f} ms; {k1_bytes} bytes, {k1_ops} operations "
        f"({k1_touched} pairs whose key the txn touches)")
    log(f"[time] K2 wavefront  {k2_ms:.4f} ms (plain {k2_plain_ms:.4f} ms, "
        f"bound {k2_bound:.6f} ms by {k2_by}); phase 3's B = 512 random "
        f"DAG: forward pass with its ranks {k2_dag_forward_ms:.4f} ms, "
        f"fixpoint without them {k2_dag_fixpoint_ms:.4f} ms")
    log(f"[time] K6 succ_w  {k6_ms:.4f} ms (plain {succ_plain_ms:.4f} ms, "
        f"bound {k6_bound:.6f} ms by {k6_by}: {succ_bytes} bytes = 6 x 4 x "
        f"E, {succ_ops} operations, {int(is_write.sum())} committed writes "
        f"over {int((per_key > 0).sum())} keys, the hottest key "
        f"{int(per_key.max())}); apart: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k6_steps.items()))
    parts = {"K6 succ_w": k6_ms, "K1": k1_ms, "graph (f32 matmul)": graph_ms,
             "K2": k2_ms}
    log(f"[time] resolve_step {step_ms:.4f} ms for {edges} edges "
        f"(plain versions on the card {step_plain_ms:.4f} ms): "
        f"{edges / (step_ms / 1e3):.1f} edges/s on the card; scalar host "
        f"scan {scalar_eps:.1f} edges/s; split "
        + ", ".join(f"{k} {v:.4f} ms ({v / step_ms:.0%})"
                    for k, v in parts.items())
        + f", the parts' sum {sum(parts.values()):.4f} ms; the step's bound "
        f"{step_bound:.6f} ms by bytes (succ_w {succ_bytes}, K1 {k1_bytes}, "
        f"graph {graph_bytes}, K2 {k2_bytes} bytes)")

    log(f"[phase] 6 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 6. K4 == plain == oracle
    def keyset_vs_plain(label, tk, tr):
        got = ck.keyset_windows_cuda(tk, tr)
        want = keyset.keyset_windows(tk, tr)
        torch.cuda.synchronize()
        e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        err["keyset_windows"] = max(err["keyset_windows"], e)
        check(e == 0, f"K4 != plain on {label}")
        return got

    def keyset_case(label, tk_np, tr_np):
        tk = torch.from_numpy(tk_np).to(dev)
        tr = torch.from_numpy(tr_np).to(dev)
        edges_w, wave_w = keyset_vs_plain(label, tk, tr)
        for wi in range(tk_np.shape[0]):
            check(tpcc.window_oracle(tk_np[wi], tr_np[wi])
                  == (int(edges_w[wi]), int(wave_w[wi])),
                  f"K4 != window_oracle on {label}, window {wi}")
        log(f"[K4] {label}: W={tk_np.shape[0]} B={tk_np.shape[1]} "
            f"P={tk_np.shape[2]} edges {edges_w.tolist()[:3]} max waves "
            f"{wave_w.tolist()[:3]} == plain == oracle")

    for seed in range(3):
        # tests/test_pallas.py:116-121
        rng = np.random.default_rng(900 + seed)
        tk = np.where(rng.random((3, 128, 11)) < 0.9,
                      rng.integers(0, 60, (3, 128, 11)), -1).astype(np.int32)
        tr = np.tile(np.arange(128, dtype=np.int32), (3, 1))
        tr[1, -7:] = -1
        keyset_case(f"test_pallas inputs seed {900 + seed}", tk, tr)
    rng = np.random.default_rng(2048)
    tk = np.where(rng.random((1, 2048, 11)) < 0.9,
                  rng.integers(0, 300, (1, 2048, 11)), -1).astype(np.int32)
    tr = np.arange(2048, dtype=np.int32)[None].copy()
    tr[0, -7:] = -1
    keyset_case("B=2048 over 300 keys", tk, tr)
    rng = np.random.default_rng(1000)
    tk = np.where(rng.random((2, 1000, 11)) < 0.8,
                  rng.integers(0, 200, (2, 1000, 11)),
                  rng.integers(-3, 0, (2, 1000, 11))).astype(np.int32)
    tr = np.stack([rng.permutation(1000) for _ in range(2)]).astype(np.int32)
    tr[rng.random((2, 1000)) < 0.1] = -1
    keyset_case("B=1000, permuted ranks", tk, tr)
    for label, tk, tr in keyset_cases(full_slots=True):
        keyset_case(label, tk, tr)
    rng = np.random.default_rng(4096)
    tk = np.where(rng.random((1, 2048, 11)) < 0.9,
                  rng.integers(0, 5000, (1, 2048, 11)), -1).astype(np.int32)
    tk[0, :, 4] = 4999                                # every row's hot key
    keyset_case("hot key in all 2048 rows", tk,
                rng.permutation(2048).astype(np.int32)[None])

    log(f"[phase] 7 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 7. the TPC-C replay at full size
    lane = tpcc.prepare(device=dev)
    log(f"[tpcc] host preparation {lane.prep_seconds:.2f}s: "
        f"{len(lane.windows)} windows, buckets "
        f"{[tuple(s[2].shape) for s in lane.stacks]}")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    counts = tpcc.resolve(lane)
    torch.cuda.synchronize()
    lane_launches = {k.name: k.launches for k in ck.KERNELS}
    check(lane_launches["keyset_windows"] == len(lane.stacks) == 2,
          f"K4 not launched once per K bucket on the lane: {lane_launches}")
    want = {"windows": TPCC_WINDOWS, "edges": TPCC_EDGES,
            "edges_cross_window": TPCC_CROSS,
            "edges_in_window": TPCC_IN_WINDOW, "max_wave_depth": TPCC_MAX_WAVE}
    check({k: counts[k] for k in want} == want,
          f"lane counts {counts} != bench_tpcc's {want}")
    lane_out = []
    for prevs, ranks, keyss in lane.stacks:
        lane_out.append(keyset_vs_plain(f"lane bucket {tuple(keyss.shape)}",
                                        keyss, ranks))
    for wi in (0, 244, 488):
        _, rank, keys = lane.windows[wi]
        e_k, w_k = ck.keyset_windows_cuda(
            torch.from_numpy(keys[None]).to(dev),
            torch.from_numpy(rank[None]).to(dev))
        check(tpcc.window_oracle(keys, rank) == (int(e_k[0]), int(w_k[0])),
              f"K4 != window_oracle on lane window {wi}")
    log(f"[tpcc] {counts}; launches {lane_launches}; K4 == plain on every "
        f"bucket; window_oracle == K4 on windows 0, 244, 488")

    log(f"[phase] 8 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 8. timing of the lane
    def k4_pass():
        for _, ranks, keyss in lane.stacks:
            ck.keyset_windows_cuda(keyss, ranks)

    def k4_plain_pass():
        for _, ranks, keyss in lane.stacks:
            keyset.keyset_windows(keyss, ranks)

    def cross_pass():
        for prevs, _, keyss in lane.stacks:
            keyset.cross_window_deps(prevs, keyss)

    k4_bucket_ms = [median_ms(lambda s=s: ck.keyset_windows_cuda(s[2], s[1]),
                              reps=7) for s in lane.stacks]
    k4_ms = median_ms(k4_pass, reps=7)
    k4_plain_ms = median_ms(k4_plain_pass, reps=3)
    cross_ms = median_ms(cross_pass, reps=7)
    lane_ms = tpcc.resolve_ms(lane)
    # the stacks' copy onto the card, from pageable host memory as prepare
    # makes it (part of the host preparation seconds)
    host_stacks = [tuple(t.cpu() for t in s) for s in lane.stacks]
    h2d_ms = median_ms(lambda: [t.to(dev) for s in host_stacks for t in s],
                       reps=3)
    # K4 reads keys and ranks once and writes two int32 a window.  Its
    # function needs no more operations than a key-to-rows scan does, which
    # are counted for this run's data: one for each valid key slot of a valid
    # row (bucket it by key), one for each pair of rows that share a key (the
    # pair's edge), and one for each edge and each row (the waves, by Kahn's
    # layering).  The kernel's own work, counted by the kernel on this run
    # (the slots it sorts, the pairs it checks, its wave sweeps times the
    # slots each sweep walks), is logged beside it and is not the bound.
    # The kernel indexes only the shared keys: a key one row holds makes no
    # edge.
    k4_bytes = sum(k.numel() * 4 + r.numel() * 4 + 2 * 4 * k.shape[0]
                   for _, r, k in lane.stacks)
    k4_ops = k4_slots = k4_kept = k4_checks = k4_sweep_slots = 0
    k4_sweeps = []
    for (_, ranks, keyss), (edges_w, wave_w) in zip(lane.stacks, lane_out):
        n, b, p = keyss.shape
        held = (keyss >= 0) & (ranks >= 0)[:, :, None]
        span = int(keyss.max()) + 1
        row = torch.arange(n * b, device=dev, dtype=torch.int64)
        # distinct (row, key), then the rows of each (window, key)
        slot = torch.unique((row.reshape(n, b, 1) * span + keyss)[held])
        per_key = torch.unique(slot // (b * span) * span + slot % span,
                               return_counts=True)[1]
        k4_ops += int(held.sum()) + int((per_key * (per_key - 1) // 2).sum()) \
            + int(edges_w.sum()) + n * b
        stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        ck.keyset_windows_cuda(keyss, ranks, stats=stats)
        stats = stats.to(torch.int64).cpu()
        k4_slots += n * b * p
        k4_kept += int(stats[:, 0].sum())
        k4_checks += int(stats[:, 1].sum())
        k4_sweep_slots += int((stats[:, 2] * stats[:, 0]).sum())
        k4_sweeps += stats[:, 2].tolist()
    k4_bound, k4_by = bound(k4_bytes, k4_ops)
    log(f"[time] K4 keyset windows {k4_ms:.4f} ms over both buckets, "
        + ", ".join(f"{ms:.4f} ms at K = {s[0].shape[1]} ({s[2].shape[0]} "
                    f"windows)" for ms, s in zip(k4_bucket_ms, lane.stacks))
        + f" (plain {k4_plain_ms:.4f} ms, bound {k4_bound:.6f} ms by {k4_by}: "
        f"{k4_bytes} bytes, {k4_ops} operations of a key-to-rows scan)")
    log(f"[time] K4's own work: {k4_kept} slots sorted (the shared keys of "
        f"{k4_slots} key slots), {k4_checks} pair checks, {k4_sweep_slots} "
        f"sweeps x slots (sweeps a window {min(k4_sweeps)}-{max(k4_sweeps)}, "
        f"median {statistics.median(k4_sweeps)})")
    log(f"[time] lane: cross_window_deps {cross_ms:.4f} ms, "
        f"tpcc_neworder_resolve_ms {lane_ms:.4f}, "
        f"{lane.txns / (lane_ms / 1e3):.1f} txns/s; host preparation "
        f"{lane.prep_seconds:.2f} s, of which host-to-device {h2d_ms:.4f} ms; "
        f"no single torch call computes K4, so its library_ms is null")

    # K4's large-window kernel on the same replay cut into windows of 4096
    lane4k = tpcc.prepare(window=4096, device=dev)
    for _, ranks, keyss in lane4k.stacks:
        check(not ck.keyset_windows_in_smem(keyss.shape[1], keyss.shape[2]),
              "the 4096-row windows took K4's shared-memory kernel")
        keyset_vs_plain(f"4096-row lane bucket {tuple(keyss.shape)}", keyss,
                        ranks)
    n4k = len(lane4k.windows)
    for wi in (0, n4k // 2, n4k - 1):
        _, rank, keys = lane4k.windows[wi]
        e_k, w_k = ck.keyset_windows_cuda(
            torch.from_numpy(keys[None]).to(dev),
            torch.from_numpy(rank[None]).to(dev))
        check(tpcc.window_oracle(keys, rank) == (int(e_k[0]), int(w_k[0])),
              f"K4 != window_oracle on 4096-row lane window {wi}")
    k4_4k_ms = median_ms(
        lambda: [ck.keyset_windows_cuda(k, r) for _, r, k in lane4k.stacks],
        reps=5)
    log(f"[time] K4 large-window kernel over the replay in {n4k} windows of "
        f"4096 (P = 11), buckets {[tuple(s[2].shape) for s in lane4k.stacks]}: "
        f"{k4_4k_ms:.4f} ms; == plain on every window, window_oracle on "
        f"windows 0, {n4k // 2}, {n4k - 1}")

    log(f"[phase] 9 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 9. the recovery window
    t0 = time.perf_counter()
    rec_cfks, rec_probes = recovery_world()
    rec_enc = RecoveryEncoder(rec_cfks, rec_probes)
    rec_args = rec_enc.tensors(dev)
    log(f"[recovery] recovery_world + encode {time.perf_counter() - t0:.1f}s: "
        f"{len(rec_probes)} probes, E={rec_enc.entry_rank.shape[0]} "
        f"R={rec_enc.rank_count} missing[] codes "
        f"{rec_enc.missing_code.shape[0] - 1} B={rec_enc.probe_rank.shape[0]} "
        f"K={rec_enc.touches.shape[1]}")
    check(len(rec_probes) == 512, "the recovery window has not 512 probes")
    rec_out = batched_recovery_scans(*rec_args)
    rec_cpu = batched_recovery_scans(*rec_enc.tensors("cpu"))
    torch.cuda.synchronize()
    names = ("rejects_a", "rejects_b", "committed_witness",
             "accepted_no_witness")
    for name, got, want in zip(names, rec_out, rec_cpu):
        check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
              f"recovery {name}: cuda != cpu")
    masks = [m.cpu().numpy() for m in rec_out]
    for i, (probe, keys) in enumerate(rec_probes):
        ra, rb, cw, anw = scalar_predicates(rec_cfks, probe, keys)
        check((bool(masks[0][i].any()), bool(masks[1][i].any())) == (ra, rb)
              and rec_enc.decode_ids(masks[2][i]) == cw
              and rec_enc.decode_ids(masks[3][i]) == anw,
              f"recovery masks != the scalar scans on probe {i}")
    rec_ms = median_ms(lambda: batched_recovery_scans(*rec_args), reps=7)
    log(f"[recovery] mask sums {[int(m.sum()) for m in masks]}, probes "
        f"rejected (a, b) {[int(m.any(axis=1).sum()) for m in masks[:2]]}; "
        f"cuda == cpu on all four masks; == the scalar scans on all "
        f"{len(rec_probes)} probes; batched_recovery_scans {rec_ms:.4f} ms "
        f"(plain torch on the card)")

    log(f"[phase] 10 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 10. K5 == plain
    def range_vs_plain(label, s, e, qs, qe):
        got = ck.range_stab_counts_cuda(s, e, qs, qe)
        want = range_kernel.range_stab_counts(s, e, qs, qe)
        torch.cuda.synchronize()
        e_ = max_abs_err(got, want)
        err["range_stab"] = max(err["range_stab"], e_)
        check(e_ == 0, f"K5 != plain on {label}")
        return got

    for label, *arrays in range_cases() + range_index_cases():
        got = range_vs_plain(label, *(torch.from_numpy(a).to(dev)
                                      for a in arrays))
        log(f"[K5] {label}: N={arrays[0].shape[0]} Q={arrays[2].shape[0]} "
            f"total {int(got.sum(dtype=torch.int64))} == plain")

    log(f"[phase] 11 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 11. the rangestress lane at full size
    rs_inputs = rangestress_inputs()
    starts, ends, q_starts, q_ends, _sample = rs_inputs
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    # raises unless the host sample check passes and the total is
    # RANGESTRESS_EDGES
    rc = bench.rangestress_counts(rs_inputs)
    torch.cuda.synchronize()
    rs_launches = {k.name: k.launches for k in ck.KERNELS}
    check(rs_launches["range_stab"] == 1
          and sum(rs_launches.values()) == 1,
          f"the rangestress counts were not one K5 launch: {rs_launches}")
    check(rc.edges == bench.RANGESTRESS_EDGES,
          f"rangestress total {rc.edges} != {bench.RANGESTRESS_EDGES}")
    n_iv, n_q = len(starts), len(q_starts)
    k5_counts = torch.from_numpy(rc.per_query).to(dev)
    k5_chunked = torch.cat(range_kernel.stab_counts_chunked(*rc.args))[:n_q]
    err["range_stab"] = max(err["range_stab"],
                            max_abs_err(k5_counts, k5_chunked))
    check(err["range_stab"] == 0,
          "K5 != the chunked plain version on the rangestress lane")
    check(np.array_equal(rc.per_query, range_kernel.stab_counts_sorted(
        starts, ends, q_starts, q_ends)),
          "K5 != the count by sorting on the rangestress lane")
    check(torch.equal(k5_counts,
                      range_kernel.stab_counts_by_query_index(*rc.args)),
          "K5 != stab_counts_by_query_index on the rangestress lane")
    rs = bench.rangestress_report(rc)
    k5_ms = rs["device_seconds"] * 1e3
    k5_phases = ck.range_stab_phases(*rc.args)
    k5_plain_ms = median_ms(
        lambda: range_kernel.stab_counts_chunked(*rc.args), reps=3)
    s_, e_, qs_, qe_ = rc.args

    def sort_and_search():
        s_sorted, e_sorted = torch.sort(s_).values, torch.sort(e_).values
        return (torch.searchsorted(s_sorted, qe_),
                torch.searchsorted(e_sorted, qs_, right=True))

    yard_ms = median_ms(sort_and_search, reps=15, per_batch=10)
    # K5 reads each interval and query bound once (int32) and writes int32
    # counts.  Its function needs far fewer operations than the 3 a pair
    # (two compares, an add) of testing every pair.  Two known methods, the
    # smaller counted: sorting the intervals (two sorts of the N bounds, N *
    # ceil(log2 N) compares each, then two binary searches and two
    # subtractions a query), or indexing the queries (a sort of each query
    # tile, T * ceil(log2 T) compares a bound, then two binary searches of
    # ceil(log2 T) steps an interval a tile).  Either must still test the
    # pairs that F = #{s < qe} - #{e <= qs} miscounts, at 3 operations
    # each: the intervals with s >= e against the queries with qs <= qe,
    # and every interval against the inverted queries (none in this run).
    lg_n = max(1, (n_iv - 1).bit_length())
    tile = ck.range_stab_tile(n_q)
    tiles = -(-n_q // tile)
    lg_t = max(1, (tile - 1).bit_length())
    n_bad = int((s_ >= e_).sum())
    q_inv = int((qs_ > qe_).sum())
    corr_pairs = n_bad * (n_q - q_inv) + n_iv * q_inv
    k5_bytes = 4 * 2 * n_iv + 4 * 2 * n_q + 4 * n_q
    by_sorting = 2 * n_iv * lg_n + 2 * n_q * (lg_n + 1)
    by_index = 2 * n_q * lg_t + tiles * 2 * n_iv * lg_t
    k5_ops = min(by_sorting, by_index) + 3 * corr_pairs
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    k5_brute_ops = 3 * n_iv * n_q
    log(f"[rangestress] {json.dumps(rs)}")
    log(f"[rangestress] launches {rs_launches}; total {rc.edges} == "
        f"{bench.RANGESTRESS_EDGES}; K5 == the chunked plain version == the "
        f"count by sorting == stab_counts_by_query_index on all {n_q} "
        f"queries (per query "
        f"{int(rc.per_query.min())}-{int(rc.per_query.max())})")
    log(f"[time] K5 range stab {k5_ms:.4f} ms (chunked plain "
        f"{k5_plain_ms:.4f} ms, bound {k5_bound:.6f} ms by {k5_by}: "
        f"{k5_bytes} bytes, {k5_ops} operations, the smaller of indexing "
        f"the queries ({by_index}: {tiles} tile(s) of {tile}) and sorting "
        f"the intervals ({by_sorting}), {corr_pairs} pairs to correct: "
        f"{n_bad} intervals with s >= e, {q_inv} inverted queries); apart: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k5_phases.items())
        + f"; testing every pair, 3 operations for each of the "
        f"{n_iv * n_q} pairs, would take "
        f"{k5_brute_ops / PEAK_INT32_OPS_PER_S * 1e3:.4f} ms at the int32 "
        f"rate")
    log(f"[time] yardstick, a composition of library calls: torch.sort of "
        f"the starts and of the ends and two torch.searchsorted, "
        f"{yard_ms:.4f} ms; no single torch call computes K5's function, so "
        f"its library_ms is null")

    # K5's fixed cost (the lane's first 10^4 intervals) and three stress
    # inputs: one hot bin, the store's pads, every query inverted
    hot_s = torch.full_like(s_, 500_000_000)
    pad = torch.zeros(127, dtype=torch.int32, device=dev)
    stress = {
        "the lane's first 10^4 intervals": (s_[:10_000], e_[:10_000], qs_,
                                            qe_),
        "10^6 copies of one interval [5e8, 5.004e8) (one hot bin)":
            (hot_s, hot_s + 400_000, qs_, qe_),
        "127 [0, 0) intervals and 127 [0, 0) queries added":
            tuple(torch.cat([a, pad]) for a in rc.args),
        "every query inverted (qs and qe swapped)": (s_, e_, qe_, qs_),
    }
    for label, args in stress.items():
        got = ck.range_stab_counts_cuda(*args)
        check(torch.equal(got, range_kernel.stab_counts_by_query_index(*args))
              and torch.equal(got, torch.cat(range_kernel.stab_counts_chunked(
                  *args))[:args[2].shape[0]]),
              f"K5 != the plain versions on the stress input {label}")
        # the pairwise pass over 10^10 pairs takes ms, not us: fewer reps
        reps, per_batch = (3, 1) if "inverted" in label else (15, 10)
        ms = median_ms(lambda: ck.range_stab_counts_cuda(*args), reps=reps,
                       per_batch=per_batch)
        apart = ck.range_stab_phases(*args, reps=reps, per_batch=per_batch)
        log(f"[time] K5 on {label}: N={args[0].shape[0]} "
            f"Q={args[2].shape[0]} total {int(got.sum(dtype=torch.int64))} "
            f"== both plain versions; {ms:.4f} ms; apart: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in apart.items()))

    log(f"[phase] 12 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 12. the sharded step on the build_world window
    cfks, batch = world
    n = len(batch)
    n_shards = 8
    t0 = time.perf_counter()
    sh_enc = ShardedEncoder(cfks, batch, n_shards)
    sh_args = window_to_tensors(sh_enc.args(), device=dev)
    flat_args = win.args  # phase 4's arrays
    e_flat, e_shard = flat_args[0].shape[0], sh_args[0].shape[1]
    pad_factor = n_shards * e_shard / e_flat
    log(f"[sharded] ShardedEncoder {time.perf_counter() - t0:.1f}s: "
        f"S={n_shards} Ks={sh_enc.ks} E_shard={e_shard} "
        f"B={sh_args[5].shape[0]}; entries a shard "
        f"{[len(es) for es in sh_enc.entries_per]}; padding factor "
        f"S*E_shard/E = {n_shards} * {e_shard} / {e_flat} = {pad_factor:.4f}")
    step8 = make_sharded_step(n_shards)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    sh_mask, sh_count, sh_bb, sh_waves = step8(*sh_args)
    torch.cuda.synchronize()
    sh_launches = {k.name: k.launches for k in ck.KERNELS}
    check(sh_launches == {"deps_tile": 1, "wavefront": 1,
                          "keyset_windows": 0, "range_stab": 0, "succ_w": 1},
          f"the sharded step was not one K6, one K1 and one K2 launch: "
          f"{sh_launches}")
    check(sh_enc.decode_deps(sh_mask.cpu().numpy()) == oracle,
          "sharded deps != scalar oracle")
    sh_edges = int(sh_count.sum())
    check(sh_edges == DEFAULT_EDGES,
          f"sharded edges {sh_edges} != {DEFAULT_EDGES}")
    check(torch.equal(sh_bb[:n, :n], dep_bb[:n, :n])
          and torch.equal(sh_waves[:n], waves[:n]),
          "sharded graph or waves != resolve_step's")
    er_s, eer_s, ek_s, es_s, ekd_s, tr_s, twm_s, _, touches_s = sh_args
    succ_s = ck.successor_write_eat_cuda(er_s, eer_s, ek_s, es_s, ekd_s,
                                         sh_enc.ks)
    err["succ_w"] = max(err["succ_w"], max_abs_err(
        succ_s, deps_kernel.sharded_successor_write_eat(
            er_s, eer_s, ek_s, es_s, ekd_s, sh_enc.ks)))
    check(err["succ_w"] == 0, "stacked K6 != the plain sharded succ_w")
    k1s_args = {}
    for cut in (0, 8):
        k1s_args[cut] = (touches_s,) + tuple(
            a[:, :e_shard - cut].contiguous()
            for a in (ek_s, er_s, eer_s, es_s, ekd_s, succ_s)) \
            + (tr_s, twm_s)
        m_k, c_k = ck.deps_tile_cuda(*k1s_args[cut])
        m_p, c_p = deps_kernel.sharded_deps_tile(*k1s_args[cut])
        err["deps_tile"] = max(err["deps_tile"], max_abs_err(m_k, m_p),
                               max_abs_err(c_k, c_p))
        check(err["deps_tile"] == 0,
              f"stacked K1 != its per-shard plain loop, E_shard cut by {cut}")
    s1_args = tuple(a[None] for a in flat_args[:5]) + flat_args[5:]
    s1_out = make_sharded_step(1)(*s1_args)
    check(torch.equal(s1_out[0][0], dep_mask)
          and all(torch.equal(a, b) for a, b in zip(s1_out[1:], win.out[1:])),
          "the sharded step at S = 1 != resolve_step")
    log(f"[sharded] launches {sh_launches}; deps == scalar oracle; edges "
        f"{sh_edges} == {DEFAULT_EDGES}; graph and waves == resolve_step's; "
        f"stacked K1 == its per-shard plain loop at E_shard {e_shard} "
        f"({e_shard % 16} mod 16) and {e_shard - 8} ({(e_shard - 8) % 16} mod "
        f"16); stacked K6 == the plain sharded succ_w; S = 1 == "
        f"resolve_step")

    probes = [(tid, tid.kind.witnesses(), keys) for tid, keys in batch]
    t0 = time.perf_counter()
    pr_enc = ShardedEncoder.for_probes(cfks, probes, n_shards, pad=PAD)
    pr_args = window_to_tensors(pr_enc.args(), device=dev)
    pr_deps_args = pr_args[:7] + pr_args[8:]
    deps_step = make_sharded_deps_step(n_shards)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    pr_mask, pr_count = deps_step(*pr_deps_args)
    torch.cuda.synchronize()
    pr_launches = {k.name: k.launches for k in ck.KERNELS}
    check(pr_launches == {"deps_tile": 1, "wavefront": 0,
                          "keyset_windows": 0, "range_stab": 0, "succ_w": 1},
          f"the sharded deps step was not one K6 and one K1 launch: "
          f"{pr_launches}")
    flat_pr = BatchEncoder.for_probes(cfks, probes)
    flat_pr_out = resolve_step(*window_to_tensors(flat_pr.state,
                                                  flat_pr.dbatch, dev))
    check(pr_enc.decode_key_deps(pr_mask.cpu().numpy())
          == flat_pr.decode_key_deps(flat_pr_out[0].cpu().numpy()),
          "sharded probe key deps != BatchEncoder.for_probes's")
    log(f"[sharded] probes (pad {PAD}): E_shard={pr_args[0].shape[1]} "
        f"{time.perf_counter() - t0:.1f}s to encode and check; launches "
        f"{pr_launches}; {int(pr_count.sum())} probe edges; decode_key_deps "
        f"== BatchEncoder.for_probes's through resolve_step on all "
        f"{len(probes)} probes")
    t0 = time.perf_counter()
    dry = dryrun_multichip(n_shards)
    log(f"[sharded] dryrun_multichip({n_shards}) on the card, with its "
        f"protocol leg: {dry}; {time.perf_counter() - t0:.1f} s")

    # the steps one call a batch, as the default lane times resolve_step:
    # ten calls' host work would outlast the sleep that hides it
    step8_ms = median_ms(lambda: step8(*sh_args), reps=15)
    step1 = make_sharded_step(1)
    step1_ms = median_ms(lambda: step1(*s1_args), reps=15)
    flat_step_ms = median_ms(lambda: resolve_step(*flat_args), reps=15)
    k1s_ms = {cut: median_ms(lambda a=a: ck.deps_tile_cuda(*a), reps=15,
                             per_batch=10) for cut, a in k1s_args.items()}
    k1s_memset_ms = median_ms(lambda: sh_mask.zero_(), reps=15, per_batch=10)
    k6s_ms = median_ms(lambda: ck.successor_write_eat_cuda(
        er_s, eer_s, ek_s, es_s, ekd_s, sh_enc.ks), reps=15, per_batch=10)
    k6s_plain_ms = median_ms(lambda: deps_kernel.sharded_successor_write_eat(
        er_s, eer_s, ek_s, es_s, ekd_s, sh_enc.ks), reps=7)
    deps_step_ms = median_ms(lambda: deps_step(*pr_deps_args), reps=15)
    # K1 on the stack moves each input once (touches B*S*Ks bytes, six int32
    # [S, E_shard] arrays, two int32 [B]) and writes the S*B*E_shard mask and
    # the int32 counts
    b_s, k_s = touches_s.shape

    def k1s_bytes(e):
        return b_s * k_s + 6 * 4 * n_shards * e + 2 * 4 * b_s \
            + n_shards * b_s * e + 4 * b_s

    k1s_bound = {cut: k1s_bytes(e_shard - cut) / PEAK_BYTES_PER_S * 1e3
                 for cut in k1s_args}
    log(f"[time] sharded step S = {n_shards} {step8_ms:.4f} ms, S = 1 "
        f"{step1_ms:.4f} ms, resolve_step {flat_step_ms:.4f} ms (the same "
        f"window, one call); the deps step on the probes "
        f"{deps_step_ms:.4f} ms")
    log(f"[time] K1 stacked S = {n_shards}: "
        + ", ".join(f"E_shard {e_shard - cut} ({(e_shard - cut) % 16} mod 16) "
                    f"{k1s_ms[cut]:.4f} ms, byte bound "
                    f"{k1s_bound[cut]:.4f} ms ({k1s_bytes(e_shard - cut)} "
                    f"bytes, of which the mask "
                    f"{n_shards * b_s * (e_shard - cut)})"
                    for cut in k1s_args)
        + f"; a memset of the [S, B, E_shard] mask {k1s_memset_ms:.4f} ms; "
        f"flat K1 {k1_ms:.4f} ms; padding factor {pad_factor:.4f}")
    log(f"[time] K6 stacked S = {n_shards}, E_shard {e_shard}: "
        f"{k6s_ms:.4f} ms (plain {k6s_plain_ms:.4f} ms, byte bound "
        f"{6 * 4 * n_shards * e_shard / PEAK_BYTES_PER_S * 1e3:.6f} ms); "
        f"flat K6 {k6_ms:.4f} ms")

    log(f"[phase] 13 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 13. the protocol store tier
    card = card_name_and_power_limit()
    from accord_tpu_torch.host.tcp import native_tiers
    tiers = native_tiers()
    check(tiers == NATIVE, f"host tiers {tiers}")
    tier = "host tier " + ", ".join(f"{k} {v}" for k, v in tiers.items())
    sb = StoreBench(n_history=STORE_HISTORY, device=dev, n_shards=n_shards)
    n_hist = len(sb.plan[1])
    log(f"[store] {card}: history of {STORE_HISTORY} txns in {n_hist} "
        f"windows of {sb.window} (default_store_plan: 1024 keys, Zipf "
        f"0.99, seed 42), flat and mesh (S = {n_shards}) stores in lockstep, "
        f"verify on for the last {sb.VERIFY_LAST}")

    def hist_progress(w, seconds):
        if w % 8 == 7:
            log(f"[store] history window {w + 1}/{n_hist}: {seconds:.1f} s, "
                f"E {sb.entries()}")

    hist_s = sb.load_history(hist_progress)
    e_store = sb.entries()
    hc = device_counters(sb.flat.store)
    log(f"[store] {card}, {tier}: history loaded in {hist_s:.1f} s; "
        f"E = {e_store}; "
        f"the flat store flushed {hc['device_flush_windows']} windows, "
        f"{hc['device_batches']} K1 batches of {hc['device_batched_probes']} "
        f"probes, hits {hc['device_hits']} misses {hc['device_misses']} "
        f"(no_probe {hc['miss_no_probe']}, version {hc['miss_version']}, "
        f"key_cover {hc['miss_key_cover']}), waves planned "
        f"{hc['device_wave_planned']} in {hc['device_wave_batches']} "
        f"windows, executed {hc['device_wave_executed']}")

    # the PreAccept window's probes, encoded as the flat store will encode
    # them: K1 and the mask's copy to the host timed alone (not counted)
    pa_txns = [sb.flat._txn(op[1]) for op in sb.windows["preaccept"]]
    pa_probes = [(st.txn_id, st.txn_id.kind.witnesses(), list(st.txn.keys))
                 for st in pa_txns]
    pa_cfks, _, _ = sb.flat.store._probe_snapshots(pa_probes)
    pa_enc = BatchEncoder.for_probes(pa_cfks, pa_probes)
    pa_args = window_to_tensors(pa_enc.state, pa_enc.dbatch, dev)
    pa_k1 = (*pa_args[:7], pa_args[8])
    pa_mask = ck.batched_active_deps_cuda(*pa_k1)[0]
    pa_k1_ms = median_ms(lambda: ck.batched_active_deps_cuda(*pa_k1), 15)

    def host_copy_ms(t, reps=7):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pa_copy_ms = host_copy_ms(pa_mask)
    full_copy_ms = host_copy_ms(win.out[0])
    log(f"[store] {card}: the PreAccept window's [B, E] = "
        f"{list(pa_mask.shape)} mask ({pa_mask.numel()} bytes): K1 with "
        f"succ_w {pa_k1_ms:.4f} ms (CUDA events), its copy to the host "
        f"{pa_copy_ms:.4f} ms; the build_world window's "
        f"{list(win.out[0].shape)} mask ({win.out[0].numel()} bytes) "
        f"copied to the host {full_copy_ms:.4f} ms (wall clock, median "
        f"of 7)")

    def store_log(w, extra=""):
        c = w.counters
        serve = w.wall_ms - sum(w.laps.values())
        log(f"[store] {card}, {tier}: {w.name} window, {len(w.results)} "
            f"ops: "
            f"{w.wall_ms:.1f} ms submit to drain; laps "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in w.laps.items())
            + f"; the rest (serving the ops) {serve:.1f} ms; hits "
            f"{c['device_hits']} misses {c['device_misses']} (no_probe "
            f"{c['miss_no_probe']}, version {c['miss_version']}, key_cover "
            f"{c['miss_key_cover']}); launches {w.launches}{extra}")

    def outcomes(w):
        return sorted({r[:2] for r in w.results})

    def only(w, **want):
        return {k: v for k, v in w.launches.items() if v} == want

    pa = sb.run("preaccept")
    store_log(pa)
    check(outcomes(pa) == [("preaccept", "SUCCESS")],
          f"PreAccept window outcomes {outcomes(pa)}")
    check(only(pa, deps_tile=1, succ_w=1),
          f"PreAccept window launches {pa.launches}")
    # the version gate serves exactly the window's first-touch preaccepts
    # (tests/test_torch_store.py holds the JAX store to the same split)
    pa_hits = first_touch_preaccepts(sb.plan, sb.windows["preaccept"])
    check((pa.counters["device_hits"], pa.counters["miss_version"],
           pa.counters["device_misses"])
          == (pa_hits, len(pa.results) - pa_hits, len(pa.results) - pa_hits),
          f"PreAccept window hits/misses {pa.counters}, want {pa_hits} "
          f"first-touch hits")
    pa_mesh = sb.run("preaccept", sb.mesh)
    store_log(pa_mesh, f"; the mesh store, S = {n_shards}")
    check(pa_mesh.results == pa.results,
          "the mesh store's PreAccept window != the flat store's")
    check(only(pa_mesh, deps_tile=1, succ_w=1),
          f"mesh PreAccept window launches {pa_mesh.launches}")
    check(pa_mesh.counters == pa.counters,
          f"mesh counters {pa_mesh.counters} != flat {pa.counters}")

    rec = sb.run("recovery")
    store_log(rec, f"; recovery hits {rec.counters['device_recovery_hits']}"
              f" misses {rec.counters['device_recovery_misses']}")
    check(outcomes(rec) == [("recover", "SUCCESS")],
          f"recovery window outcomes {outcomes(rec)}")
    check(rec.counters["device_recovery_hits"] > 0
          and rec.counters["device_recovery_misses"] == 0,
          f"recovery window {rec.counters}")
    check(only(rec, deps_tile=1, succ_w=1),
          f"recovery window launches {rec.launches}")

    com = sb.run("commit")
    store_log(com)
    check(outcomes(com) == [("commit", "SUCCESS")],
          f"commit window outcomes {outcomes(com)}")
    app = sb.run("apply")
    store_log(app, f"; waves planned {app.counters['device_wave_planned']}, "
              f"executed {app.counters['device_wave_executed']}, depth "
              f"{sb.flat.store.device_wave_max_depth}")
    check(outcomes(app) == [("apply", "SUCCESS")],
          f"Apply window outcomes {outcomes(app)}")
    check(only(app, wavefront=1), f"Apply window launches {app.launches}")
    check(app.counters["device_wave_batches"] == 1
          and app.counters["device_wave_planned"] == len(app.results)
          and app.counters["device_wave_executed"] > 0,
          f"Apply window waves {app.counters}")

    reg = sb.windows["range_register"]
    for i in range(0, len(reg), sb.window):
        rr = sb.run("range_register", ops=reg[i:i + sb.window])
        check(outcomes(rr) == [("preaccept", "SUCCESS")],
              f"range registration outcomes {outcomes(rr)}")
    rng_w = sb.run("range")
    store_log(rng_w, f"; {len(sb.flat.store.range_commands)} range txns "
              f"registered; range hits {rng_w.counters['device_range_hits']}"
              f" misses {rng_w.counters['device_range_misses']}, candidates "
              f"{rng_w.counters['device_range_candidates']}")
    check(outcomes(rng_w) == [("preaccept", "SUCCESS")],
          f"range window outcomes {outcomes(rng_w)}")
    check(rng_w.counters["device_range_batches"] == 1
          and rng_w.counters["device_range_hits"] > 0,
          f"range window {rng_w.counters}")
    check(only(rng_w, deps_tile=1, succ_w=1),
          f"range window launches {rng_w.launches}")
    for r in sb.runners():
        check(not r.store.device_disabled and not r.node.agent.failures,
              "a store failed or disabled its device tier")

    log(f"[phase] 14 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 14. the protocol on the card: the protocol cells' burns through
    # the port's burn CLI, the profiler sampling every flush window
    def burn_on_card(name, spec=None):
        """`spec`: (the burn's arguments, the JAX package's line), by
        default the protocol cell `name`'s."""
        argv, want = spec or PROTOCOL_BURNS[name]
        runs = []

        class Recorded(burn.BurnRun):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                runs.append(self)
                # a restarted node's killed incarnation launched kernels
                # too: kept as it dies
                self.killed = []
                kill = self.cluster.kill_node

                def recorded_kill(nid):
                    self.killed.append(self.cluster.nodes[nid])
                    kill(nid)
                self.cluster.kill_node = recorded_kill

        out = io.StringIO()
        saved = burn.BurnRun, os.environ.get("ACCORD_PROFILE")
        burn.BurnRun, os.environ["ACCORD_PROFILE"] = Recorded, "1"
        try:
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = burn.main(argv.split())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k.name: k.launches for k in ck.KERNELS}
        finally:
            burn.BurnRun = saved[0]
            if saved[1] is None:
                del os.environ["ACCORD_PROFILE"]
            else:
                os.environ["ACCORD_PROFILE"] = saved[1]
        line = out.getvalue().strip().splitlines()[-1]
        log(f"[protocol] {name}: {line}")
        check(rc == 0 and len(runs) == 1, f"{name} burn exited {rc}")
        check(line == want, f"{name} burn line != the JAX package's: {want}")
        run = runs[0]
        # every incarnation of every node
        run.built = run.killed + list(run.cluster.nodes.values())
        stores = [s for n in run.built for s in n.command_stores.all()]
        check(not any(s.device_disabled for s in stores)
              and not any(n.agent.failures for n in run.built),
              f"{name}: a store left its device tier or an agent failed")
        # every store's profiler laps, summed over the nodes' registries:
        # (count, ms) a kernel lap, and ms a stage (each lap's suffix)
        snaps = [n.obs.registry.snapshot() for n in run.built]
        laps, stages = bench.summed_profile_laps(snaps), {}
        for lap, (_count, ms) in laps.items():
            st = LAP_STAGES.get(lap.rsplit("_", 1)[-1], lap)
            stages[st] = stages.get(st, 0.0) + ms
        summed = {c: sum(getattr(s, c) for s in stores)
                  for c in ("device_batches", "device_wave_batches")}
        # the restarted nodes' live incarnations: the replayed windows
        replayed = [s for nid in run.restarted_nodes
                    for s in run.cluster.nodes[nid].command_stores.all()]
        summed["replayed_max_batch"] = max(
            (s.device_max_batch for s in replayed), default=0)
        summed["replayed_wave_batches"] = sum(
            s.device_wave_batches for s in replayed)
        log(f"[protocol] {card}, {tier}: {name} burn {wall:.1f} s wall, "
            f"{run.stats.acks} acks, {run.stats.acks / wall:.3f} acked ops "
            f"per wall second, {len(stores)} stores; launches "
            f"{ {k: v for k, v in launched.items() if v} }; laps (count, ms) "
            + ", ".join(f"{k} ({c}, {ms:.1f})"
                        for k, (c, ms) in sorted(laps.items()))
            + "; stages " + ", ".join(f"{k} {ms:.1f} ms"
                                      for k, ms in sorted(stages.items()))
            + f"; encode + device + decode "
            f"{sum(stages.get(k, 0.0) for k in ('encode', 'device', 'decode')) / 1e3:.3f} s "
            f"of {wall:.1f} s")
        return launched, laps, summed

    # a deps flush reaches K1 once (the flat store's deps_kernel lap, the
    # mesh store's sharded_kernel lap: one stacked launch, never the flat
    # one), a recovery flush runs the plain recovery scans (its
    # recovery_kernel lap), and device_batches counts both
    def flushes_reach_k1(name, launched, laps, summed, lap, waves):
        """K1 once a deps flush (`lap`, the flat or the stacked step's
        kernel lap), never the other form; with the recovery flushes they
        make device_batches; K2 once a wave batch."""
        other = "sharded_kernel" if lap == "deps_kernel" else "deps_kernel"
        k1_flushes = laps.get(lap, (0, 0))[0]
        check(launched["deps_tile"] == launched["succ_w"] == k1_flushes > 0
              and other not in laps
              and k1_flushes + laps.get("recovery_kernel", (0, 0))[0]
              == summed["device_batches"],
              f"{name} K1 launches {launched['deps_tile']}, K6 "
              f"{launched['succ_w']}, laps {laps}, "
              f"{summed}")
        check(launched["wavefront"] == summed["device_wave_batches"]
              == waves, f"{name} K2 launches {launched['wavefront']}, "
              f"{summed}")
        check(not launched["keyset_windows"] and not launched["range_stab"],
              f"{name} launches {launched}")

    flushes_reach_k1("flagship", *burn_on_card("flagship"), "deps_kernel", 6)

    log(f"[phase] 15 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 15. the real-socket host on the card
    real_socket_host(card)

    log(f"[phase] 16 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 16. the bounded-memory store and the burn's remaining arms
    paged_store_on_card(card, tier)

    # the restart arm's killed incarnation planned one wave batch before
    # it died; the replayed one another
    for name, lap, waves in (("delayed", "deps_kernel", 0),
                             ("delayed_mesh", "sharded_kernel", 0),
                             ("restart", "deps_kernel", 2),
                             ("geo", "deps_kernel", 10)):
        launched, laps, summed = burn_on_card(name)
        flushes_reach_k1(name, launched, laps, summed, lap, waves)
        if name == "restart":
            # the replayed node's window: 45 probes in one K1 launch, its
            # 16-deep wave plan in one K2 launch
            check(summed["replayed_max_batch"] >= 45
                  and summed["replayed_wave_batches"] == 1,
                  f"restart arm's replayed windows {summed}")

    log(f"[phase] 17 starts at {time.perf_counter() - t_script:.1f} s")
    # ---- 17. the lanes over node processes and shard workers
    node_process_lanes(card)

    t18 = time.perf_counter()
    log(f"[phase] 18 starts at {t18 - t_script:.1f} s")
    # ---- 18. two seeds of the hostile-seed soak, their arguments and the
    # JAX package's lines from the soak's expected-lines file
    soak_lines = load_expected(SOAK_LINES)
    for arm, seed, lap in SOAK_SEEDS:
        entry_ = soak_lines[(arm, seed)]
        launched, laps, summed = burn_on_card(
            f"{arm} seed {seed}", (entry_["args"], entry_["line"]))
        waves = int(entry_["line"].split(" wave_batches=")[1].split()[0])
        flushes_reach_k1(f"{arm} seed {seed}", launched, laps, summed, lap,
                         waves)
    log(f"[soak] {card}, {tier}: phase 18 took "
        f"{time.perf_counter() - t18:.1f} s")

    t19 = time.perf_counter()
    log(f"[phase] 19 starts at {t19 - t_script:.1f} s")
    # ---- 19. the bench's regression gate: the dry run over the committed
    # history, then the gate on the card against a scratch history
    bench_gate(card, win, dl)
    log(f"[guard] {card}: phase 19 took {time.perf_counter() - t19:.1f} s")

    t20 = time.perf_counter()
    log(f"[phase] 20 starts at {t20 - t_script:.1f} s")
    # ---- 20. the sharded step over a list of cards, on the one card here:
    # phase 12's window, its counts summed by NCCL over one card, against
    # the stacked step run again (phase 12's timing zeroed its mask)
    card_step = make_sharded_step(n_shards, devices=[dev])
    placed = shard_to_devices(sh_enc.args(), n_shards, [dev])
    sh_mask, sh_count, sh_bb, sh_waves = step8(*sh_args)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    l_mask, l_count, l_bb, l_waves = card_step.run(placed)
    torch.cuda.synchronize()
    l_launches = {k.name: k.launches for k in ck.KERNELS}
    check(l_launches == sh_launches,
          f"the step over [{dev}] launched {l_launches}, the stacked step "
          f"{sh_launches}")
    check(len(l_mask) == 1 and torch.equal(l_mask[0], sh_mask)
          and torch.equal(l_count, sh_count) and torch.equal(l_bb, sh_bb)
          and torch.equal(l_waves, sh_waves),
          f"the step over [{dev}] != the stacked step")
    tf_s = touches_s.to(torch.float32)
    for name, part in (("counts", sh_count), ("products", tf_s @ tf_s.T)):
        summed = all_reduce_sum([part.clone()])[0]
        check(torch.equal(summed, torch.stack([part]).sum(
            0, dtype=part.dtype)),
            f"the one-card NCCL sum of the {name} != the plain sum")
    dry_l = dryrun_sharded_step(n_shards, devices=[dev])
    card_step_ms = median_ms(lambda: card_step.run(placed), reps=15)
    log(f"[cards] the sharded step over [{dev}], S = {n_shards}: launches "
        f"{l_launches}; outputs == the stacked step's; the one-card NCCL "
        f"sums == the plain sums; dryrun_sharded_step({n_shards}) over "
        f"[{dev}]: {dry_l}; {card_step_ms:.4f} ms against the stacked "
        f"{step8_ms:.4f} ms (CUDA-event medians); phase 20 took "
        f"{time.perf_counter() - t20:.1f} s")

    kernels = [
        {"name": "deps_tile", "route": "cuda",
         "source": "accord_tpu_torch/csrc/deps_tile.cu",
         "replaces": "accord_tpu/ops/pallas_kernels.py:120",
         "launches": launches["deps_tile"], "max_abs_err": err["deps_tile"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "wavefront", "route": "cuda",
         "source": "accord_tpu_torch/csrc/wavefront.cu",
         "replaces": "accord_tpu/ops/pallas_kernels.py:57",
         "launches": launches["wavefront"], "max_abs_err": err["wavefront"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "keyset_windows", "route": "cuda",
         "source": "accord_tpu_torch/csrc/keyset_windows.cu",
         "replaces": "accord_tpu/ops/pallas_kernels.py:240",
         "launches": lane_launches["keyset_windows"],
         "max_abs_err": err["keyset_windows"],
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
        {"name": "range_stab", "route": "cuda",
         "source": "accord_tpu_torch/csrc/range_stab.cu",
         "replaces": "accord_tpu/ops/range_kernel.py:26",
         "launches": rs_launches["range_stab"],
         "max_abs_err": err["range_stab"],
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None},
        {"name": "succ_w", "route": "cuda",
         "source": "accord_tpu_torch/csrc/succ_w.cu",
         "replaces": "accord_tpu/ops/deps_kernel.py:53",
         "launches": launches["succ_w"], "max_abs_err": err["succ_w"],
         "ms": k6_ms, "plain_ms": succ_plain_ms, "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None},
    ]
    log(f"[phase] all done at {time.perf_counter() - t_script:.1f} s")
    print(card_name_and_power_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
