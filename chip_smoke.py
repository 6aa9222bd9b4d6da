#!/usr/bin/env python3
"""Proof on one H100 that the port builds and resolves a full flush window,
the full TPC-C new-order replay, a recovery window and the rangestress lane
through its hand-written CUDA kernels, and serves the protocol store's
flush windows through them.

    python3 chip_smoke.py          (from the repository root, on a CUDA card)

Phases; any failure raises, exits non-zero and prints no result lines:
 1. build the four kernels from accord_tpu_torch/csrc/ (one nvcc per source,
    all started together) and print the build seconds and ptxas' report;
 2. K1, the deps tile: kernel == plain torch on the card for three seeds of
    a small random world and for a world with K > 16384 (also cut to an E
    and a B that are not multiples of 4);
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
    scan's == 1,152,177, every wave >= 0, both kernels launched, and K2
    takes its forward pass on the window;
 5. timing at the main path's shapes: each kernel's median ms (CUDA events),
    its bound, its plain version's ms, K1's two launches apart (the packing
    pass, the tile) beside a memset of its output, K2's forward pass and
    fixpoint on phase 3's B = 512 random DAG, succ_w's ms, and the default
    lane's report (bench.default_report: the step's median ms, the rate and
    the per-step profile);
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
    call launches K1 once and K2 once; the decoded deps == the scalar
    oracle, the summed counts == 1,152,177, graph and waves == phase 4's
    resolve_step; K1's stacked launch == its per-shard plain loop at full
    size (and with the shards' E cut by 8, the other 16-byte alignment of
    the planes' rows); S = 1 on phase 4's arrays == resolve_step; the deps
    step on the same window as probes (ShardedEncoder.for_probes, pad 128),
    one K1 launch and no other, decode_key_deps == BatchEncoder.for_probes's
    decode through resolve_step; entry.dryrun_multichip(8) on the card.
    Then the stacked step's median ms at S = 8 and S = 1 beside
    resolve_step's, K1's stacked ms at both alignments beside its byte
    bound and a memset of its [S, B, E] output, the deps step's ms, and
    the padding factor S*E_shard / E.
13. the protocol store tier (bench.StoreBench): the default cell's shape,
    1024 keys at Zipf(0.99), as a store history of 16,384 txns
    (workload.default_store_plan: flush windows of 512 preaccepts, with
    every txn accepted one window later in one case of 8, committed stable
    and applied two windows later) through store.execute and the local state
    machine's transitions, into a flat DeviceCommandStore and a
    MeshDeviceCommandStore at S = 8 on the card in lockstep (verify on for
    the last 8 windows). Then the measured windows, each with verify on
    (every served scan checked inline against the scalar scan), each store
    checked after every window for a disabled device tier or a failure its
    agent recorded, and the launch counts zeroed just before it and read
    just after: the PreAccept window (512 preaccepts in one flush: one K1
    launch and no other; the version gate serves exactly the window's
    first-touch preaccepts and misses the rest, as the JAX store does on the
    CPU), the same window through the mesh store (one stacked K1 launch;
    results and counters == the flat store's), a recovery window (512
    BeginRecovery probes: every recovery scan served, one K1 launch for
    their deps), a commit window and the Apply window (1536 Applies in one
    flush: one K2 launch and no other, the waves == the host oracle, every
    planned Apply executed), then 1024 range txns registered and a range
    window (448 key-domain and 64 range-domain preaccepts, the range arm
    served). It prints the history's seconds, E, and per window the wall ms
    split into the profiler's encode, kernel and decode laps and the rest,
    hits, misses and their causes; and K1 on the PreAccept window's probes
    and the copies of its mask and of phase 4's [512, 128,768] mask to the
    host, timed alone.
The tolerance everywhere is exact equality: every output is integer or bool.

Then, on lines of their own: the card's name and power limit (nvidia-smi),
the kernels JSON object, and last {"ok": true, "device": {...}}.
"""

import json
import statistics
import sys
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
# phase 13's store history (txns)
STORE_HISTORY = 16_384


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from accord_tpu_torch import bench, tpcc
    from accord_tpu_torch.bench import StoreBench
    from accord_tpu_torch.entry import dryrun_multichip, entry
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.ops import (deps_kernel, keyset, range_kernel,
                                      wavefront)
    from accord_tpu_torch.ops.encode import (PAD, BatchEncoder,
                                             scalar_deps_oracle,
                                             window_to_tensors)
    from accord_tpu_torch.ops.sharded import (ShardedEncoder,
                                              make_sharded_deps_step,
                                              make_sharded_step, resolve_step)
    from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                      batched_recovery_scans,
                                                      scalar_predicates)
    from accord_tpu_torch.utils.backend import card_name_and_power_limit
    from accord_tpu_torch.utils.random_source import RandomSource
    from accord_tpu_torch.utils.timing import median_ms
    from accord_tpu_torch.workload import (build_world, device_counters,
                                           first_touch_preaccepts,
                                           keyset_cases, random_world,
                                           range_cases, range_index_cases,
                                           rangestress_inputs, recovery_world)

    dev = torch.device("cuda", 0)
    sys.setrecursionlimit(20000)  # waves_oracle recurses along DAG chains
    err = {"deps_tile": 0, "wavefront": 0, "keyset_windows": 0,
           "range_stab": 0}

    # ---- 1. build
    t0 = time.perf_counter()
    seconds = ck.build()
    log(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in seconds.items())}; "
        f"wall {time.perf_counter() - t0:.1f}s")
    for k in ck.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {k.name}: {line.strip()}")
        k.lib()

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
    check(launches["deps_tile"] > 0 and launches["wavefront"] > 0,
          f"a kernel of the flush-window path was not launched: {launches}")

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

    # ---- 5. timing at the main path's shapes
    er, eer, ek, es, ekd, tr, twm, tk, touches = args
    succ = deps_kernel.successor_write_eat(er, eer, ek, es, ekd)
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
    # the step and its parts, timed by the default lane's report
    dl = bench.default_report(win)
    step_ms = dl["step_ms"]
    graph_ms = dl["profile"]["in_batch_graph_median_ms"]
    # the rest of the step, which runs as plain torch on the card
    succ_ms = median_ms(
        lambda: deps_kernel.successor_write_eat(er, eer, ek, es, ekd), reps=7)
    log(f"[default] {json.dumps(dl)}")
    log("[time] no single PyTorch call computes either kernel's function, "
        "so library_ms is null for both")

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
    # the step (K3): the sum of its four steps' byte bounds, each counting
    # its own inputs read once and outputs written once: succ_w reads five
    # int32 [E] vectors and writes one, the graph reads three int32 [B]
    # vectors and touches and writes the B*B graph
    succ_bytes = 6 * 4 * e
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
    log(f"[time] plain torch in the step: succ_w {succ_ms:.4f} ms, "
        f"in_batch_graph {graph_ms:.4f} ms")
    log(f"[time] resolve_step {step_ms:.4f} ms for {edges} edges: "
        f"{edges / (step_ms / 1e3):.1f} edges/s on the card; scalar host "
        f"scan {scalar_eps:.1f} edges/s; the step's bound {step_bound:.6f} "
        f"ms by bytes (succ_w {succ_bytes}, K1 {k1_bytes}, graph "
        f"{graph_bytes}, K2 {k2_bytes} bytes)")

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
                          "keyset_windows": 0, "range_stab": 0},
          f"the sharded step was not one K1 and one K2 launch: {sh_launches}")
    check(sh_enc.decode_deps(sh_mask.cpu().numpy()) == oracle,
          "sharded deps != scalar oracle")
    sh_edges = int(sh_count.sum())
    check(sh_edges == DEFAULT_EDGES,
          f"sharded edges {sh_edges} != {DEFAULT_EDGES}")
    check(torch.equal(sh_bb[:n, :n], dep_bb[:n, :n])
          and torch.equal(sh_waves[:n], waves[:n]),
          "sharded graph or waves != resolve_step's")
    er_s, eer_s, ek_s, es_s, ekd_s, tr_s, twm_s, _, touches_s = sh_args
    succ_s = deps_kernel.sharded_successor_write_eat(er_s, eer_s, ek_s, es_s,
                                                     ekd_s, sh_enc.ks)
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
        f"16); S = 1 == resolve_step")

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
                          "keyset_windows": 0, "range_stab": 0},
          f"the sharded deps step was not one K1 launch: {pr_launches}")
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
    dry = dryrun_multichip(n_shards)
    log(f"[sharded] dryrun_multichip({n_shards}) on the card: {dry}")

    # the steps one call a batch, as the default lane times resolve_step:
    # ten calls' host work would outlast the sleep that hides it
    step8_ms = median_ms(lambda: step8(*sh_args), reps=15)
    step1 = make_sharded_step(1)
    step1_ms = median_ms(lambda: step1(*s1_args), reps=15)
    flat_step_ms = median_ms(lambda: resolve_step(*flat_args), reps=15)
    k1s_ms = {cut: median_ms(lambda a=a: ck.deps_tile_cuda(*a), reps=15,
                             per_batch=10) for cut, a in k1s_args.items()}
    k1s_memset_ms = median_ms(lambda: sh_mask.zero_(), reps=15, per_batch=10)
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

    # ---- 13. the protocol store tier
    card = card_name_and_power_limit()
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
    log(f"[store] {card}: history loaded in {hist_s:.1f} s; E = {e_store}; "
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
        log(f"[store] {card}: {w.name} window, {len(w.results)} ops: "
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
    check(only(pa, deps_tile=1), f"PreAccept window launches {pa.launches}")
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
    check(only(pa_mesh, deps_tile=1),
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
    check(only(rec, deps_tile=1), f"recovery window launches {rec.launches}")

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
    check(only(rng_w, deps_tile=1), f"range window launches {rng_w.launches}")
    for r in sb.runners():
        check(not r.store.device_disabled and not r.node.agent.failures,
              "a store failed or disabled its device tier")

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
    ]
    print(card_name_and_power_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
