"""The four-card proof: the sharded step and the mesh store across the
cards of one host, with NCCL in place of the JAX package's psum.

    python3 -m accord_tpu_torch.multichip      (on a host with 4 sm_90 cards)

The JAX package runs its sharded step (``accord_tpu/ops/sharded.py``) as a
``shard_map`` over a mesh of every visible device, and its mesh store
(``accord_tpu/impl/device_store.py::MeshDeviceCommandStore``) spreads each
flush window's deps scans over that mesh.  The port's counterpart is one
process driving a list of cards (``ops/sharded.py``, ``devices=``): card d
holds a contiguous block of the key-range shards, runs K6 and one stacked
K1 launch on it, and ``torch.cuda.nccl.all_reduce`` sums the counts.  This
script holds that form to the stacked one and to the JAX package's
recorded answers on the first four cards; any failure raises and exits
non-zero, and with fewer than four sm_90 cards it exits 2 before any work.

 0. every card's name and power limit (nvidia-smi); the kernels built; the
    first NCCL all-reduce over the four cards (it builds their
    communicators) and the second (``torch.cuda.nccl`` keeps them), wall
    ms; ``workload.warm_flush_path`` on the cards;
 a. the main path's window at full width (``workload.build_world()``: B =
    512, E = 128,768, K = 1,024) in 4 shards (one a card, the JAX layout)
    and in 8 (two a card): with the launch counts zeroed just before the
    step and read just after, one K6 and one K1 launch on each card and
    one K2 launch on card 0; the decoded deps == the scalar oracle
    (1,152,177 edges), the counts == the mask's sums, graph and waves ==
    ``resolve_step``'s on one card, every output == the stacked step's on
    cuda:0, and NCCL's sums of the cards' counts and key-sharing products
    == their plain sums.  CUDA-event medians of the step over the cards
    beside the stacked step on cuda:0, reported, not bound;
 b. ``entry.dryrun_multichip(8, devices=the four cards)`` with its
    protocol leg (every store spans the four cards);
 c. the ``mesh`` and ``delayed_mesh`` protocol cells
    (``workload.PROTOCOL_BURNS``) through the burn CLI with ``--cards 4``
    and ``ACCORD_PROFILE=1``: each line == the JAX package's; on each card
    K1's and K6's launches == the ``sharded_kernel`` laps (one stacked K1
    a card a deps flush), K2's on card 0 == the wave batches;
 d. the store: ``bench.StoreBench``'s 4,096-txn ``default_store_plan``
    history through a flat store and a mesh store over the four cards in
    lockstep; the PreAccept window's results and ``device_*`` counters in
    the mesh store == the flat store's, one K6 and one K1 launch on each
    card, and at the end the two stores' states ==;
 e. one JSON line of what it found.

The tolerance everywhere is exact equality: every output is integer or
bool.  It is no phase of ``chip_smoke.py``, which runs on one card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from accord_tpu_torch import bench
from accord_tpu_torch.entry import dryrun_multichip
from accord_tpu_torch.ops import cuda_kernels as ck
from accord_tpu_torch.ops.deps_kernel import conflict_edges
from accord_tpu_torch.ops.encode import (PAD, scalar_deps_oracle,
                                         window_to_tensors)
from accord_tpu_torch.ops.sharded import (ShardedEncoder, all_reduce_sum,
                                          dep_mask_to_host, make_sharded_step,
                                          shard_to_devices)
from accord_tpu_torch.sim import burn
from accord_tpu_torch.utils.backend import resolve_devices
from accord_tpu_torch.utils.timing import median_ms, median_ms_cards
from accord_tpu_torch.workload import (PROTOCOL_BURNS, build_world,
                                       device_counters, store_state,
                                       warm_flush_path)

N_CARDS = 4
# bench.bench_default()'s world: the scalar scan's edge count
DEFAULT_EDGES = 1_152_177
# phase 13 of chip_smoke.py: the store history (txns)
STORE_HISTORY = 4_096
REPS = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cards_names_and_power_limits() -> list:
    """Every card's name and power limit as nvidia-smi reports them, one
    string a card in index order."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def the_cards() -> list:
    """The first N_CARDS visible sm_90 cards; raises with fewer."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    cards = resolve_devices("all")
    if len(cards) < N_CARDS:
        raise RuntimeError(f"the multichip proof needs {N_CARDS} sm_90 "
                           f"cards, {len(cards)} visible")
    return cards[:N_CARDS]


def sync(cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def launches_by_card() -> dict:
    """{kernel: {card index: launches}} since the last reset."""
    return {k.name: dict(sorted(k.by_device.items())) for k in ck.KERNELS
            if k.by_device}


def nccl_first_and_second(cards) -> tuple:
    """Wall ms of the first all-reduce over `cards` in this process (it
    builds their communicators) and of the second."""
    ms = []
    for _ in range(2):
        ts = [torch.zeros(1024, dtype=torch.int32, device=c) for c in cards]
        sync(cards)
        t0 = time.perf_counter()
        all_reduce_sum(ts)
        sync(cards)
        ms.append((time.perf_counter() - t0) * 1e3)
    return tuple(ms)


def window_phase(cards, world, flat_out) -> dict:
    """(a): the build_world window over the cards at 4 and 8 shards."""
    cfks, batch = world
    n = len(batch)
    oracle = scalar_deps_oracle(cfks, batch)
    _, _, dep_bb1, waves1 = flat_out
    dev0 = cards[0]
    found = {}
    for n_shards in (N_CARDS, 2 * N_CARDS):
        t0 = time.perf_counter()
        enc = ShardedEncoder(cfks, batch, n_shards)
        args = enc.args()
        placed = shard_to_devices(args, n_shards, cards)
        stacked_args = window_to_tensors(args, device=dev0)
        enc_s = time.perf_counter() - t0
        step = make_sharded_step(n_shards, devices=cards)
        stacked = make_sharded_step(n_shards)
        want = stacked(*stacked_args)
        sync(cards)
        ck.reset_launch_counts()
        got = step.run(placed)
        sync(cards)
        launched = launches_by_card()
        every = {i: 1 for i in range(len(cards))}
        check(launched == {"succ_w": every, "deps_tile": every,
                           "wavefront": {0: 1}},
              f"S = {n_shards}: launches by card {launched}, want one K6 "
              f"and one K1 a card and one K2 on card 0")
        masks, dep_count, dep_bb, waves = got
        check([m.device for m in masks] == cards
              and all(m.shape[0] == n_shards // len(cards) for m in masks),
              f"S = {n_shards}: mask planes "
              f"{[(str(m.device), tuple(m.shape)) for m in masks]}")
        mask = dep_mask_to_host(masks)
        check(enc.decode_deps(mask) == oracle,
              f"S = {n_shards}: deps over the cards != the scalar oracle")
        edges = int(dep_count.sum())
        check(edges == DEFAULT_EDGES,
              f"S = {n_shards}: edges {edges} != {DEFAULT_EDGES}")
        check(np.array_equal(dep_count.cpu().numpy(),
                             mask.sum(axis=(0, 2), dtype=np.int32)),
              f"S = {n_shards}: counts != the mask's sums")
        check(torch.equal(dep_bb[:n, :n], dep_bb1[:n, :n])
              and torch.equal(waves[:n], waves1[:n]),
              f"S = {n_shards}: graph or waves != resolve_step's")
        check(torch.equal(torch.cat([m.to(dev0) for m in masks]), want[0])
              and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
              f"S = {n_shards}: outputs over the cards != the stacked "
              f"step's on {dev0}")
        # NCCL's sums against the plain sums of the same per-card parts
        counts, products = [], []
        for a in placed:
            counts.append(ck.batched_active_deps_cuda(
                *a[:5], a[5], a[6], a[8])[1])
            tf = a[8].to(torch.float32)
            products.append(tf @ tf.T)
        for name, parts in (("counts", counts), ("products", products)):
            plain = torch.stack([p.cpu() for p in parts]).sum(
                0, dtype=parts[0].dtype)
            summed = all_reduce_sum(parts)
            check(all(torch.equal(s.cpu(), plain) for s in summed),
                  f"S = {n_shards}: NCCL's sum of the {name} != the plain "
                  f"sum")
        cards_ms = median_ms_cards(lambda: step.run(placed), cards, REPS)
        stacked_ms = median_ms(lambda: stacked(*stacked_args), REPS)
        parts_ms = step_parts_ms(placed, cards, counts, products)
        found[str(n_shards)] = {
            "e_shard": int(args[0].shape[1]), "ks": enc.ks,
            "encode_and_place_s": round(enc_s, 3), "edges": edges,
            "launches_by_card": launched, "cards_step_ms": cards_ms,
            "stacked_step_ms": stacked_ms, "parts_ms": parts_ms}
        log(f"[window] S = {n_shards} over {len(cards)} cards "
            f"({n_shards // len(cards)} a card), E_shard "
            f"{args[0].shape[1]}, Ks {enc.ks}: deps == the scalar oracle, "
            f"edges {edges} == {DEFAULT_EDGES}, counts == the mask's sums, "
            f"graph and waves == resolve_step's, outputs == the stacked "
            f"step's on {dev0}, NCCL sums == the plain sums; launches by "
            f"card {launched}; step over the cards {cards_ms:.4f} ms "
            f"(its parts apart: {parts_ms}), stacked on {dev0} "
            f"{stacked_ms:.4f} ms (CUDA-event medians of {REPS}); encoded "
            f"and placed in {enc_s:.1f} s")
    return found


def step_parts_ms(placed, cards, counts, products) -> dict:
    """The step over the cards in its three parts, each timed alone on the
    same inputs (CUDA-event medians): every card's K6, K1 and key-sharing
    product, launched card after card; the two NCCL all-reduces (of the
    counts and of the products); the graph's masks and K2 on card 0."""
    def per_card():
        for a in placed:
            ck.batched_active_deps_cuda(*a[:5], a[5], a[6], a[8])
            tf = a[8].to(torch.float32)
            tf @ tf.T

    def reduce():
        all_reduce_sum(counts)
        all_reduce_sum(products)

    tr, twm, tk = placed[0][5:8]
    shared = products[0]
    ms = {"per_card": median_ms_cards(per_card, cards, REPS),
          "all_reduces": median_ms_cards(reduce, cards, REPS),
          "graph_and_k2": median_ms(lambda: ck.execution_waves_cuda(
              conflict_edges(shared > 0, tr, twm, tk), tr), REPS)}
    return ms


def burn_over_cards(name: str, cards) -> dict:
    """(c): one protocol cell through the burn CLI with --cards."""
    argv, want = PROTOCOL_BURNS[name]
    runs = []

    class Recorded(burn.BurnRun):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    out = io.StringIO()
    saved = burn.BurnRun, os.environ.get("ACCORD_PROFILE")
    burn.BurnRun, os.environ["ACCORD_PROFILE"] = Recorded, "1"
    try:
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = burn.main(argv.split() + ["--cards", str(len(cards))])
        sync(cards)
        wall = time.perf_counter() - t0
        launched = launches_by_card()
    finally:
        burn.BurnRun = saved[0]
        if saved[1] is None:
            del os.environ["ACCORD_PROFILE"]
        else:
            os.environ["ACCORD_PROFILE"] = saved[1]
    line = out.getvalue().strip().splitlines()[-1]
    log(f"[protocol] {name} --cards {len(cards)}: {line}")
    check(rc == 0 and len(runs) == 1, f"{name} burn exited {rc}")
    check(line == want, f"{name} burn line != the JAX package's: {want}")
    nodes = list(runs[0].cluster.nodes.values())
    stores = [s for n in nodes for s in n.command_stores.all()]
    check(all(s.devices == cards for s in stores)
          and not any(s.device_disabled for s in stores)
          and not any(n.agent.failures for n in nodes),
          f"{name}: a store not over the cards, off its device tier, or an "
          f"agent failure")
    laps = bench.summed_profile_laps([n.obs.registry.snapshot()
                                      for n in nodes])
    flushes = laps.get("sharded_kernel", (0, 0.0))[0]
    waves = sum(s.device_wave_batches for s in stores)
    every = {i: flushes for i in range(len(cards))}
    check(flushes > 0 and "deps_kernel" not in laps
          and launched.get("deps_tile") == launched.get("succ_w") == every
          and launched.get("wavefront", {}) == ({0: waves} if waves else {})
          and "keyset_windows" not in launched
          and "range_stab" not in launched,
          f"{name}: launches by card {launched}, {flushes} sharded_kernel "
          f"laps, {waves} wave batches")
    lap_ms = laps["sharded_kernel"][1] / flushes
    log(f"[protocol] {name}: {wall:.1f} s wall, {flushes} deps flushes, "
        f"each one K6 and one K1 launch on each card ({launched}); the "
        f"sharded_kernel lap {lap_ms:.3f} ms a flush")
    return {"wall_s": round(wall, 1), "sharded_kernel_laps": flushes,
            "sharded_kernel_ms": lap_ms, "launches_by_card": launched}


def store_phase(cards) -> dict:
    """(d): the store history through a flat and a mesh store over the
    cards, then the PreAccept window through each."""
    n_shards = 2 * len(cards)
    sb = bench.StoreBench(n_history=STORE_HISTORY, device=cards[0],
                          n_shards=n_shards, devices=cards)
    hist_s = sb.load_history()
    flush = flush_parts_ms(sb, n_shards, cards)
    pa = sb.run("preaccept")
    pa_mesh = sb.run("preaccept", sb.mesh)
    launched = launches_by_card()
    every = {i: 1 for i in range(len(cards))}
    check(pa_mesh.results == pa.results,
          "the mesh store's PreAccept window != the flat store's")
    check(pa_mesh.counters == pa.counters,
          f"mesh counters {pa_mesh.counters} != flat {pa.counters}")
    check(launched == {"succ_w": every, "deps_tile": every},
          f"mesh PreAccept window launches by card {launched}")
    check(device_counters(sb.mesh.store) == device_counters(sb.flat.store)
          and store_state(sb.mesh.store) == store_state(sb.flat.store),
          "the mesh store's counters or state != the flat store's")
    log(f"[store] history of {STORE_HISTORY} txns in {hist_s:.1f} s, E = "
        f"{sb.entries()}; PreAccept window, {len(pa.results)} ops: flat "
        f"{pa.wall_ms:.1f} ms (laps {pa.laps}), mesh over {len(cards)} "
        f"cards, S = {2 * len(cards)}, {pa_mesh.wall_ms:.1f} ms (laps "
        f"{pa_mesh.laps}); results, counters and state ==; launches by "
        f"card {launched}; the mesh flush's device parts timed alone "
        f"{flush}")
    return {"history_s": round(hist_s, 1), "entries": sb.entries(),
            "preaccept_flat_ms": pa.wall_ms,
            "preaccept_mesh_ms": pa_mesh.wall_ms,
            "mesh_laps": pa_mesh.laps, "launches_by_card": launched,
            "mesh_flush_parts_ms": flush}


def flush_parts_ms(sb, n_shards, cards) -> dict:
    """The PreAccept window's probes, encoded as the mesh store will
    encode them, through the device parts of its flush, each timed alone
    (not counted): the copies of the window's blocks to the cards and the
    copies of the cards' planes back (wall clock, medians of 7), and the
    deps step over the cards (CUDA events)."""
    txns = [sb.mesh._txn(op[1]) for op in sb.windows["preaccept"]]
    probes = [(st.txn_id, st.txn_id.kind.witnesses(), list(st.txn.keys))
              for st in txns]
    cfks, _, _ = sb.mesh.store._probe_snapshots(probes)
    a = ShardedEncoder.for_probes(cfks, probes, n_shards, pad=PAD).args()
    args = a[:7] + a[8:]
    step = sb.mesh.store._sharded_step

    def wall_ms(fn):
        times = []
        for _ in range(7):
            sync(cards)
            t0 = time.perf_counter()
            fn()
            sync(cards)
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[3]

    placed = shard_to_devices(args, n_shards, cards)
    masks = step.run(placed)[0]
    return {"to_cards": wall_ms(lambda: shard_to_devices(args, n_shards,
                                                         cards)),
            "step": median_ms_cards(lambda: step.run(placed), cards, REPS),
            "to_host": wall_ms(lambda: dep_mask_to_host(masks)),
            "mask_bytes": sum(m.numel() for m in masks)}


def main() -> int:
    try:
        cards = the_cards()
    except RuntimeError as exc:
        print(f"multichip: {exc}", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    names = cards_names_and_power_limits()
    for i, line in enumerate(names):
        log(f"[cards] {i}: {line}")
    log(f"[cards] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"NCCL {torch.cuda.nccl.version()}; using {[str(c) for c in cards]}")
    t0 = time.perf_counter()
    seconds = ck.build()
    for k in ck.KERNELS:
        k.lib()
    log(f"[build] {seconds}; {time.perf_counter() - t0:.1f} s")
    first_ms, second_ms = nccl_first_and_second(cards)
    log(f"[nccl] the first all-reduce over {len(cards)} cards {first_ms:.1f} "
        f"ms (it builds their communicators), the second {second_ms:.3f} ms "
        f"(wall clock)")
    t0 = time.perf_counter()
    warm_flush_path(cards[0], devices=cards)
    log(f"[warm] warm_flush_path over the cards {time.perf_counter() - t0:.1f}"
        f" s")

    t0 = time.perf_counter()
    world = build_world(seed=42)
    win = bench.default_window(world, cards[0])
    log(f"[window] build_world, encode, resolve_step on {cards[0]} and the "
        f"scalar scan {time.perf_counter() - t0:.1f} s: edges {win.edges}")
    check(win.edges == DEFAULT_EDGES, f"edges {win.edges}")
    window = window_phase(cards, world, win.out)
    log(f"[phase] a done at {time.perf_counter() - t_script:.1f} s")

    t0 = time.perf_counter()
    dry = dryrun_multichip(2 * len(cards), devices=cards)
    log(f"[dryrun] dryrun_multichip({2 * len(cards)}) over the cards, with "
        f"its protocol leg: {dry}; {time.perf_counter() - t0:.1f} s")

    burns = {name: burn_over_cards(name, cards)
             for name in ("mesh", "delayed_mesh")}
    log(f"[phase] c done at {time.perf_counter() - t_script:.1f} s")
    store = store_phase(cards)
    log(f"[phase] d done at {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({
        "ok": True, "cards": names[:len(cards)],
        "nccl_first_ms": first_ms, "nccl_second_ms": second_ms,
        "window": window, "dryrun": dry, "burns": burns, "store": store,
        "seconds": round(time.perf_counter() - t_script, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
