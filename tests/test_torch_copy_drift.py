"""Every module of the port that has a counterpart in the JAX package (or,
for the soak and the device harness, among the repository's root scripts)
is that module with the package renamed, or it says here why not.

The port keeps its own copy of each host module it needs (and of the C++
sources of its native tier); a copy that drifts
from the reference without a reason is a fault the same-seed differentials
may not reach.  The test reads both trees as text and imports neither
package.  An allow-listed module that has become identical fails too, so
the list names only the deviations that exist.
"""

from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFERENCE = REPO / "accord_tpu"
PORT = REPO / "accord_tpu_torch"

DEVIATIONS = {
    # the device tier: each JAX formulation rewritten in PyTorch, or with
    # the port's CUDA kernels behind it
    "__init__.py": "describes the port and its rules, not the JAX package",
    "ops/__init__.py": "exports the port's torch ops and CUDA wrappers",
    "ops/deps_kernel.py": "K1, succ_w and the in-window graph in torch",
    "ops/encode.py": "window_to_tensors builds torch tensors; the window's "
                     "universe, ranks and entry columns come from the native "
                     "CFK core's encode_window pass where it loads (the "
                     "Python walk is its fallback tier), the decoders read a "
                     "flat TxnId list and the key column in place of the "
                     "per-entry tuples, the rank map is built when read, and "
                     "the key universe is sorted and indexed by token (no "
                     "key_index map)",
    "native/_cfk_core.cpp": "encode_window, the device encoder's walk over "
                            "the CFKs' lists in one C++ pass, exists only in "
                            "the port",
    "ops/range_kernel.py": "range stabbing in torch, K5's plain versions",
    "ops/recovery_kernel.py": "the recovery scans in torch",
    "ops/sharded.py": "the sharded step stacked or over torch.distributed",
    "ops/wavefront.py": "the wavefront in torch, K2's plain version",
    "utils/backend.py": "device selection: the card, or the CPU if asked",
    "impl/device_store.py": "flush windows resolved by the port's kernels; "
                            "the flush, its deps and wave arms' phases, "
                            "the recovery and range arms are spans "
                            "(obs/profiler.span) tiling the laps, the "
                            "window's body is _run_window, and the store "
                            "counts its copies' bytes, encoded entries, "
                            "served deps and each plan's wave depth; no "
                            "queue-wait stamp (the waterfall is gone); "
                            "device= raises without a card; no mesh "
                            "attribute: the mesh store stacks its shards "
                            "or spreads them over the cards it is given "
                            "(devices=, NCCL in place of psum); a range bound outside int32 (the "
                            "real-socket host's span ends at 2**31) sends "
                            "every bound of the stab as its rank, where the "
                            "reference's int32 encoding overflows and the "
                            "store leaves its device tier",
    "obs/profiler.py": "laps fenced by a host copy; counts shapes, not "
                       "XLA compiles; no flush-window waterfall (its "
                       "histogram, sampled-window counter and queue-wait "
                       "stage had no reader: the laps cover its stages); "
                       "the span hook (set_tracer, span) the store and "
                       "local/ open their trace ranges through",
    "obs/__init__.py": "docstring: the profiler's span hook and the "
                       "store's span names and counters; exports "
                       "set_tracer and span",
    "local/commands.py": "the transitions, calculate_deps' scan, WaitingOn "
                         "set-up and maybe_execute open accord.op.* spans "
                         "(obs/profiler.span)",
    "local/store.py": "register's per-key index walk is the accord.op.index "
                      "span (obs/profiler.span)",
    # the burn's CLI: where the device stores run
    "sim/burn.py": "--device {cuda,cpu} passed to the store factories "
                   "(the delayed-store composition included), no platform "
                   "probe; --cards N spreads a --mesh-store's shards over "
                   "the first N cards (the JAX mesh store takes every "
                   "visible device, the port's only the cards it is "
                   "given); a comment's change-history tag dropped",
    "sim/delayed_store.py": "delayed_device_factory composes over the "
                            "port's MeshDeviceCommandStore (its shards "
                            "stacked on one device, no jax mesh to set up) "
                            "and takes device=, passed to both stores, and "
                            "devices=, the cards the mesh store spreads its "
                            "shards over (the burn's --cards)",
    # the open-loop workload package holds the port's seeded worlds too
    "workload/__init__.py": "re-exports workload/worlds.py (the port's "
                            "own module: the bench worlds, the protocol "
                            "burns, the fingerprints), so "
                            "`from accord_tpu_torch.workload import X` "
                            "reaches both; docstring: change-history tags "
                            "dropped",
    "workload/openloop.py": "run_wan_sim takes store_factory, so the WAN "
                            "lane runs on the device stores; the three TCP "
                            "runners keep every node's metrics snapshot on "
                            "the result (.snapshots; the reshard runner "
                            "takes the retiring node's just before it is "
                            "killed), so a lane shows each node process's "
                            "device counters and kernel laps; docstring: a "
                            "change-history tag dropped",
    # the real-socket host: the device stores on the card or the CPU
    "host/tcp.py": "_env_store_factory builds the port's DeviceCommandStore "
                   "on ACCORD_TCP_DEVICE (unset: the card, raising without "
                   "one) and warms the card (context, K1's and K2's "
                   "libraries, the matmul library) before the node serves, "
                   "where the reference pins a JAX platform and sets a "
                   "compile cache; a node's ready line carries its "
                   "native_tiers() and TcpClusterClient keeps the lines "
                   "(.ready), so a client sees every node's native tier; "
                   "a metrics reply carries process_evidence() (native "
                   "tiers, the collector's state, each store's class and "
                   "device, the process's kernel launches) and, under the "
                   "shard workers, each worker's last stats-frame metrics; "
                   "_warm_card runs every flush step once "
                   "(workload.warm_flush_path: CUDA loads a kernel's module "
                   "at its first launch, which held a node's loop 0.5-1 s) "
                   "and keeps its launches apart; a node process freezes "
                   "its heap and makes full collections 100x rarer once "
                   "built (hold_off_full_collections: pauses of up to 469 ms "
                   "were the overload lane's high-class p99); "
                   "comments: change-history tags dropped",
    # the shard workers: their device stores' counters, laps and launches
    # reach the node's metrics reply
    "shard/frames.py": "ShardStatsRsp carries the worker's metrics",
    "shard/worker.py": "the stats frame carries the worker's registry "
                       "snapshot and process_evidence(); the worker holds "
                       "off full collections once built, as a node "
                       "process does",
    # comments that cite the reference's change history by number say
    # what they mean instead
    "host/maelstrom.py": "a comment: a change-history tag dropped",
    "obs/report.py": "comments: change-history tags dropped",
    "obs/cpuprof.py": "docstring: change-history tags dropped",
    "obs/flight.py": "docstring: a change-history tag dropped",
    "messages/audit.py": "docstring: a change-history tag dropped",
    "qos/__init__.py": "docstring: a change-history tag dropped",
    "qos/controller.py": "docstring: a change-history tag dropped",
    # accord-lint over the port
    "analysis/layering.py": "obs/ and analysis/ are kept off torch too: the "
                            "port's device stack",
    # the reference's root scripts, driven over the port's device stores
    "soak.py": "the burns run the port's burn on --device (the card by "
               "default) with no JAX platform or virtual mesh; the ledger "
               "and state go to paths the caller names; --jobs runs seeds "
               "in parallel after one kernel build; --expect holds each "
               "seed's line == the JAX burn's recorded line; a seed's "
               "record carries its kernel launches",
    "measure_device.py": "--device (the card by default) passed to the "
                         "store factories; the card's name and power limit "
                         "where the reference probes a JAX platform; the "
                         "raw JSON goes to --out, with the wall seconds",
    "bench.py": "the lanes rewritten over the port's stores and kernels "
                "(CUDA-event times on the card, no rate on the CPU, no rep "
                "differencing), the history and gate in bench_guard.py with "
                "the reference's names; tcp and pipeline are always the "
                "device-store lanes, keyed tcp+device and pipeline+device; "
                "emit records only under --record, --guard or --fill (the "
                "reference records every run), so a run by hand never "
                "replaces a committed card-machine row; --fill probes the "
                "card in a subprocess, not a JAX platform, and takes any "
                "config (--only all re-records the history); of the "
                "reference's lane hooks only the sim lanes' ACCORD_SLO_OPS, "
                "ACCORD_SLO_RATE and ACCORD_SLO_STALL_US are read, the ones "
                "a test sets; slo-wan's flat_tcp_baseline reads the history's "
                "tcp+device row, where the reference reads tcp/host, a lane "
                "of scalar stores that the port's bench does not run",
}
# port modules whose reference is a script at the repository's root
ROOT_SCRIPTS = ("soak.py", "measure_device.py", "bench.py")


def _renamed(path: Path) -> str:
    return path.read_text().replace("accord_tpu", "accord_tpu_torch")


def test_copies_match_the_reference_or_are_listed():
    drifted, stale, compared = [], [], 0
    for port in sorted([*PORT.rglob("*.py"), *PORT.glob("native/*.cpp")]):
        rel = port.relative_to(PORT).as_posix()
        ref = (REPO if rel in ROOT_SCRIPTS else REFERENCE) / rel
        if not ref.exists():
            continue  # the port's own module (bench, tpcc, workload, ...)
        compared += 1
        same = port.read_text() == _renamed(ref)
        if rel in DEVIATIONS and same:
            stale.append(rel)
        elif rel not in DEVIATIONS and not same:
            drifted.append(rel)
    missing = [rel for rel in DEVIATIONS if not (PORT / rel).exists()]
    assert not drifted, f"copies that differ from the reference: {drifted}"
    assert not stale, f"listed as deviating but identical: {stale}"
    assert not missing, f"listed but absent from the port: {missing}"
    assert compared >= 160, compared
