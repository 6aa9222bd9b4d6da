#!/usr/bin/env python3
"""Time the port's deps tile (K1) and wavefront (K2) on the card, against
another checkout's kernels in the same process.

    python3 time_kernels.py [--against DIR] [--reps N]

Builds the main path's window (workload.build_world(), seed 42: B = 512,
E = 128,768, K = 1024) and chip_smoke.py phase 3's B = 512 random DAG over
permuted ranks, then times, with CUDA events (the median of --reps batches of
ten calls), this tree's kernels and, with --against, the kernels built from
DIR/accord_tpu_torch/csrc by DIR's own ops/cuda_kernels.py, in turns (this,
DIR, DIR, this).  Each is timed on K1 over the window, and on K2 over the
window's in-window graph and over the random DAG, without the ranks (a call
every version takes) and with them where its wrapper takes them.  Both
versions' outputs must be == the plain versions'.  Prints the card's name
and power limit, then one JSON line: {version: {timing: [ms, ...]}}.
"""

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_kernels(root: Path, name: str):
    """DIR's ops/cuda_kernels.py as module `name`: it builds from DIR's csrc
    into DIR's _build (its paths follow its own file)."""
    path = root / "accord_tpu_torch" / "ops" / "cuda_kernels.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=15)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.ops import deps_kernel, wavefront
    from accord_tpu_torch.ops.encode import BatchEncoder, window_to_tensors
    from accord_tpu_torch.utils.backend import card_name_and_power_limit
    from accord_tpu_torch.utils.timing import median_ms
    from accord_tpu_torch.workload import build_world

    def timed(fn):
        return median_ms(fn, ns.reps, per_batch=10)

    dev = torch.device("cuda", 0)
    ck.build()
    versions = {"this": ck}
    if ns.against is not None:
        versions["against"] = load_kernels(ns.against.resolve(), "ck_against")

    cfks, batch = build_world(seed=42)
    enc = BatchEncoder(cfks, batch)
    er, eer, ek, es, ekd, tr, twm, tk, touches = window_to_tensors(
        enc.state, enc.dbatch, dev)
    succ = deps_kernel.successor_write_eat(er, eer, ek, es, ekd)
    k1_args = (touches, ek, er, eer, es, ekd, succ, tr, twm)
    dep_bb = deps_kernel.in_batch_graph(tr, twm, tk, touches)
    rng = np.random.default_rng(600)  # chip_smoke.py phase 3, first case
    n = 512
    rank_np = rng.permutation(n).astype(np.int32)
    dag = torch.from_numpy(
        (rng.random((n, n)) < 0.08) & (rank_np[None, :] < rank_np[:, None])
    ).to(dev)
    dag_rank = torch.from_numpy(rank_np).to(dev)

    want_mask, want_count = deps_kernel.deps_tile(*k1_args)
    want_waves = wavefront.execution_waves(dep_bb)
    want_dag = wavefront.execution_waves(dag)

    def timings(mod):
        takes_rank = "txn_rank" in inspect.signature(
            mod.execution_waves_cuda).parameters
        mask, count = mod.deps_tile_cuda(*k1_args)
        checks = [torch.equal(mask, want_mask), torch.equal(count, want_count),
                  torch.equal(mod.execution_waves_cuda(dep_bb), want_waves),
                  torch.equal(mod.execution_waves_cuda(dag), want_dag)]
        out = {
            "K1 window": timed(lambda: mod.deps_tile_cuda(*k1_args)),
            "K2 window without ranks":
                timed(lambda: mod.execution_waves_cuda(dep_bb)),
            "K2 random DAG without ranks":
                timed(lambda: mod.execution_waves_cuda(dag)),
        }
        if takes_rank:
            checks += [
                torch.equal(mod.execution_waves_cuda(dep_bb, tr), want_waves),
                torch.equal(mod.execution_waves_cuda(dag, dag_rank), want_dag)]
            out["K2 window with ranks"] = timed(
                lambda: mod.execution_waves_cuda(dep_bb, tr))
            out["K2 random DAG with ranks"] = timed(
                lambda: mod.execution_waves_cuda(dag, dag_rank))
        if not all(checks):
            raise AssertionError("a kernel disagrees with its plain version")
        return out

    order = ["this", "against", "against", "this"] \
        if "against" in versions else ["this"]
    result = {name: {} for name in versions}
    for name in order:
        for key, ms in timings(versions[name]).items():
            result[name].setdefault(key, []).append(ms)
    print(card_name_and_power_limit())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
