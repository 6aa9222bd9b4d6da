"""TPC-C new-order replay: the bulk-resolve lane of the port.

The counterpart of ``bench.py::bench_tpcc`` (:1041-1169) with
``_tpcc_resolve_core`` and ``_tpcc_stack_fn``.  A million new-order
transactions over 64 warehouses each write their district's O_ID counter
(640 keys: the classic TPC-C contention point) and 10 stock keys, 1% of
them in a remote warehouse.  The stream is cut into windows of 2048 and each
window is resolved against watermark-pruned state: with cleanup keeping only
each key's latest committed write, a transaction's deps are that writer for
each key it touches (the cross-window deps) plus its conflicts inside the
window, which are ordered into execution waves.

On the card the windows of one key-domain size K are stacked and resolved in
one pass: ``ops/keyset.py::cross_window_deps`` (plain torch, as in the JAX
package) and the key-set window kernel K4 (``csrc/keyset_windows.cu``); on
the CPU every step runs its plain version.  ``window_oracle`` is a scalar
host scan, independent of the dense formulation, that checks sampled
windows.

    python -m accord_tpu_torch.tpcc             (the full lane, on the card)
    python -m accord_tpu_torch.tpcc --device cpu --txns 3000 --window 256

prints one JSON line with the lane's counts and, on the card, its device
time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops import keyset
from accord_tpu_torch.ops.cuda_kernels import keyset_windows_cuda
from accord_tpu_torch.ops.wavefront import waves_oracle
from accord_tpu_torch.utils.backend import (card_name_and_power_limit,
                                            resolve_device)

TIMED_PASSES = 7

Window = Tuple[np.ndarray, np.ndarray, np.ndarray]


def tpcc_keys(n_txns: int, warehouses: int, seed: int) -> np.ndarray:
    """-> keys [n_txns, 11] int64: the district key (0..10*warehouses-1),
    then 10 stock keys (1000 + warehouse*100,000 + item).  The same draws
    from ``np.random.default_rng(seed)``, in the same order, as
    ``bench.py:1049-1060``."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, warehouses, n_txns)
    d = rng.integers(0, 10, n_txns)
    district = (w * 10 + d).astype(np.int64)
    items = rng.integers(0, 100_000, (n_txns, 10))
    remote = rng.random((n_txns, 10)) < 0.01
    s_w = np.where(remote, rng.integers(0, warehouses, (n_txns, 10)),
                   w[:, None])
    stock = 1000 + (s_w * 100_000 + items).astype(np.int64)
    return np.concatenate([district[:, None], stock], axis=1)


def tpcc_windows(keys: np.ndarray, window: int) -> List[Window]:
    """Cut the stream into windows -> [(prev [K] int32, txn_rank [window]
    int32, txn_keys [window, 11] int32)], as ``bench.py:1062-1084``: the
    window's distinct keys numbered in key order, K the least power of two
    >= 1024 that holds them, prev[i] the rank of key i's last writer in an
    earlier window (-1 = none), each row its sorted set of key numbers padded
    with -1, ranks the stream positions (-1 on a short last window's padding).

    The scalar loop of the JAX package is vectorized here: keys are numbered
    once over the whole stream, and the last writer of a key is the largest
    rank that touched it, since ranks only grow."""
    n = keys.shape[0]
    uniq, gid = np.unique(keys, return_inverse=True)
    gid = gid.reshape(keys.shape)
    last = np.full(len(uniq), -1, np.int32)
    big = np.iinfo(np.int64).max
    out = []
    for w0 in range(0, n, window):
        g = gid[w0:w0 + window]
        b = g.shape[0]
        ug, local = np.unique(g, return_inverse=True)
        k = 1024
        while k < len(ug):
            k *= 2
        prev = np.full(k, -1, np.int32)
        prev[:len(ug)] = last[ug]
        rows = np.sort(local.reshape(g.shape).astype(np.int64), axis=1)
        dup = np.zeros_like(rows, dtype=bool)
        dup[:, 1:] = rows[:, 1:] == rows[:, :-1]
        rows = np.sort(np.where(dup, big, rows), axis=1)
        txn_keys = np.full((window, keys.shape[1]), -1, np.int32)
        txn_keys[:b] = np.where(rows == big, -1, rows)
        txn_rank = np.full(window, -1, np.int32)
        txn_rank[:b] = np.arange(w0, w0 + b, dtype=np.int32)
        ranks = np.broadcast_to(txn_rank[:b, None], g.shape)
        np.maximum.at(last, g.ravel(), ranks.ravel())
        out.append((prev, txn_rank, txn_keys))
    return out


def stack_buckets(windows: List[Window]) -> List[Window]:
    """Stack the windows of each key-domain size K, in order of first
    appearance -> [(prevs [n, K], ranks [n, B], keyss [n, B, 11])]: each
    stack is one device pass."""
    buckets: dict = {}
    for win in windows:
        buckets.setdefault(win[0].shape[0], []).append(win)
    return [tuple(np.stack([w[i] for w in ws]) for i in range(3))
            for ws in buckets.values()]


def resolve_stack(prevs: torch.Tensor, ranks: torch.Tensor,
                  keyss: torch.Tensor):
    """One stack of same-K windows (``_tpcc_stack_fn`` at reps = 1) ->
    (cross-window deps, in-window edges, max wave), 0-dim int32 tensors.
    On CUDA tensors the windows run in K4, on CPU tensors in its plain
    version."""
    cross = keyset.cross_window_deps(prevs, keyss)
    in_w, wave_w = keyset_windows_cuda(keyss, ranks)
    return cross, in_w.sum(dtype=torch.int32), wave_w.max()


def window_oracle(txn_keys, txn_rank) -> Tuple[int, int]:
    """Scalar host scan of one window -> (edges, max_wave): every valid key
    lists the valid rows that hold it, each earlier row on a key is a dep,
    and the waves come from ``waves_oracle``.  Independent of the dense
    formulation; any keys (unsorted, repeated, padded anywhere)."""
    keys = torch.as_tensor(txn_keys).tolist()
    rank = torch.as_tensor(txn_rank).tolist()
    rows_of = defaultdict(list)
    for r, (ks, rr) in enumerate(zip(keys, rank)):
        if rr >= 0:
            for k in set(ks):
                if k >= 0:
                    rows_of[k].append(r)
    deps = [set() for _ in rank]
    for rows in rows_of.values():
        for r in rows:
            deps[r].update(c for c in rows if rank[c] < rank[r])
    waves = waves_oracle([sorted(d) for d in deps])
    return sum(len(d) for d in deps), max(waves)


@dataclass
class Lane:
    """A prepared replay: the host windows and their stacks on the device."""
    txns: int
    windows: List[Window]
    stacks: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    prep_seconds: float
    device: torch.device


def prepare(n_txns=1_000_000, warehouses=64, window=2048, seed=42,
            device=None) -> Lane:
    """Host preparation (``bench.py:1049-1095``): draw the stream, cut and
    number the windows, stack them by K and put the stacks on `device`
    (None = the card; "cpu" for the plain versions)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    windows = tpcc_windows(tpcc_keys(n_txns, warehouses, seed), window)
    stacks = [tuple(torch.from_numpy(a).to(dev) for a in s)
              for s in stack_buckets(windows)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return Lane(n_txns, windows, stacks, time.perf_counter() - t0, dev)


def resolve(lane: Lane) -> dict:
    """One pass over every stack -> the lane's counts, as ``bench_tpcc``
    reports them."""
    outs = [resolve_stack(*s) for s in lane.stacks]
    cross = sum(int(o[0]) for o in outs)
    inwin = sum(int(o[1]) for o in outs)
    return {"txns": lane.txns, "windows": len(lane.windows),
            "edges": cross + inwin, "edges_cross_window": cross,
            "edges_in_window": inwin,
            "max_wave_depth": max(int(o[2]) for o in outs)}


def resolve_ms(lane: Lane) -> float:
    """Median device ms of one pass over every stack (CUDA events around the
    whole pass, inputs already on the card) over TIMED_PASSES passes, after
    one warm-up pass."""
    if lane.device.type != "cuda":
        raise ValueError("resolve_ms times the card: prepare the lane on cuda")
    resolve(lane)
    times = []
    for _ in range(TIMED_PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for s in lane.stacks:
            resolve_stack(*s)
        end.record()
        torch.cuda.synchronize(lane.device)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replay(n_txns=1_000_000, warehouses=64, window=2048, seed=42,
           device=None) -> dict:
    """The whole lane -> bench_tpcc's counts, the host preparation seconds
    and, on the card, the median device ms of a pass and txns/s (None on the
    CPU, where nothing is timed)."""
    lane = prepare(n_txns, warehouses, window, seed, device)
    out = resolve(lane)
    out["host_prep_seconds"] = lane.prep_seconds
    on_card = lane.device.type == "cuda"
    ms = resolve_ms(lane) if on_card else None
    out["tpcc_neworder_resolve_ms"] = ms
    out["txns_per_sec"] = None if ms is None else n_txns / (ms / 1e3)
    out["kernel_path"] = "cuda" if on_card else "plain"
    out["hardware"] = card_name_and_power_limit() if on_card else "cpu"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--txns", type=int, default=1_000_000)
    ap.add_argument("--window", type=int, default=2048)
    ns = ap.parse_args(argv)
    print(json.dumps(replay(n_txns=ns.txns, window=ns.window,
                            device=ns.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
