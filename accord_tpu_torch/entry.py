"""Flagship entry point: the single-device resolve step on an example window,
and the sharded step's dry run.

The counterpart of ``__graft_entry__.py::_example``/``entry``/
``dryrun_multichip``.  The resolve
step is the batched dependency calculation (the reference's
CommandsForKey.mapReduceActive hot loop, accord/local/CommandsForKey.java:
614-650) fused with the in-window conflict graph and the execution-order
wavefront (the reference's Command.WaitingOn walk, accord/local/
Command.java:1294-1643).
"""

from __future__ import annotations

import numpy as np

from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus
from accord_tpu_torch.ops.encode import (BatchEncoder, scalar_deps_oracle,
                                         window_to_tensors)
from accord_tpu_torch.ops.sharded import (ShardedEncoder, make_sharded_step,
                                          resolve_step)
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind
from accord_tpu_torch.utils.backend import resolve_device
from accord_tpu_torch.utils.random_source import RandomSource


def _example(n_keys=256, n_existing=4096, n_batch=256, seed=7):
    rng = RandomSource(seed)
    kinds = [TxnKind.READ, TxnKind.WRITE]
    statuses = [InternalStatus.PREACCEPTED, InternalStatus.ACCEPTED,
                InternalStatus.COMMITTED, InternalStatus.STABLE,
                InternalStatus.APPLIED]
    keys = [Key(i) for i in range(n_keys)]
    cfks = {k: CommandsForKey(k) for k in keys}
    hlc = 1000
    for _ in range(n_existing):
        hlc += 1 + rng.next_int(2)
        tid = TxnId.create(1, hlc, rng.pick(kinds), Domain.KEY, rng.next_int(8))
        for k in rng.sample(keys, 1 + rng.next_int(3)):
            cfks[k].update(tid, rng.pick(statuses), None)
    batch = []
    for _ in range(n_batch):
        hlc += 1 + rng.next_int(2)
        tid = TxnId.create(1, hlc, rng.pick(kinds), Domain.KEY, rng.next_int(8))
        batch.append((tid, rng.sample(keys, 1 + rng.next_int(4))))
    return list(cfks.values()), batch


def entry(device=None):
    """-> (resolve_step, its nine arguments on `device`) for the example
    window.  `device` None means the CUDA card and raises when there is
    none; pass "cpu" to run the plain versions."""
    dev = resolve_device(device)
    cfks, batch = _example()
    enc = BatchEncoder(cfks, batch)
    return resolve_step, window_to_tensors(enc.state, enc.dbatch, dev)


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """The sharded resolve step over `n_shards` key blocks, stacked on one
    device, on a small example window (4 keys a shard, 64 txns, a window of
    16), checked element for element: every wave >= 0, the decoded deps ==
    the scalar oracle, and the in-window graph and the waves == the
    single-device ``resolve_step`` on the flat encoding.  Raises
    AssertionError on any difference; -> a summary dict.  `device` None
    means the CUDA card; "cpu" runs the plain versions.

    The JAX dry run's protocol leg (a hostile ``verify=True`` burn served by
    the mesh store, ``__graft_entry__.py:131-162``) waits for the port of
    the protocol store."""
    dev = resolve_device(device)
    cfks, batch = _example(n_keys=4 * n_shards, n_existing=64, n_batch=16)
    enc = ShardedEncoder(cfks, batch, n_shards)
    dep_mask, dep_count, dep_bb, waves = make_sharded_step(n_shards)(
        *window_to_tensors(enc.args(), device=dev))
    n = len(batch)
    waves = waves[:n].cpu()
    mask = dep_mask.cpu().numpy()
    checks = {
        "every txn has a wave": bool((waves >= 0).all()),
        "deps == the scalar oracle":
            enc.decode_deps(mask) == scalar_deps_oracle(cfks, batch),
        "counts == the mask's edges": np.array_equal(
            dep_count[:n].cpu().numpy(),
            mask.sum(axis=(0, 2), dtype=np.int32)[:n]),
    }
    flat = BatchEncoder(cfks, batch)
    _, _, dep_bb1, waves1 = resolve_step(
        *window_to_tensors(flat.state, flat.dbatch, dev))
    checks["graph == resolve_step's"] = bool(
        (dep_bb[:n, :n] == dep_bb1[:n, :n]).all())
    checks["waves == resolve_step's"] = bool(
        (waves == waves1[:n].cpu()).all())
    failed = [what for what, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dryrun_multichip({n_shards}) on {dev}: "
                             f"{', '.join(failed)}")
    return {"n_shards": n_shards, "device": str(dev),
            "edges": int(dep_count[:n].sum()), "max_wave": int(waves.max()),
            "es": int(mask.shape[2]), "ks": enc.ks}
