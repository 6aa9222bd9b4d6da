"""Flagship entry point: the single-device resolve step on an example window,
and the sharded step's dry run with its protocol leg.

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

from accord_tpu_torch.impl.device_store import MeshDeviceCommandStore
from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus
from accord_tpu_torch.ops.encode import (BatchEncoder, scalar_deps_oracle,
                                         window_to_tensors)
from accord_tpu_torch.ops.sharded import (ShardedEncoder, dep_mask_to_host,
                                          make_sharded_step, resolve_step)
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind
from accord_tpu_torch.sim.burn import BurnRun
from accord_tpu_torch.utils.backend import resolve_device, resolve_spread
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


def dryrun_multichip(n_shards: int, device=None, devices=None) -> dict:
    """The JAX dry run's two legs on `device` (``__graft_entry__.py:
    dryrun_multichip``): the sharded step (``dryrun_sharded_step``), then
    its protocol leg (``dryrun_protocol_leg``).  Raises AssertionError on
    any difference; -> the two summaries in one dict.  `device` None means
    the CUDA card; "cpu" runs the plain versions.  With `devices` (a list,
    or "all": ``utils.backend.resolve_devices``) both legs spread the
    shards over those devices, devices[0] standing for `device`."""
    out = dryrun_sharded_step(n_shards, device, devices)
    out.update(dryrun_protocol_leg(n_shards, device, devices))
    return out


def _check(what: str, checks: dict) -> None:
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{what}: {', '.join(failed)}")


def dryrun_sharded_step(n_shards: int, device=None, devices=None) -> dict:
    """The sharded resolve step over `n_shards` key blocks, stacked on one
    device or spread over `devices`, on a small example window (4 keys a
    shard, 64 txns, a window of 16), checked element for element: every
    wave >= 0, the decoded deps == the scalar oracle, and the in-window
    graph and the waves == the single-device ``resolve_step`` on the flat
    encoding.  -> a summary."""
    dev, devices = resolve_spread(device, devices)
    cfks, batch = _example(n_keys=4 * n_shards, n_existing=64, n_batch=16)
    enc = ShardedEncoder(cfks, batch, n_shards)
    step = make_sharded_step(n_shards, devices=devices)
    if devices is None:
        out = step(*window_to_tensors(enc.args(), device=dev))
    else:
        out = step(*enc.args())
    dep_mask, dep_count, dep_bb, waves = out
    n = len(batch)
    waves = waves[:n].cpu()
    mask = dep_mask_to_host(dep_mask)
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
    _check(f"dryrun_multichip({n_shards}) on {dev}", checks)
    out = {"n_shards": n_shards, "device": str(dev),
           "edges": int(dep_count[:n].sum()), "max_wave": int(waves.max()),
           "es": int(mask.shape[2]), "ks": enc.ks}
    if devices is not None:
        out["devices"] = [str(d) for d in devices]
    return out


def dryrun_protocol_leg(n_shards: int, device=None, devices=None) -> dict:
    """The protocol leg of the JAX dry run (``__graft_entry__.py:131-162``):
    a hostile burn (seed 61, 60 ops, 3 nodes, 6 keys, 10% message loss,
    partitions, 2 command stores a node) whose deps scans are served by
    ``MeshDeviceCommandStore``s of `n_shards` shards on `device`, each
    served scan checked inline against the scalar scan (``verify=True``) and
    the history checked by the burn's verifiers; then no op lost or
    pending, acks, and device hits.  The JAX leg also checks that each
    store has a mesh (``s.mesh is not None``); here every store must be a
    ``MeshDeviceCommandStore`` and, with `devices`, span all of them.
    -> {"protocol_acks": the burn's acks, "protocol_device_hits": its
    stores' device hits}."""
    dev, devices = resolve_spread(device, devices)
    run = BurnRun(61, 60, nodes=3, keys=6, drop_prob=0.10, partitions=True,
                  num_command_stores=2,
                  store_factory=MeshDeviceCommandStore.factory(
                      n_shards=n_shards, flush_window_us=300, verify=True,
                      device=dev, devices=devices))
    stats = run.run()
    stores = [s for node in run.cluster.nodes.values()
              for s in node.command_stores.all()]
    hits = sum(s.device_hits for s in stores)
    _check(f"dryrun_multichip({n_shards}) protocol leg on {dev}", {
        "no op lost or pending": stats.lost == 0 and stats.pending == 0,
        "acks": stats.acks > 0,
        "mesh-served scans": hits > 0,
        "every store a MeshDeviceCommandStore": all(
            isinstance(s, MeshDeviceCommandStore) for s in stores),
        "every store spans the devices": all(
            s.devices == devices for s in stores)})
    return {"protocol_acks": stats.acks, "protocol_device_hits": hits}
