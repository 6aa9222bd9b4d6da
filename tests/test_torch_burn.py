"""The port's device store on the protocol path: the burns of
``tests/test_device_store.py`` over ``accord_tpu_torch``'s engine.

Each case is the JAX package's case on the port's ``BurnRun`` and store
factories, with the store on the CPU (``device="cpu"``, the plain PyTorch
versions of the kernels): same seeds, ops and assertions.  ``verify=True``
cross-checks every served scan inline against the scalar oracle and fails
the simulation on a divergence, so a green burn certifies the port's device
tier at every query of the run.  The mesh store stacks its shards on one
device and has no ``mesh`` attribute, so its case checks that the stacked
step served the deps windows.  The CLI case runs ``python -m
accord_tpu_torch.sim.burn`` as a user would; the protocol cells' burns at
full size (``slow``) print the JAX package's summary lines.
"""

import os
import subprocess
import sys

import pytest

from accord_tpu_torch.impl.device_store import (DeviceCommandStore,
                                                MeshDeviceCommandStore)
from accord_tpu_torch.sim.burn import BurnRun
from accord_tpu_torch.workload import PROTOCOL_BURNS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _factory(flush_window_us=200, verify=True):
    return DeviceCommandStore.factory(flush_window_us=flush_window_us,
                                      verify=verify, device="cpu")


def _stores(run):
    return [s for node in run.cluster.nodes.values()
            for s in node.command_stores.all()]


def _run(seed, ops=60, flush_window_us=200, **kw):
    run = BurnRun(seed, ops, store_factory=_factory(flush_window_us), **kw)
    stats = run.run()
    assert stats.acks > 0, "pathological: no transaction succeeded"
    stores = _stores(run)
    assert not any(s.device_disabled for s in stores)
    return (stats, sum(s.device_hits for s in stores),
            sum(s.device_misses for s in stores),
            sum(s.device_batched_probes for s in stores),
            max(s.device_max_batch for s in stores))


@pytest.mark.parametrize("seed", range(3))
def test_burn_device_store_clean(seed):
    stats, hits, _misses, probes, _mb = _run(seed)
    # the device tier must actually carry the load, not just fall back
    assert hits > 0 and probes > 0
    assert stats.lost == 0 and stats.pending == 0


def test_burn_device_store_lossy():
    stats, hits, _m, _p, _mb = _run(103, ops=80, drop_prob=0.1)
    assert hits > 0
    assert stats.lost == 0 and stats.pending == 0


def test_burn_device_store_batches_across_ops():
    # a wide flush window accumulates multiple probes per kernel call
    _stats, hits, _m, _probes, max_batch = _run(7, ops=80,
                                                flush_window_us=5000)
    assert hits > 0
    assert max_batch >= 2, "flush window never batched more than one probe"


def test_device_store_majority_served():
    # on a clean run the device tier should serve most key-domain scans
    _stats, hits, misses, _p, _mb = _run(11, ops=60)
    assert hits > misses, (hits, misses)


def test_device_store_serves_recovery_scans():
    """BeginRecovery's four mapReduceFull predicates ride the batched
    recovery scans (ops/recovery_kernel.py) with inline verify on: every
    served scan is cross-checked against the scalar predicates."""
    from accord_tpu_torch.impl.list_store import ListQuery, ListUpdate
    from accord_tpu_torch.messages.commit import Commit
    from accord_tpu_torch.primitives.keys import Key, Keys
    from accord_tpu_torch.primitives.timestamp import Domain, TxnKind
    from accord_tpu_torch.primitives.txn import Txn
    from accord_tpu_torch.sim.cluster import SimCluster

    cluster = SimCluster(n_nodes=3, seed=55, n_shards=2,
                         store_factory=_factory())

    def write_txn(appends):
        return Txn(TxnKind.WRITE, Keys.of(*appends), query=ListQuery(),
                   update=ListUpdate({Key(t): v for t, v in appends.items()}))

    # seed history so recovery predicates have entries to scan
    for v in range(4):
        r = cluster.node(1).coordinate(write_txn({5: v, 7: v + 100}))
        cluster.process_until(lambda: r.is_done)
    # abandon a txn mid-flight (drop its commits), then recover it
    node1 = cluster.node(1)
    txn = write_txn({5: 50, 7: 150})
    txn_id = node1.next_txn_id(txn.kind, Domain.KEY)
    route = node1.compute_route(txn)
    fltr = cluster.network.add_filter(
        lambda f, t, m: isinstance(m, Commit) and f == 1)
    res = node1.coordinate(txn, txn_id=txn_id)
    cluster.process_until(lambda: res.is_done)
    cluster.network.remove_filter(fltr)
    rec = cluster.node(2).recover(txn_id, route)
    cluster.process_until(lambda: rec.is_done)
    cluster.process_all()

    hits = misses = 0
    for node in cluster.nodes.values():
        for s in node.command_stores.all():
            hits += s.device_recovery_hits
            misses += s.device_recovery_misses
    assert hits + misses > 0, "recovery probes never reached the device path"
    assert hits > 0, f"no recovery scan was device-served (misses={misses})"


def test_flush_window_latency_bounded():
    """The batched device path accumulates scans into flush windows, which
    must not inflate the fast path's single-round-trip advantage.  Same
    seed, clean network: the device store's ack-latency percentiles stay
    within a few milliseconds of the scalar store's."""
    scalar = BurnRun(510, 60).run()
    device = BurnRun(510, 60, store_factory=_factory()).run()
    assert scalar.acks == device.acks == 60
    assert device.latency_us(50) <= scalar.latency_us(50) + 10_000, \
        (device.latency_us(50), scalar.latency_us(50))
    assert device.latency_us(95) <= scalar.latency_us(95) + 15_000, \
        (device.latency_us(95), scalar.latency_us(95))


def test_backend_death_falls_back_to_scalar(monkeypatch):
    """A device failing mid-run must not take the replica down: in
    production mode (verify off) the store disables its device tier on the
    first failed flush and serves every scan through the scalar path; the
    burn completes and its verifier runs clean.  In verify mode the failure
    re-raises instead, so a kernel fault cannot pass as an OK run."""
    calls = {"n": 0}
    orig = DeviceCommandStore._precompute

    def dying(self, window):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return orig(self, window)

    monkeypatch.setattr(DeviceCommandStore, "_precompute", dying)
    run = BurnRun(612, 40, store_factory=_factory(verify=False))
    stats = run.run()
    assert stats.lost == 0 and stats.pending == 0
    assert any(s.device_disabled for s in _stores(run))
    assert any(a.failures for a in run.cluster.agents.values())
    assert calls["n"] >= 4

    # verify mode: the same failure is fatal, not maskable
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="illegal memory access"):
        BurnRun(612, 40, store_factory=_factory(verify=True)).run()


def test_deep_flush_windows_stay_verified():
    """Wide flush windows + high client concurrency produce multi-txn
    device batches; every batched window must still verify inline against
    the scalar oracle."""
    run = BurnRun(33002, 80, concurrency=24,
                  store_factory=_factory(flush_window_us=4000),
                  drop_prob=0.05)
    stats = run.run()
    mb = max(getattr(s, "device_max_batch", 0)
             for n in run.cluster.nodes.values()
             for s in n.command_stores.stores)
    assert stats.pending == 0
    assert stats.acks > 0
    assert mb >= 4, f"window never batched deeply (max_batch={mb})"


def test_mesh_store_serves_burn_through_sharded_step():
    """MeshDeviceCommandStore resolves the window's deps scans through the
    sharded deps step (8 key-range shards stacked on the store's device),
    protocol path end to end, with inline scalar verification on every
    served scan."""
    run = BurnRun(62, 60, nodes=3, keys=8, drop_prob=0.0,
                  store_factory=MeshDeviceCommandStore.factory(
                      flush_window_us=300, verify=True, device="cpu"))
    stats = run.run()
    assert stats.acks > 0
    assert stats.lost == 0 and stats.pending == 0
    stores = _stores(run)
    assert all(isinstance(s, MeshDeviceCommandStore) for s in stores)
    # every deps window went through the stacked step, none through K1 flat
    shapes = [s.profiler.summary()["retraces"] for s in stores]
    assert all("deps" not in r for r in shapes)
    assert all("sharded" in r for r, s in zip(shapes, stores)
               if s.device_batches)
    assert sum(s.device_hits for s in stores) > 0


def test_burn_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "accord_tpu_torch.sim.burn", "-s", "0",
         "-o", "30", "--device-store", "--device-verify", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("seed=0 ops=30 "), line
    assert " OK device[" in line and "lost=0 pending=0" in line, line
    assert "DISABLED" not in line, line


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PROTOCOL_BURNS))
def test_protocol_burns_print_the_reference_line(name):
    """The protocol cells at full size through the port's CLI on the CPU
    (the flagship takes minutes): the summary line == the JAX package's."""
    argv, want = PROTOCOL_BURNS[name]
    out = subprocess.run(
        [sys.executable, "-m", "accord_tpu_torch.sim.burn", *argv.split(),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=1200, check=True)
    assert out.stdout.strip().splitlines()[-1] == want
