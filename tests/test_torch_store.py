"""The port's protocol store tier against the JAX package's, on the CPU.

One seeded plan of plain data (``workload.store_plan``: preaccepts,
accepts, stable commits, applies, recovery probes and range txns in flush
windows) runs through ``accord_tpu.impl.device_store.DeviceCommandStore``
on a JAX ``StoreNode`` and through the port's store with ``device="cpu"``,
both with ``verify=True``, so every served scan is also checked inline
against its own package's scalar scan.  Each store is built from its own
package's classes; only plain tuples cross between them.  Equal, with ==
since every output is an id, a status or a count: each op's result (outcome,
witnessed timestamp, deps as sorted (epoch, hlc, flags, node) tuples), every
``device_*`` counter after each window, and at the end every command's save
status and executeAt, every CFK's ``as_arrays()`` and the ListStore data.
"""

import importlib

import pytest

from accord_tpu.impl.device_store import \
    DeviceCommandStore as JaxDeviceCommandStore
from accord_tpu.impl.device_store import \
    MeshDeviceCommandStore as JaxMeshDeviceCommandStore
from accord_tpu_torch.impl.device_store import (DeviceCommandStore,
                                                MeshDeviceCommandStore)
from accord_tpu_torch.workload import (STORE_KIT_MODULES, StoreNode,
                                       StorePlanRunner, default_store_plan,
                                       default_store_windows, device_counters,
                                       first_touch_preaccepts, store_kit,
                                       store_plan, store_state)

JAX_KIT = store_kit({n: importlib.import_module("accord_tpu." + n)
                     for n in STORE_KIT_MODULES})
PORT_KIT = store_kit()
SPAN = (0, 1 << 20)


def _runners(plan, port_factory, jax_factory):
    """A runner of `plan` over the port's store and one over the JAX
    package's, each on a StoreNode of its own package."""
    jnode, pnode = StoreNode(JAX_KIT), StoreNode(PORT_KIT)
    jstore = jax_factory(0, jnode, JAX_KIT.Ranges.of(SPAN))
    pstore = port_factory(0, pnode, PORT_KIT.Ranges.of(SPAN))
    return (StorePlanRunner(pstore, pnode, plan),
            StorePlanRunner(jstore, jnode, plan))


def differential(plan, port_factory=None, jax_factory=None):
    """Run `plan` through both stores window by window; assert every result
    and counter equal after each window and the final state equal.  -> the
    port store's counters and its results."""
    port_factory = port_factory or DeviceCommandStore.factory(
        verify=True, device="cpu")
    jax_factory = jax_factory or JaxDeviceCommandStore.factory(verify=True)
    port, ref = _runners(plan, port_factory, jax_factory)
    results = []
    for w, ops in enumerate(plan[1]):
        got, want = port.run_window(ops), ref.run_window(ops)
        assert got == want, f"window {w}: op results differ"
        assert device_counters(port.store) == device_counters(ref.store), \
            f"window {w}: device counters differ"
        results.append(got)
    assert store_state(port.store) == store_state(ref.store)
    assert not port.store.device_disabled
    return device_counters(port.store), results


def _ran(results, name, outcome="SUCCESS"):
    return sum(1 for w in results for r in w
               if r[0] == name and r[1] == outcome)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_clean(seed):
    counters, results = differential(store_plan(seed))
    assert counters["device_hits"] > 0
    assert counters["device_batched_probes"] > 0
    assert counters["device_max_batch"] >= 2
    assert _ran(results, "preaccept") > 0 and _ran(results, "apply") > 0


def test_store_wide_window():
    """Windows of 32-64 ops: several probes share one kernel call."""
    counters, _ = differential(store_plan(7, n_txns=300, window=(32, 64)))
    assert counters["device_max_batch"] >= 2


def test_store_deep_windows():
    """Windows of 48-64 ops over 16 keys: deep batches, many version-gate
    misses falling back to the scalar scan."""
    counters, _ = differential(store_plan(11, n_keys=16, n_txns=400,
                                          window=(48, 64)))
    assert counters["device_max_batch"] >= 4
    assert counters["miss_version"] > 0


def test_store_apply_heavy():
    """Apply-heavy windows: the wavefront plans them and the store executes
    in wave order."""
    mix = (("preaccept", 0.35), ("accept", 0.05), ("commit", 0.25),
           ("apply", 0.35))
    counters, results = differential(store_plan(3, n_txns=320,
                                                window=(24, 64), mix=mix))
    assert counters["device_wave_batches"] > 0
    assert counters["device_wave_planned"] >= 2
    assert counters["device_wave_executed"] > 0
    assert _ran(results, "apply") > 0


def test_store_recovery_probes():
    mix = (("preaccept", 0.45), ("accept", 0.10), ("commit", 0.10),
           ("apply", 0.10), ("recover", 0.25))
    counters, results = differential(store_plan(5, n_txns=300, mix=mix))
    assert counters["device_recovery_hits"] > 0
    assert _ran(results, "recover") > 0


def test_store_range_txns():
    mix = (("preaccept", 0.40), ("accept", 0.05), ("commit", 0.15),
           ("apply", 0.15), ("recover", 0.05), ("range", 0.20))
    counters, _ = differential(store_plan(9, n_txns=300, mix=mix))
    assert counters["device_range_batches"] > 0
    assert counters["device_range_hits"] > 0
    assert counters["device_range_candidates"] > 0


def test_mesh_store_matches_jax_mesh():
    """MeshDeviceCommandStore at S = 8 (stacked on the CPU) against the JAX
    one on the conftest's 8-device virtual mesh."""
    import jax

    assert len(jax.devices()) >= 8, "conftest must provide the virtual mesh"
    counters, _ = differential(
        store_plan(4, n_txns=300),
        port_factory=MeshDeviceCommandStore.factory(
            n_shards=8, verify=True, device="cpu"),
        jax_factory=JaxMeshDeviceCommandStore.factory(verify=True))
    assert counters["device_hits"] > 0


def test_default_preaccept_window_split():
    """The default cell's PreAccept window (512 Zipf preaccepts in one
    flush) after a 2,048-txn history of ``default_store_plan``: the JAX and
    port stores serve the same scans, exactly the window's first-touch
    preaccepts, and miss the rest on the version gate."""
    txns, history = default_store_plan(n_history=2048)
    window = default_store_windows((txns, history))["preaccept"]
    before, _ = differential((txns, history))
    after, _ = differential((txns, history + [window]))
    grew = {k: after[k] - before[k] for k in after}
    hits = first_touch_preaccepts((txns, history), window)
    assert (grew["device_hits"], grew["device_misses"]) \
        == (hits, len(window) - hits) == (94, 418)
    assert grew["miss_version"] == len(window) - hits
    assert grew["device_batches"] == 1


def _dying(cls, monkeypatch, after=3):
    """Make cls._precompute raise from its (after+1)-th window on."""
    calls = {"n": 0}
    orig = cls._precompute

    def dying(self, window):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("device lost")
        return orig(self, window)

    monkeypatch.setattr(cls, "_precompute", dying)
    return calls


@pytest.mark.parametrize("verify", [False, True])
def test_backend_death(monkeypatch, verify):
    """A precompute that raises after three windows, in both stores: with
    verify off each disables its device tier, reports the failure to its
    agent and serves the rest through the scalar path, and the two stay ==;
    with verify on the port's store re-raises."""
    calls = _dying(DeviceCommandStore, monkeypatch)
    jax_calls = _dying(JaxDeviceCommandStore, monkeypatch)
    plan = store_plan(6, n_txns=200)
    port, ref = _runners(
        plan, DeviceCommandStore.factory(verify=verify, device="cpu"),
        JaxDeviceCommandStore.factory(verify=verify))
    if verify:
        with pytest.raises(RuntimeError, match="device lost"):
            port.run()
        return
    for ops in plan[1]:
        assert port.run_window(ops) == ref.run_window(ops)
        assert device_counters(port.store) == device_counters(ref.store)
    assert store_state(port.store) == store_state(ref.store)
    assert port.store.device_disabled and ref.store.device_disabled
    assert [str(f) for f in port.node.agent.failures] == ["device lost"]
    assert calls["n"] == jax_calls["n"] == 4
    assert port.store.device_flush_windows == 4


def test_default_device_is_the_card():
    """device=None means the CUDA card: without one the store raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCommandStore(0, StoreNode(PORT_KIT), PORT_KIT.Ranges.of(SPAN))
