"""Same-seed differential of the whole burn: the JAX package's ``BurnRun``
and the port's, on the same arguments, in one process.

Both build the cluster, the workload and every random choice from the seed
(``utils/random_source.py`` is the same in both), and the simulation runs on
virtual time, so the two runs must agree exactly: every ``BurnStats`` field,
the whole list of ack latencies, the verifier's verdict, the events and
virtual time, the end-of-run audit, the final histories, and per node the
Infer tallies, the agent's recorded failures and every store's ``device_*``
counters summed (``workload.burn_fingerprint``).  The port's stores run on
the CPU (``device="cpu"``); the JAX mesh store runs on the 8-device virtual
mesh the conftest provides.
"""

import contextlib
import importlib
import io

import pytest

import accord_tpu.impl.device_store as jax_device_store
import accord_tpu.sim.burn as jax_burn
import accord_tpu_torch.impl.device_store as torch_device_store
import accord_tpu_torch.sim.burn as torch_burn
from accord_tpu_torch.workload import PROTOCOL_BURNS, burn_fingerprint

CASES = {
    # name: (seed, ops, store, flush window us, BurnRun keywords)
    "scalar": (0, 60, None, 0, {}),
    "clean": (0, 60, "flat", 200, {}),
    "lossy": (103, 80, "flat", 200, {"drop_prob": 0.1}),
    "deep_windows": (33002, 80, "flat", 4000,
                     {"concurrency": 24, "drop_prob": 0.05}),
    "partitions_drift_4_stores": (1, 200, "flat", 200,
                                  {"drop_prob": 0.1, "partitions": True,
                                   "clock_drift": True,
                                   "num_command_stores": 4}),
    "contended_8_stores_6_keys": (21, 80, "flat", 300,
                                  {"keys": 6, "num_command_stores": 8}),
    "mesh": (62, 60, "mesh", 300, {"nodes": 3, "keys": 8}),
}


def _factory(store_mod, store, flush_window_us, port):
    if store is None:
        return None
    cls = (store_mod.MeshDeviceCommandStore if store == "mesh"
           else store_mod.DeviceCommandStore)
    kw = {"device": "cpu"} if port else {}
    return cls.factory(flush_window_us=flush_window_us, verify=True, **kw)


def _fingerprint(burn_mod, store_mod, port, seed, ops, store,
                 flush_window_us, kw):
    run = burn_mod.BurnRun(seed, ops, store_factory=_factory(
        store_mod, store, flush_window_us, port), **kw)
    try:
        run.run()
    except AssertionError as e:  # the verifiers' and the audit's failures
        return {"verdict": f"{type(e).__name__}: {e}"}
    return {"verdict": "ok", **burn_fingerprint(run)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_burn_matches_jax_package(case):
    seed, ops, store, window, kw = CASES[case]
    want = _fingerprint(jax_burn, jax_device_store, False, seed, ops, store,
                        window, kw)
    got = _fingerprint(torch_burn, torch_device_store, True, seed, ops,
                       store, window, kw)
    assert want["verdict"] == "ok", want["verdict"]
    assert want["stats"][0] > 0
    if store is not None:
        assert sum(n["device"]["device_hits"]
                   for n in want["nodes"].values()) > 0
        assert not any(n["device"]["device_disabled"]
                       for n in want["nodes"].values())
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field


# ------------------------------------------- the burn's optional arms ----

def _arm_run(pkg, burn_mod, port, arm, tmp_path):
    """One short burn of package `pkg` on an optional arm -> its verdict and
    fingerprint (on a failed run, the verdict, the corrupted txn and the
    auditors' divergences)."""
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    seed, ops = 5, 60
    kw = {"nodes": 3, "keys": 10}
    dev = {"device": "cpu"} if port else {}
    rng = imp("utils.random_source").RandomSource(seed ^ 0x5D5D)
    delayed = imp("sim.delayed_store")
    if arm == "delayed":
        kw.update(drop_prob=0.1, num_command_stores=2,
                  store_factory=delayed.DelayedCommandStore.factory(rng))
    elif arm == "delayed_device":
        kw.update(drop_prob=0.1, num_command_stores=2,
                  store_factory=delayed.delayed_device_factory(
                      rng, flush_window_us=300, verify=True, **dev))
    elif arm == "delayed_mesh":
        kw.update(store_factory=delayed.delayed_device_factory(
            rng, mesh_store=True, flush_window_us=300, verify=True, **dev))
    elif arm == "restart":
        seed, ops = 23, 60
        kw.update(drop_prob=0.05, restarts=1,
                  journal_dir=str(tmp_path / pkg))
    elif arm == "geo":
        geo = imp("topology.geo").wan3_profile()
        seed = 29
        kw = {"nodes": len(geo.node_dc), "rf": None, "geo": geo,
              "electorate": frozenset({1, 2, 3, 5}), "dc_partitions": True,
              "store_factory": imp("impl.device_store").DeviceCommandStore
              .factory(flush_window_us=300, verify=True, **dev)}
    elif arm == "corrupt":
        # tests/test_audit.py's hostile burn, shorter, caught by the
        # end-of-run checker alone
        kw = {"drop_prob": 0.02, "durability_cycle_s": 3.0,
              "topology_changes": False, "corrupt_at": 30}
    else:  # the ingest pipeline, the admission controller
        kw[arm] = True
    run = burn_mod.BurnRun(seed, ops, **kw)
    try:
        run.run()
    except AssertionError as e:
        return {"verdict": f"{type(e).__name__}: {e}",
                "corrupted": repr(run.corrupted_txn),
                "divergences": [d for a in run.cluster.auditors.values()
                                for d in a.divergences]}
    return {"verdict": "ok", **burn_fingerprint(run)}


ARMS = ("delayed", "delayed_device", "delayed_mesh", "restart", "geo",
        "corrupt", "pipeline", "qos")


def test_burn_arms_match_jax_package(tmp_path):
    """Each optional arm of the burn in both packages on the same seed: the
    delayed-executor stores alone and over the flat and mesh device stores
    (the port's on the CPU), a crash-restart replaying an on-disk journal,
    the geo profile with a narrowed electorate and DC partitions, an
    out-of-band corruption (both fail alike: an audit divergence naming
    the corrupted txn), the ingest pipeline and the admission controller:
    verdict and ``burn_fingerprint`` ==."""
    for arm in ARMS:
        want = _arm_run("accord_tpu", jax_burn, False, arm, tmp_path)
        got = _arm_run("accord_tpu_torch", torch_burn, True, arm, tmp_path)
        assert got.keys() == want.keys(), arm
        for field in want:
            assert got[field] == want[field], (arm, field)
        if arm == "corrupt":
            assert "audit divergence" in want["verdict"]
            assert want["corrupted"] in want["verdict"]
        else:
            assert want["verdict"] == "ok", (arm, want["verdict"])
            assert want["stats"][0] > 0, arm
        if arm == "restart":
            assert want["stats"][5] == 1
            assert any((tmp_path / "accord_tpu_torch").iterdir())


def _cli_fingerprint(burn_mod, argv):
    """A burn through a package's CLI (``main``) -> the line it prints last
    and the run's ``burn_fingerprint``."""
    runs = []

    class Recorded(burn_mod.BurnRun):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    out = io.StringIO()
    saved = burn_mod.BurnRun
    burn_mod.BurnRun = Recorded
    try:
        with contextlib.redirect_stdout(out):
            rc = burn_mod.main(argv)
    finally:
        burn_mod.BurnRun = saved
    assert rc == 0 and len(runs) == 1
    return out.getvalue().strip().splitlines()[-1], burn_fingerprint(runs[0])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["delayed", "delayed_mesh", "restart",
                                  "geo"])
def test_device_arms_at_full_size_match_jax_package(name):
    """The four device arms the card runs (``workload.PROTOCOL_BURNS``)
    through both packages' CLIs: the line == the recorded JAX line, and
    the fingerprints ==."""
    argv, line = PROTOCOL_BURNS[name]
    want = _cli_fingerprint(jax_burn, argv.split())
    got = _cli_fingerprint(torch_burn, argv.split() + ["--device", "cpu"])
    assert want[0] == line
    assert got[0] == line
    assert got[1] == want[1]


def _sim_tools(pkg):
    """A burn on package `pkg`'s Debug store (``impl/debug_store.py``), its
    history as Elle EDN (``sim/elle_export.py``), the Debug store's check
    of a leaked safe store, and ``utils/property.py``'s draws and shrunk
    counterexample, as plain data."""
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")
    debug = imp("impl.debug_store").DebugCommandStore
    burn = imp("sim.burn")
    run = burn.BurnRun(93, 60, n_shards=4, store_factory=debug)
    run.run()
    edn = imp("sim.elle_export").to_edn_history(run.verifier.observations)

    cluster = imp("sim.cluster").SimCluster(n_nodes=1, seed=91, n_shards=1,
                                            store_factory=debug)
    store = cluster.node(1).command_stores.all()[0]
    leaked = []
    store.execute(imp("local.store").PreLoadContext.empty(), leaked.append)
    cluster.process_all()
    ts = imp("primitives.timestamp")
    txn_id = cluster.node(1).next_txn_id(ts.TxnKind.WRITE, ts.Domain.KEY)
    try:
        leaked[0].get(txn_id)
        leak = None
    except imp("utils.invariants").InvariantError as e:
        leak = str(e).split(" used ", 1)[1]

    prop = imp("utils.property")
    G = prop.Gens
    gen = G.tuples(G.ints(-5, 50), G.bools(0.3), G.pick("abcdef"),
                   G.one_of(G.zipf(100), G.constant(7)),
                   G.lists(G.ints(0, 9).map(lambda v: v * 3), max_size=6),
                   G.ints(1, 5).flat_map(lambda n: G.lists(G.bools(),
                                                           n, n)),
                   G.ints(0, 100).filter(lambda v: v % 7 == 0))
    draws = [gen(imp("utils.random_source").RandomSource(s))
             for s in range(40)]

    def sums_small(xs):
        assert sum(xs) < 40
    try:
        prop.for_all(G.lists(G.ints(0, 30), max_size=12), examples=50,
                     seed=3)(sums_small)
        shrunk = None
    except prop.PropertyError as e:
        shrunk = str(e).splitlines()[:3]
    return {"fingerprint": burn_fingerprint(run), "edn": edn,
            "leak": leak, "draws": draws, "shrunk": shrunk}


def test_debug_store_elle_export_and_property_match_jax():
    """The Debug store's burn, its EDN history, its leak check, and the
    property generators' draws for seeds 0-39 and the counterexample
    ``for_all`` shrinks to: == in both packages."""
    want = _sim_tools("accord_tpu")
    got = _sim_tools("accord_tpu_torch")
    assert want["fingerprint"]["stats"][0] > 0
    assert want["edn"].count(":type :ok") == len(want["fingerprint"][
        "ack_latencies_us"]) > 0
    assert want["leak"] is not None and "after its task" in want["leak"]
    assert want["shrunk"] is not None
    for field in want:
        assert got[field] == want[field], field
