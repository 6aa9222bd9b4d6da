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

import pytest

import accord_tpu.impl.device_store as jax_device_store
import accord_tpu.sim.burn as jax_burn
import accord_tpu_torch.impl.device_store as torch_device_store
import accord_tpu_torch.sim.burn as torch_burn
from accord_tpu_torch.workload import burn_fingerprint

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
