"""The port's device measurement harness against the reference harness.

``accord_tpu_torch/measure_device.py`` runs the root ``measure_device.py``'s
experiments over the port's device stores.  Its burns run on virtual time,
so every row (acks, virtual latencies, events, the scalar work counters and
the stores' device counters) is the JAX harness's on any backend.
"""

import pytest

import measure_device as jax_harness
from accord_tpu_torch import measure_device


@pytest.mark.slow
def test_hitrate_rows_match_the_jax_harness(monkeypatch):
    """``hitrate`` at one seed and 40 ops: the rows of every contention
    level ``==`` the JAX harness's (stores on the CPU in both)."""
    for mod in (jax_harness, measure_device):
        monkeypatch.setattr(mod, "SEEDS", (9101,))
        monkeypatch.setattr(mod, "OPS", 40)
    port = measure_device.hit_rates(device="cpu")
    ref = jax_harness.hit_rates()
    assert list(port) == [4, 16, 64]
    assert port == ref
    assert all(r["dev"]["device_hits"] > 0 for rows in port.values()
               for r in rows)


@pytest.mark.parametrize("plan", [True, False])
def test_wave_plan_toggle_matches_the_jax_store(plan):
    """The store's ``plan_waves`` A/B toggle (the ``waves`` experiment's
    arms): one short burn a setting, its row ``==`` the JAX harness's, and
    with the plan off no wave is planned."""
    from accord_tpu.impl.device_store import DeviceCommandStore as JaxStore
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    # 4 keys and 800 us windows: this seed's windows hold two Applies once
    kw = {"ops": 30, "keys": 4}
    port = measure_device.run_burn(
        9101, **kw, store_factory=DeviceCommandStore.factory(
            flush_window_us=800, verify=True, plan_waves=plan,
            device="cpu"))
    ref = jax_harness.run_burn(9101, **kw, store_factory=JaxStore.factory(
        flush_window_us=800, verify=True, plan_waves=plan))
    assert port == ref
    assert (port["dev"]["device_wave_planned"] > 0) == plan
