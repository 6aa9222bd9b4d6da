"""The port's open-loop workload (``workload/arrival.py``, ``profiles.py``,
``openloop.py``) against the JAX package's, on the CPU.

The same seeds draw the same arrival offsets and op streams in both
packages, and the sim runner, on virtual time, gives the same SLO report
for every profile of the SLO lanes; the SLO lanes of the port's bench, with
the scalar stores, print the JAX lanes' reports.  The WAN runner and the
lanes at full size are ``slow``, and so is the check that the card's
zipf1m fingerprint is the JAX lane's over the JAX device stores.
"""

import importlib
import json

import pytest

import bench as jax_bench
from accord_tpu_torch import bench as port_bench
from accord_tpu_torch.local.store import CommandStore

PACKAGES = ("accord_tpu", "accord_tpu_torch")
LANE_PROFILES = ("zipfian", "range_mix", "tpcc_neworder",
                 "ephemeral_read_heavy")


def _workload(pkg):
    return importlib.import_module(f"{pkg}.workload")


def _ops(profile, n):
    return [(op.reads, sorted(op.appends.items()), op.ranges, op.ephemeral)
            for op in (profile.next_op() for _ in range(n))]


def test_arrivals_and_profiles_match_jax():
    """Every schedule's offsets and every profile's op stream (the txn each
    op builds included) are == for the same seeds."""
    jax_w, port_w = map(_workload, PACKAGES)
    assert sorted(port_w.PROFILES) == sorted(jax_w.PROFILES)
    for kind in ("poisson", "paced"):
        for seed in (0, 11, 17):
            for rate in (30.0, 300.0):
                assert port_w.make_offsets_us(kind, rate, 500, seed) == \
                    jax_w.make_offsets_us(kind, rate, 500, seed)
    with pytest.raises(ValueError):
        port_w.make_offsets_us("bursty", 1.0, 1)
    for name in sorted(jax_w.PROFILES):
        for seed, keys in ((3, 48), (17, 1_000_000)):
            want = jax_w.make_profile(name, keys=keys, seed=seed)
            got = port_w.make_profile(name, keys=keys, seed=seed)
            assert _ops(got, 400) == _ops(want, 400), name
            op = want.next_op()
            assert repr(got.next_op()) == repr(op)
            assert repr(port_w.build_txn(op)) == repr(jax_w.build_txn(op))


def test_open_loop_sim_matches_jax():
    """``run_open_loop_sim`` for each SLO lane's profile at 80 ops, and a
    stalled run: the SLO reports (counts, open- and closed-loop quantiles,
    per-phase quantiles) are ==."""
    jax_w, port_w = map(_workload, PACKAGES)
    runs = [dict(profile=p, ops=80, rate_per_s=100.0, seed=11, keys=48)
            for p in LANE_PROFILES]
    runs.append(dict(profile="zipfian", ops=60, rate_per_s=100.0, seed=5,
                     stall_at_us=200_000, stall_us=300_000,
                     schedule="paced"))
    for kw in runs:
        want = jax_w.run_open_loop_sim(**kw).report
        got = port_w.run_open_loop_sim(**kw).report
        assert got == want, kw
        assert want["counts"]["acked"] > 0, kw


def _jax_lane(monkeypatch, fn, *args):
    """A JAX bench lane's JSON object, caught before its history write."""
    emitted = []
    monkeypatch.setattr(jax_bench, "emit", emitted.append)
    fn(*args)
    return emitted[0]


def _without_port_keys(result):
    result = json.loads(json.dumps(result))
    for k in ("device", "hardware", "stores", "wall_seconds"):
        del result[k]
    return result


@pytest.mark.slow
@pytest.mark.parametrize("config", sorted(port_bench.SLO_SIM_LANES))
def test_slo_sim_lanes_match_jax(monkeypatch, config):
    """The four sim SLO lanes at full size with the scalar stores: the
    port's object, less where its stores ran, == the JAX lane's."""
    want = _jax_lane(monkeypatch, jax_bench.bench_slo_sim, config)
    got = port_bench.slo_sim_lane(config, store_factory=CommandStore)
    assert _without_port_keys(got) == json.loads(json.dumps(want))


@pytest.mark.slow
def test_run_wan_sim_matches_jax():
    """The WAN runner on ``wan3_profile``: the minimal electorate from the
    hub and from a WAN DC, and the dc_b partition arm, == the JAX runs."""
    from accord_tpu.workload.openloop import run_wan_sim as jax_wan
    from accord_tpu_torch.workload.openloop import run_wan_sim as port_wan
    minimal = frozenset({1, 2, 3, 5})
    for kw in (dict(electorate=minimal, origin=1),
               dict(electorate=None, origin=5),
               dict(electorate=minimal, origin=1,
                    partition=("dc_b", 500_000, 2_000_000))):
        want = jax_wan(ops=80, rate_per_s=30.0, seed=29, **kw)
        got = port_wan(ops=80, rate_per_s=30.0, seed=29, **kw)
        assert got.report == want.report, kw
        assert got.summary["wan"] == want.summary["wan"], kw


@pytest.mark.slow
def test_slo_wan_lane_matches_jax(monkeypatch, tmp_path):
    """The WAN lane at full size with the scalar stores == the JAX lane
    (the flat baseline row comes from each package's history file, the
    JAX lane's from its tcp row, the port's from its tcp+device row: here
    the port's history is empty, and the JAX lane's baseline is left
    out)."""
    from accord_tpu_torch import bench_guard
    monkeypatch.setattr(bench_guard, "HISTORY_PATH",
                        str(tmp_path / "history.json"))
    want = _jax_lane(monkeypatch, jax_bench.bench_slo_wan)
    want["slo"]["wan"]["flat_tcp_baseline"] = None
    got = port_bench.slo_wan_lane(store_factory=CommandStore)
    assert _without_port_keys(got) == json.loads(json.dumps(want))


@pytest.mark.slow
def test_slo_zipf1m_lane_matches_jax(monkeypatch):
    """The bounded-memory lane with the scalar stores == the JAX lane."""
    want = _jax_lane(monkeypatch, jax_bench.bench_slo_zipf1m)
    got = port_bench.slo_zipf1m_lane(store_factory=CommandStore)
    assert _without_port_keys(got) == json.loads(json.dumps(want))


@pytest.mark.slow
def test_zipf1m_device_fingerprint_matches_jax(monkeypatch):
    """``workload.ZIPF1M_DEVICE_FINGERPRINT``, which the card's run of the
    lane is held to, is the JAX package's: the JAX lane with its stores the
    JAX DeviceCommandStore (300 µs windows, verify on) reduces to it, and so
    does the port's lane with its device stores on the CPU."""
    import accord_tpu.workload as jax_w
    from accord_tpu.impl.device_store import DeviceCommandStore
    from accord_tpu.local.paging import node_paging_stats as jax_stats
    from accord_tpu_torch.local.paging import node_paging_stats
    from accord_tpu_torch.workload import (ZIPF1M_DEVICE_FINGERPRINT,
                                           open_loop_fingerprint)

    runs = []
    run_sim = jax_w.run_open_loop_sim

    def device_run(**kw):
        runs.append(run_sim(store_factory=DeviceCommandStore.factory(
            flush_window_us=port_bench.SLO_FLUSH_WINDOW_US, verify=True),
            **kw))
        return runs[-1]
    monkeypatch.setattr(jax_w, "run_open_loop_sim", device_run)
    _jax_lane(monkeypatch, jax_bench.bench_slo_zipf1m)
    assert len(runs) == 1
    want = json.loads(json.dumps(open_loop_fingerprint(runs[0], jax_stats)))
    assert want == json.loads(json.dumps(ZIPF1M_DEVICE_FINGERPRINT))
    _, run = port_bench.slo_zipf1m_run(device="cpu")
    got = json.loads(json.dumps(open_loop_fingerprint(run,
                                                      node_paging_stats)))
    assert got == want
