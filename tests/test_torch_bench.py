"""The port's bench lanes on the CPU at small sizes.

Each lane checks its own answer (the default lane's edges against the scalar
scan, the rangestress lane's host sample) and, on the CPU, reports no rate.
The port takes every ``--config`` of the JAX package's ``bench.py``, and the
host-only lanes' deterministic fields are the JAX lanes' (their ``emit`` is
caught, so nothing writes the history file).
"""

import ast
from pathlib import Path

import pytest
import torch

from accord_tpu_torch import bench, tpcc, workload
from accord_tpu_torch.ops.range_kernel import stab_counts_sorted

JAX_BENCH = Path(__file__).resolve().parent.parent / "bench.py"


def test_default_lane_on_cpu():
    world = workload.build_world(n_keys=64, n_existing=800, n_batch=64,
                                 seed=3)
    out = bench.default_lane(world, device="cpu")
    assert out["metric"] == "conflict_graph_edges_resolved_per_sec"
    assert out["edges"] == workload.scalar_edges_per_sec(*world)[1] > 0
    assert out["device"] == "cpu" and out["hardware"] == "cpu"
    assert out["value"] is None and out["vs_baseline"] is None


def test_rangestress_lane_on_cpu():
    inputs = workload.rangestress_inputs(n_ranges=30_000, n_txns=300, seed=7)
    out = bench.rangestress_lane(inputs, device="cpu")
    assert out["metric"] == "rangestress_edges_resolved_per_sec"
    assert out["edges"] == int(stab_counts_sorted(*inputs[:4]).sum()) > 0
    assert (out["txns"], out["intervals"]) == (300, 30_000)
    assert out["device"] == "cpu" and out["value"] is None
    assert out["txns_per_sec"] is None and out["device_seconds"] is None


def test_tpcc_lane_on_cpu():
    out = bench.tpcc_lane(device="cpu", n_txns=3000, window=256)
    want = tpcc.replay(n_txns=3000, window=256, device="cpu")
    assert out["metric"] == "tpcc_neworder_resolve_ms"
    assert out["value"] is None and out["device"] == "cpu"
    for k in ("edges", "edges_cross_window", "edges_in_window",
              "max_wave_depth", "windows"):
        assert out[k] == want[k]


def test_bench_cli_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--config", "rangestress"])


def _jax_configs() -> set:
    """The ``choices`` of the JAX bench's ``--config``, read from its source
    (the module is not imported)."""
    for node in ast.walk(ast.parse(JAX_BENCH.read_text())):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "--config":
            choices = next(k.value for k in node.keywords
                           if k.arg == "choices")
            return set(ast.literal_eval(choices))
    raise AssertionError("no --config in the JAX bench")


def test_lanes_cover_every_jax_config():
    configs = _jax_configs()
    assert len(configs) == 22
    assert set(bench.LANES) == configs
    assert set(bench.HOST_LANES) <= configs
    with pytest.raises(SystemExit):
        bench.main(["--config", "scalar", "--device", "cpu"])


def _jax_lane(monkeypatch, fn, **kwargs):
    """A JAX bench lane's JSON object, caught before its history write."""
    import bench as jax_bench
    emitted = []
    monkeypatch.setattr(jax_bench, "emit", emitted.append)
    fn(**kwargs)
    return emitted[0]


def test_scalar_lane_matches_jax(monkeypatch):
    import bench as jax_bench
    sizes = dict(n_keys=64, n_existing=2048, n_batch=64)
    want = _jax_lane(monkeypatch, jax_bench.bench_scalar, **sizes)
    got = bench.scalar_lane(**sizes)
    assert got["edges"] == want["edges"] > 0
    assert (got["metric"], got["unit"], got["txns"]) == \
        (want["metric"], want["unit"], want["txns"])
    assert got["profile"]["kernels"]["scalar_scan"]["count"] == \
        want["profile"]["kernels"]["scalar_scan"]["count"] == 64


def test_audit_lane_matches_jax(monkeypatch):
    import bench as jax_bench
    want = _jax_lane(monkeypatch, jax_bench.bench_audit, ops=60, seed=11)
    got = bench.audit_lane(ops=60, seed=11)
    for k in ("metric", "unit", "budget_pct", "resident_cmds",
              "digest_folded", "audit_rounds_at_quiesce"):
        assert got[k] == want[k], k
    assert got["resident_cmds"] > 0
