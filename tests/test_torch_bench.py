"""The port's bench lanes on the CPU at small sizes.

Each lane checks its own answer (the default lane's edges against the scalar
scan, the rangestress lane's host sample) and, on the CPU, reports no rate.
"""

import pytest
import torch

from accord_tpu_torch import bench, tpcc, workload
from accord_tpu_torch.ops.range_kernel import stab_counts_sorted


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
