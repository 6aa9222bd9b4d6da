"""The program's spans over a traced run (``spans.py``) on the CPU: the
reduction by hand, the accepted reduction and readers blind to the new
ranges, and each cell at a tiny length."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from accord_bench import run, spans, trace

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = ["--device", "cpu", "--warmup-windows", "2", "--max-windows", "2",
        "--seconds", "600"]


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


# the harness's own spans and the card's ops: window [0, 1000), idle
# [0, 40) [70, 95) [150, 1000)
HARNESS = [
    ev("user_annotation", "window", 0, 1000),
    ev("user_annotation", "flush.deps", 0, 100),
    ev("user_annotation", "bench.deps", 10, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
    ev("kernel", "deps_tile_kernel", 40, 30, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 90, 1, correlation=2),
    ev("kernel", "other_kernel", 95, 5, correlation=2),
    ev("gpu_memcpy", "Memcpy DtoH", 100, 50, correlation=3),
    ev("user_annotation", "serve.commit", 200, 500),
    ev("user_annotation", "serve.apply", 700, 100),
    ev("kernel", "late_kernel", 1200, 10, correlation=4),
]
# the program's ranges, under two categories, and a device twin of one
PROGRAM = [
    ev("user_annotation", "accord.flush", 0, 900),
    ev("cpu_op", "accord.deps.encode", 5, 30),
    ev("user_annotation", "accord.deps.download", 40, 110),
    ev("gpu_user_annotation", "accord.deps.download", 40, 110),
    ev("user_annotation", "accord.op.commit", 200, 500),
    ev("user_annotation", "accord.op.index", 250, 100),
    ev("user_annotation", "accord.op.execute", 400, 200),
    ev("user_annotation", "accord.op.execute", 450, 50),
    ev("user_annotation", "accord.op.index", 1100, 50),
]


def test_span_reduction_by_hand():
    got = spans.reduce_spans(HARNESS + PROGRAM, (0.0, 1000.0))
    s = got["spans"]
    assert s["accord.flush"] == {"count": 1, "total_s": pytest.approx(9e-4),
                                 "self_s": pytest.approx(260e-6)}
    assert s["accord.op.commit"]["self_s"] == pytest.approx(200e-6)
    # the execute inside an execute is its own child
    assert s["accord.op.execute"] == {
        "count": 2, "total_s": pytest.approx(250e-6),
        "self_s": pytest.approx(200e-6)}
    # the range after the window is left out, the device twin too
    assert s["accord.op.index"]["count"] == 1
    assert s["accord.deps.download"]["count"] == 1
    assert s["accord.deps.encode"]["self_s"] == pytest.approx(30e-6)
    idle = got["idle_by_span"]
    # [0, 5) and [35, 40) flush, [5, 35) encode, [70, 95) and the end of
    # download's [40, 150) idle, [150, 200) flush, ...
    assert idle["accord.deps.encode"] == pytest.approx(30e-6)
    assert idle["accord.deps.download"] == pytest.approx(25e-6)
    assert idle["accord.flush"] == pytest.approx((10 + 50 + 200) * 1e-6)
    assert idle["accord.op.commit"] == pytest.approx(200e-6)
    assert idle["accord.op.index"] == pytest.approx(100e-6)
    assert idle["accord.op.execute"] == pytest.approx(200e-6)
    assert idle["outside"] == pytest.approx(100e-6)
    assert got["idle_s"] == pytest.approx(915e-6)
    assert sum(idle.values()) == pytest.approx(got["idle_s"], rel=1e-12)
    # the accepted breakdown's harness gap, 250 µs: [150, 200) and
    # [800, 900) under the flush alone, [900, 1000) outside every range
    harness = {n: v for n, v in got["harness_by_span"].items()
               if abs(v) > 1e-12}
    assert harness == {"accord.flush": pytest.approx(150e-6),
                       "outside": pytest.approx(100e-6)}
    assert spans.per_txn(s, 2) == {
        "encode_ms_per_txn": pytest.approx(0.015),
        "copy_host_ms_per_txn": pytest.approx(0.055),
        "op_index_ms_per_txn": pytest.approx(0.05),
        "op_execute_ms_per_txn": pytest.approx(0.1)}


def test_accepted_reduction_and_readers_blind_to_the_program_spans():
    window = trace.window_bounds(HARNESS, "window")
    before = trace.reduce_trace(HARNESS, window)
    after = trace.reduce_trace(HARNESS + PROGRAM, window)
    assert after == before
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    def readers(summary):
        r = SimpleNamespace(
            device="cuda", seconds=2.0, txns=1000, windows=4,
            laps_s={"deps_encode": 0.1, "deps_kernel": 0.2},
            lifecycle_ms=list(range(1, 101)), trace=summary,
            least_bytes={"bench.deps": 3.35e9})
        return {m["name"]: run.read_metric(m["name"], r)
                for m in bench["per_layer"]}
    assert readers(after) == readers(before)
    assert None not in readers(before).values()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_spans_on_the_cpu(cell):
    p = subprocess.run(
        [sys.executable, "-m", "accord_bench.spans", "--workload", cell,
         "--seed", str(2**31 + 5), *TINY], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    *_, line, found = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert line["correct"] is True
    assert set(line["metrics"]) <= {m["name"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    assert set(found["metrics"]) == set(spans.PER_TXN)
    assert all(v > 0 for v in found["metrics"].values())
    assert found["txns"] == line["info"]["txns"]
    assert sum(found["idle_by_span"].values()) == pytest.approx(
        found["idle_s"], rel=1e-9)
    assert found["harness_by_span"]
    c = found["counters"]
    assert c["device_flush_windows"] == 2
    assert c["copy_bytes_h2d"] > 0 and c["copy_bytes_d2h"] > 0
    assert c["device_served_deps"] >= 0 and c["device_encoded_entries"] > 0
    assert c["wave_plans"] == c["device_wave_batches"]
    assert c["wave_depth_sum"] >= c["wave_plans"]
