"""The harness end to end on the CPU: every cell at a tiny length, the
result line's schema, the trace reduction, the readers, the rules a run
keeps (no card, no jax, nothing but the benchmark's files), and a cell
added as data alone."""

import json
import os
import shutil
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import pytest

from accord_bench import roofline, run, trace
from accord_bench.tests import range_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# two warm-up windows and two measured ones
TINY = ["--device", "cpu", "--warmup-windows", "2", "--max-windows", "2",
        "--seconds", "600"]


def harness(args, cwd=ROOT, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "accord_bench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_line(p):
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_cpu(cell, traced):
    p = harness(["--workload", cell, "--seed", str(2**31 + 11), "--trace",
                 str(traced), *TINY])
    line = last_line(p)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["count"] == 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if traced else "end_to_end"]}
    assert set(line["metrics"]) <= want
    if traced:
        # the host metrics are read; no device metric from a CPU run
        assert {"serve_ms_per_txn", "flush_host_ms_per_txn",
                "lifecycle_p95_ms"} & set(line["metrics"])
        assert not {"kernel_ms_per_txn", "step_roofline",
                    "device_idle_pct"} & set(line["metrics"])
        assert "busy_s" not in line["device"]
    else:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    # each number compared, beside its limit, ends standard error
    err = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert err == [f"check {k} {v['value']} limit {v['limit']}"
                   for k, v in line["checks"].items()]


def test_same_seed_same_answers():
    lines = [last_line(harness(["--workload", "ycsb-a.win512", "--seed", "9",
                                *TINY])) for _ in range(2)]
    assert lines[0]["attempted"] == lines[1]["attempted"]
    assert lines[0]["info"]["entries_last"] == lines[1]["info"]["entries_last"]


def test_no_card_no_result():
    p = harness(["--workload", "ycsb-a.win512", "--seed", "1", "--seconds",
                 "1"])
    assert p.returncode == 2 and p.stdout == ""


def test_only_the_benchmark_files_is_not_enough(tmp_path):
    shutil.copytree(ROOT / "accord_bench", tmp_path / "accord_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = harness(["--workload", "ycsb-a.win512", "--seed", "1", *TINY],
                cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout == ""


def test_a_cell_added_as_data_alone(tmp_path):
    shutil.copytree(ROOT / "accord_bench", tmp_path / "accord_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "accord_bench/traffic/lifecycle-w128.json")
                     .read_text())
    mix.update(window=24, warmup_txns=96)
    (tmp_path / "accord_bench/traffic/lifecycle-w24.json") \
        .write_text(json.dumps(mix))
    bench["workloads"].append({
        "name": "tpcc.win24", "config": "tpcc",
        "traffic": "lifecycle-w24", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    line = last_line(harness(["--workload", "tpcc.win24", "--seed", "4",
                              "--device", "cpu", "--warmup-windows", "4",
                              "--max-windows", "3", "--seconds", "600"],
                             cwd=tmp_path, env=env))
    assert line["correct"] is True and line["attempted"] == 3 * 24
    assert line["info"]["warmup_windows"] == 4


def test_the_window_is_a_fixed_number_of_windows():
    mix = {"windows_per_s": 0.6}
    assert run.measured_windows(mix, 51) == 31
    assert run.measured_windows(mix, 0.1) == 1
    # without --max-windows the mix's rate sets the windows
    line = last_line(harness(["--workload", "ycsb-a.win512", "--seed", "6",
                              "--device", "cpu", "--warmup-windows", "2",
                              "--seconds", "1.2"]))
    mix = json.loads((ROOT / "accord_bench/traffic/lifecycle-w512.json")
                     .read_text())
    assert line["info"]["windows"] == run.measured_windows(mix, 1.2) > 1
    assert line["attempted"] == 512 * line["info"]["windows"]


def test_nothing_loads_jax_or_the_jax_package():
    args = ["--workload", "ycsb-a.win512", "--seed", "3", "--trace", "1",
            *TINY]
    code = ("import sys\nfrom accord_bench import run\n"
            f"rc = run.main({args!r})\n"
            "print(rc, sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'accord_tpu'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "0 []"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport accord_bench.check, accord_bench.control\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'accord_tpu_torch', 'accord_tpu', 'jax', 'torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]


def test_roofline_bytes_by_hand():
    # K6 24 E; K1 B*K + 24 E + 8 B + B*E + 4 B
    assert roofline.deps_bytes(2, 3, 5) == 120 + (6 + 120 + 16 + 10 + 8)
    assert roofline.deps_bytes(0, 3, 5) == 0
    assert roofline.graph_bytes(2, 3) == 24 + 6 + 4
    assert roofline.waves_bytes(2) == 4 + 8 + 8
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction_by_hand():
    events = [
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
    s = trace.reduce_trace(events, trace.window_bounds(events, "window"))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(85e-6)
    assert s["kernel_s"] == pytest.approx(35e-6)
    assert s["step_s"] == {"bench.deps": pytest.approx(30e-6)}
    gaps = dict(s["idle_gaps"])
    # idle: [0, 40) [70, 95) [150, 1000); flush.deps covers [0, 100)
    assert gaps["flush.deps"] == pytest.approx(65e-6)
    assert gaps["serve.commit"] == pytest.approx(500e-6)
    assert gaps["serve.apply"] == pytest.approx(100e-6)
    assert gaps["harness"] == pytest.approx(250e-6)
    assert s["device_ops"][0] == ["Memcpy DtoH", pytest.approx(50e-6)]


def test_readers_read_or_return_nothing():
    bare = SimpleNamespace(device="cpu", seconds=2.0, txns=0, windows=1,
                           laps_s={}, lifecycle_ms=[], trace=None,
                           least_bytes={})
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert run.read_metric(m["name"], bare) is None
    full = SimpleNamespace(
        device="cuda", seconds=2.0, txns=1000, windows=4,
        laps_s={"deps_encode": 0.1, "deps_kernel": 0.2, "deps_decode": 0.1},
        lifecycle_ms=list(range(1, 101)),
        trace={"kernel_s": 0.01, "busy_s": 0.02, "window_s": 2.0,
               "step_s": {"bench.deps": 0.004}},
        least_bytes={"bench.deps": 3.35e9})
    got = {m["name"]: run.read_metric(m["name"], full)
           for m in bench["per_layer"]}
    assert got["serve_ms_per_txn"] == pytest.approx(1.6)
    assert got["flush_host_ms_per_txn"] == pytest.approx(0.2)
    assert got["kernel_ms_per_txn"] == pytest.approx(0.01)
    assert got["step_roofline"] == pytest.approx(25.0)
    assert got["device_idle_pct"] == pytest.approx(99.0)
    assert 95 <= got["lifecycle_p95_ms"] <= 96


# run a cell in the current directory and print, after run.py's line, the
# count of the program's PreAccept and Accept replies that hold a range dep
SPY_RANGE_DEPS = """
import json, sys
from accord_bench import check, run
judge, seen = check.judge, {}
def spy(traffic, got):
    seen["range_deps"] = sum(1 for replies in got.replies for r in replies
                             if r[0] in ("preaccept", "accept") and r[-1][1])
    return judge(traffic, got)
check.judge = spy
rc = run.main(ARGS)
print(json.dumps(seen))
sys.exit(rc)
"""


def test_a_range_cell_added_as_data_alone(tmp_path):
    cell = range_cell.add_range_cell(ROOT, tmp_path)
    args = ["--workload", cell, "--seed", str(2**31 + 23), "--device", "cpu",
            "--warmup-windows", "3", "--max-windows", "6", "--seconds", "600"]
    p = subprocess.run(
        [sys.executable, "-c", SPY_RANGE_DEPS.replace("ARGS", repr(args))],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    *_, printed, spied = p.stdout.strip().splitlines()
    line = json.loads(printed)
    assert line["correct"] is True and line["attempted"] == 6 * 32
    info = line["info"]
    assert sum(info["device_range_hits"]) > 0
    assert sum(info["device_misses"]["key_cover"]) > 0
    assert info["counters"]["device_range_hits"] \
        == sum(info["device_range_hits"])
    assert line["checks"]["range_scans_off_card"] == {"value": 0,
                                                      "limit": 0}
    assert json.loads(spied)["range_deps"] > 0


def test_range_bytes_by_hand():
    # int32 starts and ends of N intervals, int32 bounds of Q queries, the
    # [Q, N] bool mask
    assert roofline.range_bytes(2, 3) == 4 * (2 * 3 + 2 * 2) + 2 * 3
    assert roofline.range_bytes(0, 0) == 0


def test_the_range_stab_is_traced_as_bench_ranges():
    import torch
    from accord_tpu_torch.ops.range_kernel import range_stab_mask
    opened = []

    def record_function(name):
        opened.append(name)
        return nullcontext()
    module = SimpleNamespace(batched_active_deps_cuda=None,
                             in_batch_graph=None, execution_waves_cuda=None,
                             range_stab_mask=range_stab_mask)
    recorder = trace.StepRecorder(record_function)
    recorder.wrap(module)
    starts, ends = torch.tensor([0, 5, 9]), torch.tensor([4, 8, 12])
    qs, qe = torch.tensor([3, 8]), torch.tensor([6, 9])
    mask = module.range_stab_mask(starts, ends, qs, qe)
    assert mask.tolist() == [[True, True, False], [False, False, False]]
    assert opened == ["bench.ranges"]
    assert recorder.least_bytes == {"bench.ranges":
                                    roofline.range_bytes(2, 3)}


def test_step_roofline_reads_only_its_steps():
    def reading(least_bytes, step_s):
        return run.read_metric("step_roofline", SimpleNamespace(
            device="cuda", trace={"step_s": step_s},
            least_bytes=least_bytes))
    steps = {"bench.deps": 3.35e9}
    assert reading(steps, {"bench.deps": 0.004}) == pytest.approx(25.0)
    assert reading(dict(steps, **{"bench.ranges": 1e12}),
                   {"bench.deps": 0.004, "bench.ranges": 0.001}) \
        == pytest.approx(25.0)
    assert reading({"bench.ranges": 1e9}, {"bench.ranges": 0.001}) is None
