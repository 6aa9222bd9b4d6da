"""On the card: a short run of each cell is correct and reads the device
through the profiler's trace.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from accord_bench.tests.test_bench_harness import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "-m", "accord_bench.run", "--workload", cell,
         "--seed", str(2**31 + 1), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    assert 0 < line["metrics"]["step_roofline"]["value"] <= 100
