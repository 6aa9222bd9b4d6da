"""On the card: a short run of each cell, and of a range cell added as
data, is correct and reads the device through the profiler's trace.  Skips
where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from accord_bench.tests import range_cell
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


@pytest.mark.cuda
def test_range_cell_on_the_card(card, tmp_path):
    """The range cell (range_cell.py) added as data: correct on the card,
    its range arm served from the card's stab and traced as bench.ranges."""
    cell = range_cell.add_range_cell(ROOT, tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "accord_bench.run", "--workload", cell,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert sum(line["info"]["device_range_hits"]) > 0
    assert line["info"]["least_bytes"]["bench.ranges"] > 0
    assert 0 < line["metrics"]["step_roofline"]["value"] <= 100
