"""A run with its timed path broken underneath comes out not correct.

Each fault is planted in the program, in the process of a run, before the
harness drives it (``--device cpu`` in place of the card): the deps step
returning its output as it was allocated (a step that leaves its state
unchanged), the deps step computing only the first half of its batch,
its answers altered where they are produced (each probe's first
dependency dropped), Apply returning success without applying, the
flush's deps precompute skipped (every scan then served on the host, with
the same answers), and the wave plan's waves altered (the store's
WaitingOn machinery still orders every execution, so only the plan is
wrong).  On a range configuration, two more: the flush's range stab
skipped (every range-arm query then served on the host) and each stab
row's first hit cleared (a range dependency dropped where the card finds
it).  The exchange between chips is no fault these one-chip cells can
have."""

import json
import os
import subprocess
import sys

import pytest

from accord_bench.tests import range_cell
from accord_bench.tests.test_bench_harness import ROOT, TINY

FAULTS = {
    "deps_unchanged": """
import torch
from accord_tpu_torch.impl import device_store as ds
real = ds.batched_active_deps_cuda
def fault(*args):
    mask, count = real(*args)
    return torch.zeros_like(mask), torch.zeros_like(count)
ds.batched_active_deps_cuda = fault
""",
    "deps_half_batch": """
from accord_tpu_torch.impl import device_store as ds
real = ds.batched_active_deps_cuda
def fault(*args):
    mask, count = real(*args)
    mask = mask.clone()
    mask[mask.shape[0] // 2:] = False
    return mask, count
ds.batched_active_deps_cuda = fault
""",
    "deps_answer_altered": """
from accord_tpu_torch.impl import device_store as ds
real = ds.batched_active_deps_cuda
def fault(*args):
    mask, count = real(*args)
    mask = mask.clone()
    rows = mask.any(dim=1).nonzero().flatten()
    mask[rows, mask[rows].int().argmax(dim=1)] = False
    return mask, count
ds.batched_active_deps_cuda = fault
""",
    "precompute_skipped": """
from accord_tpu_torch.impl import device_store as ds
ds.DeviceCommandStore._precompute = lambda self, window: None
""",
    "waves_altered": """
from accord_tpu_torch.impl import device_store as ds
real = ds.DeviceCommandStore._plan_waves
def fault(self, window):
    plan = real(self, window)
    return plan and {t: (0, eat) for t, (_w, eat) in plan.items()}
ds.DeviceCommandStore._plan_waves = fault
""",
    "apply_unchanged": """
from accord_tpu_torch.local import commands as C
C.apply = lambda *a, **k: C.ApplyOutcome.SUCCESS
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["ycsb-a.win512", "tpcc.win128"])
def test_fault_is_not_correct(fault, cell):
    args = ["--workload", cell, "--seed", str(2**31 + 3), *TINY]
    code = FAULTS[fault] + (
        "\nimport sys\nfrom accord_bench import run\n"
        f"sys.exit(run.main({args!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


# faults of the range-conflict arm, on the range cell (range_cell.py), and
# the number each must fail
RANGE_FAULTS = {
    "ranges_skipped": ("""
from accord_tpu_torch.impl import device_store as ds
ds.DeviceCommandStore._precompute_ranges = lambda self, window: None
""", "range_scans_off_card"),
    "range_deps_dropped": ("""
from accord_tpu_torch.impl import device_store as ds
real = ds.range_stab_mask
def fault(*args):
    mask = real(*args).clone()
    rows = mask.any(dim=1).nonzero().flatten()
    mask[rows, mask[rows].int().argmax(dim=1)] = False
    return mask
ds.range_stab_mask = fault
""", "replies_wrong"),
}


@pytest.mark.parametrize("fault", sorted(RANGE_FAULTS))
def test_range_fault_is_not_correct(fault, tmp_path):
    cell = range_cell.add_range_cell(ROOT, tmp_path)
    plant, number = RANGE_FAULTS[fault]
    args = ["--workload", cell, "--seed", str(2**31 + 3), "--device", "cpu",
            "--warmup-windows", "3", "--max-windows", "4", "--seconds",
            "600"]
    code = plant + ("\nimport sys\nfrom accord_bench import run\n"
                    f"sys.exit(run.main({args!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
