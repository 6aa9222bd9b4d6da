"""The port's hostile-seed soak against the reference soak and the JAX burn.

``accord_tpu_torch/soak.py`` keeps the reference soak's arms (read here from
the root ``soak.py`` with ``ast``: importing it would run nothing, but the
port's tests read reference scripts as text), its classification and its
expected-lines file covers the whole wave-1 matrix.  The ``slow`` cases run
one seed of each arm through the port's soak on the CPU and hold each line
``==`` the recorded line and ``==`` a live JAX burn's.

This file is also the recorder of the expected lines.  They come from the
JAX package's burn on the CPU, with the reference soak's environment (the
mesh arms on an 8-device virtual mesh):

    JAX_PLATFORMS=cpu python -m tests.test_torch_soak --record \\
        accord_tpu_torch/soak_lines.json --jobs 4
"""

import ast
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from accord_tpu_torch import soak

REPO = Path(__file__).resolve().parent.parent

SEEDS_PER_ARM, OPS = 16, 60
JAX_BURN = "accord_tpu.sim.burn"


def _reference_arms():
    tree = ast.parse((REPO / "soak.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "ARMS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("soak.py defines no ARMS")


def _jax_env(mesh: bool) -> dict:
    """The reference soak's environment for a JAX burn (soak.py:62-65)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    if mesh:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    return env


def record(path, seeds_per_arm=SEEDS_PER_ARM, ops=OPS, jobs=4,
           timeout_s=900):
    """Run every seed of the matrix through the JAX package's burn and
    write the expected-lines file: per seed the arm, the seed, the burn
    arguments, the line and the reference soak's class of the run."""
    jobs_list = [(name, base + i, extra, mesh)
                 for i in range(seeds_per_arm)
                 for name, base, extra, mesh in soak.ARMS]

    def one(job):
        name, seed, extra, mesh = job
        rec = soak.run_seed(name, seed, ops, extra, timeout_s, device=None,
                            burn_module=JAX_BURN, env=_jax_env(mesh))
        print(f"{rec['status']} {name} seed={seed} ({rec['secs']} s)",
              flush=True)
        return {"arm": name, "seed": seed,
                "args": soak.burn_args(seed, ops, extra),
                "status": rec["status"], "line": rec["line"]}

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        entries = list(pool.map(one, jobs_list))
    entries.sort(key=lambda e: (e["seed"] // 1000, e["seed"]))
    Path(path).write_text(json.dumps({
        "source": "python -m accord_tpu.sim.burn ARGS on the CPU "
                  "(JAX_PLATFORMS=cpu; the mesh arms with "
                  "--xla_force_host_platform_device_count=8), recorded by "
                  "tests/test_torch_soak.py --record",
        "seeds_per_arm": seeds_per_arm, "ops": ops,
        "entries": entries}, indent=1) + "\n")
    return entries


# ---------------------------------------------------------------- unmarked --
def test_arms_match_the_reference_soak():
    assert [tuple(a) for a in soak.ARMS] == [tuple(a) for a in
                                             _reference_arms()]


def test_expected_lines_cover_the_matrix():
    expected = soak.load_expected(soak.EXPECTED_LINES)
    assert len(expected) == len(soak.ARMS) * SEEDS_PER_ARM
    for name, base, extra, _ in soak.ARMS:
        for i in range(SEEDS_PER_ARM):
            e = expected[(name, base + i)]
            assert e["args"] == soak.burn_args(base + i, OPS, extra)
            assert e["status"] in ("pass", "zero-ack"), e
            assert e["line"].startswith(f"seed={base + i} ops={OPS} ")
            assert " OK " in e["line"] and "lost=0 pending=0" in e["line"]


OK_LINE = ("seed=7 ops=60 acks=3 nacks=57 shed=0 lost=0 pending=0 "
           "lat_p50=1.0ms lat_p95=2.0ms virtual_time=9.0s events=10 OK "
           "device[hits=1]")
ZERO_LINE = OK_LINE.replace("acks=3 nacks=57", "acks=0 nacks=60")


@pytest.mark.parametrize("rc,stdout,stderr,want", [
    (0, OK_LINE + "\n", "", "pass"),
    (1, ZERO_LINE + "\n", "PATHOLOGICAL: no transaction succeeded\n",
     "zero-ack"),
    # the pathological guard with a lost op is a failure
    (1, ZERO_LINE.replace("lost=0", "lost=1") + "\n",
     "PATHOLOGICAL: no transaction succeeded\n", "fail"),
    (1, "", "Traceback (most recent call last):\nAssertionError\n", "fail"),
    (0, OK_LINE.replace(" OK ", " FAILED ") + "\n", "", "fail"),
])
def test_classifier_on_synthetic_outputs(rc, stdout, stderr, want):
    assert soak.classify(rc, stdout, stderr) == want
    assert soak.summary_line(stdout) == (stdout.strip() or None)


@pytest.mark.parametrize("line,args,want", [
    (OK_LINE, "-s 7 -o 60 --device-verify", None),
    (OK_LINE.replace("events=10", "events=11"), "-s 7 -o 60 --device-verify",
     "summary line != the recorded line"),
    (None, "-s 7 -o 60 --device-verify", "summary line != the recorded line"),
    (OK_LINE, "-s 7 -o 90 --device-verify",
     "no line recorded for these arguments"),
])
def test_a_line_that_differs_from_the_recorded_one_fails(line, args, want):
    """A burn that passes on its own but prints another line than the one
    recorded for the same arguments fails."""
    entry = {"arm": "a", "seed": 7, "args": soak.burn_args(7, 60, []),
             "line": OK_LINE}
    assert soak.line_mismatch(line, entry, args) == want


# -------------------------------------------------------------------- slow --
@pytest.mark.slow
def test_one_seed_of_each_arm_matches_the_recorded_and_the_jax_line(
        tmp_path, monkeypatch):
    """The first seed of each arm through the port's soak on the CPU (its
    ``--expect`` check on), and the same seed through the JAX burn live."""
    expected = soak.load_expected(soak.EXPECTED_LINES)
    state, out = tmp_path / "state.json", tmp_path / "ledger.md"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one core a burn
    rc = soak.main(["--device", "cpu", "--seeds-per-arm", "1",
                    "--jobs", "4", "--expect", str(soak.EXPECTED_LINES),
                    "--out", str(out), "--state", str(state)])
    runs = json.loads(state.read_text())["runs"]
    assert rc == 0 and len(runs) == len(soak.ARMS), runs
    assert "No failures." in out.read_text()

    def live(arm):
        name, base, extra, mesh = arm
        return soak.run_seed(name, base, OPS, extra, 900, device=None,
                             burn_module=JAX_BURN, env=_jax_env(mesh))

    with ThreadPoolExecutor(max_workers=4) as pool:
        jax_runs = list(pool.map(live, soak.ARMS))
    by_arm = {r["arm"]: r for r in runs}
    for name, base, _, _ in soak.ARMS:
        want = expected[(name, base)]["line"]
        assert by_arm[name]["line"] == want, name
        assert jax_runs[[a[0] for a in soak.ARMS].index(name)]["line"] \
            == want, name


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(prog="python -m tests.test_torch_soak")
    ap.add_argument("--record", required=True, metavar="FILE")
    ap.add_argument("--jobs", type=int, default=4)
    ns = ap.parse_args()
    got = record(ns.record, jobs=ns.jobs)
    print(f"recorded {len(got)} lines: "
          f"{sum(e['status'] == 'fail' for e in got)} failed")
