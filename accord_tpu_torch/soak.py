#!/usr/bin/env python
"""Hostile-seed soak of the port's device stores.

Runs burn seeds as subprocesses across the reference soak's matrix of
nemesis arms (flat / mesh / delayed-composed device stores x loss x
partitions x drift x store counts x contention x range-heavy mixes), with
inline device verification on everywhere, and writes a ledger to a file the
caller names.  Each seed runs

    python -m accord_tpu_torch.sim.burn -s SEED -o OPS --device-verify \\
        --device DEVICE <arm's arguments>

on the CUDA card by default (``--device cpu`` runs the plain PyTorch
versions).  The mesh store stacks its shards on one device, so the mesh arms
need no virtual mesh.  There is no CPU fallback: a seed whose burn cannot
reach the card fails.

The simulation runs on virtual time, so the backend does not change a seed's
summary line.  ``--expect FILE`` (``soak_lines.json`` beside this module:
the JAX package's burn on the CPU, 8 arms x 16 seeds at 60 ops) holds each
seed's line ``==`` the recorded one; a seed whose line differs fails and its
ledger entry carries both lines.

Usage:  python -m accord_tpu_torch.soak --out LEDGER.md --state STATE.json
            [--seeds-per-arm N] [--ops N] [--jobs N] [--device cuda|cpu]
            [--expect accord_tpu_torch/soak_lines.json]

The state file makes a soak resumable: a seed already in it is not run
again, so a matrix can be split over several invocations.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BURN_MODULE = "accord_tpu_torch.sim.burn"
EXPECTED_LINES = HERE / "soak_lines.json"

# (name, seed_base, extra burn args, needs_virtual_mesh): the reference
# soak's arms, unchanged.  The last field says whether the JAX burn needs a
# virtual device mesh for the arm (its mesh store shards over jax devices);
# the port's burn needs none.
ARMS = [
    ("device-loss12-part-drift-4stores",
     51000, ["--device-store", "--drop", "0.12", "--partitions", "--drift",
             "--stores", "4"], False),
    ("device-loss25-part-drift-8stores-contended",
     52000, ["--device-store", "--drop", "0.25", "--partitions", "--drift",
             "--stores", "8", "--keys", "6"], False),
    ("device-delayed-loss15-part",
     53000, ["--device-store", "--delayed-stores", "--drop", "0.15",
             "--partitions", "--stores", "4"], False),
    ("mesh-loss12-part-drift",
     54000, ["--mesh-store", "--drop", "0.12", "--partitions", "--drift",
             "--stores", "4"], True),
    ("mesh-delayed-loss15-contended-rangeheavy",
     55000, ["--mesh-store", "--delayed-stores", "--drop", "0.15",
             "--keys", "6", "--range-heavy"], True),
    ("device-loss20-partialrepl-contended",
     56000, ["--device-store", "--drop", "0.2", "--nodes", "4", "--rf", "3",
             "--keys", "6", "--shards", "8"], False),
    ("device-loss25-rangeheavy-part",
     57000, ["--device-store", "--drop", "0.25", "--partitions",
             "--range-heavy", "--stores", "4"], False),
    ("mesh-loss25-part-drift-8stores-contended",
     58000, ["--mesh-store", "--drop", "0.25", "--partitions", "--drift",
             "--stores", "8", "--keys", "6"], True),
]


def burn_args(seed: int, ops: int, extra: List[str]) -> str:
    """A seed's burn arguments as the expected-lines file keys them."""
    return " ".join(["-s", str(seed), "-o", str(ops), "--device-verify",
                     *extra])


def load_expected(path) -> Dict[Tuple[str, int], dict]:
    """The expected-lines file -> {(arm, seed): entry}; each entry holds the
    arm, the seed, the burn arguments and the line."""
    data = json.loads(Path(path).read_text())
    return {(e["arm"], e["seed"]): e for e in data["entries"]}


def summary_line(stdout: str) -> Optional[str]:
    """The burn's summary line: the last line of its output that starts
    with ``seed=``."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("seed=")]
    return lines[-1] if lines else None


def classify(returncode: int, stdout: str, stderr: str) -> str:
    """``pass``, ``zero-ack`` or ``fail``, as the reference soak classifies
    a finished burn."""
    verified = returncode == 0 and " OK" in stdout
    tail = (stdout + stderr)[-1200:]
    # "zero acks under extreme hostility" is the burn's pathological guard,
    # not a verification failure: the run completed, nothing was lost or
    # left pending, and all three checkers passed over the (nack-heavy)
    # history.  Same-seed scalar runs ack ~0-1 ops at these settings too, so
    # classify separately instead of failing.
    if (not verified and "PATHOLOGICAL" in tail and " OK" in stdout
            and "lost=0" in stdout and "pending=0" in stdout):
        return "zero-ack"
    return "pass" if verified else "fail"


def line_mismatch(line: Optional[str], expect: dict,
                  args: str) -> Optional[str]:
    """Why a seed's summary line fails its expected-lines entry, or None
    when it is ``==`` the line recorded for the same burn arguments."""
    if expect.get("args") != args:
        return "no line recorded for these arguments"
    if line != expect["line"]:
        return "summary line != the recorded line"
    return None


def run_seed(arm_name: str, seed: int, ops: int, extra: List[str],
             timeout_s: float, *, device: Optional[str] = "cuda",
             burn_module: str = BURN_MODULE, env: Optional[dict] = None,
             expect: Optional[dict] = None) -> dict:
    """One seed's burn in a subprocess -> its record: arm, seed, status,
    secs, the summary line, the kernels' launches in the burn's process, and
    for a failure the repro command, the output's tail and the expected
    line.  ``device=None`` passes no ``--device`` (a burn without that
    option); ``expect`` is the seed's entry of the expected-lines file, or
    None to check no line."""
    cmd = [sys.executable, "-m", burn_module,
           *burn_args(seed, ops, extra).split()]
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ if env is None else env)
    fd, counts_path = tempfile.mkstemp(prefix="soak_launches_",
                                       suffix=".json")
    os.close(fd)
    env["ACCORD_LAUNCH_COUNTS"] = counts_path
    t0 = time.time()
    line, launches = None, {}
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, cwd=str(ROOT), env=env)
        status = classify(proc.returncode, proc.stdout, proc.stderr)
        tail = (proc.stdout + proc.stderr)[-1200:]
        line = summary_line(proc.stdout)
        text = Path(counts_path).read_text()
        launches = json.loads(text) if text else {}
    except subprocess.TimeoutExpired as e:
        status = "fail"
        out, err = e.stdout or "", e.stderr or ""
        if isinstance(out, bytes):
            out, err = out.decode(errors="replace"), \
                err.decode(errors="replace")
        tail = f"TIMEOUT after {timeout_s}s\n" + (out + err)[-800:]
    finally:
        os.unlink(counts_path)
    rec = {"arm": arm_name, "seed": seed, "status": status,
           "secs": round(time.time() - t0, 1), "line": line,
           "launches": {k: v for k, v in launches.items() if v}}
    args = burn_args(seed, ops, extra)
    why = None if expect is None else line_mismatch(line, expect, args)
    if why is not None:
        status = rec["status"] = "fail"
        rec["expected"] = expect["line"] if expect.get("args") == args \
            else None
        tail = why + "\n" + tail
    rec["ok"] = status != "fail"
    if not rec["ok"]:
        rec.update(cmd=" ".join(cmd), tail=tail)
    return rec


def _build_kernels() -> str:
    """Build every kernel once, before the workers start (parallel burns
    would each run nvcc on their first call) -> the card's name and power
    limit."""
    from accord_tpu_torch.ops import cuda_kernels
    from accord_tpu_torch.utils.backend import (card_name_and_power_limit,
                                                resolve_device)
    resolve_device("cuda")
    cuda_kernels.build()
    return card_name_and_power_limit()


def arm_summary(runs: List[dict]) -> Dict[str, dict]:
    """Per arm: seeds run, passed, zero-acks, mean seconds a seed, and the
    kernels' launches summed over its seeds."""
    out: Dict[str, dict] = {}
    for r in runs:
        a = out.setdefault(r["arm"], {"seeds": 0, "passed": 0, "zero_ack": 0,
                                      "secs": 0.0, "launches": {}})
        a["seeds"] += 1
        a["passed"] += bool(r["ok"])
        a["zero_ack"] += r["status"] == "zero-ack"
        a["secs"] += r["secs"]
        for k, v in r.get("launches", {}).items():
            a["launches"][k] = a["launches"].get(k, 0) + v
    for a in out.values():
        a["mean_secs"] = round(a["secs"] / a["seeds"], 2)
        a["secs"] = round(a["secs"], 1)
    return out


def ledger_lines(runs: List[dict], elapsed_s: float,
                 seeds_per_arm: int, ops: int, seed_offset: int, jobs: int,
                 device: str, where: str) -> List[str]:
    """The ledger's section for this wave's `runs`."""
    passed = sum(1 for r in runs if r["ok"])
    zero_acks = sum(1 for r in runs if r["status"] == "zero-ack")
    stamp = datetime.date.today().isoformat()
    per_arm = arm_summary(runs)
    lines = [f"\n## Port device-arm soak ledger (latest wave, {stamp})\n",
             f"{passed}/{len(runs)} seeds passed across {len(ARMS)} arms "
             f"({seeds_per_arm} seeds/arm, {ops} ops/seed, device "
             f"verification inline everywhere, stores on {device}: "
             f"{where}; {elapsed_s / 60:.1f} min wall at "
             f"{jobs} job(s)).  {zero_acks} of those passed with zero acks "
             f"(history verified, lost=0).  Arms:\n"]
    for arm_name, base, extra, _ in ARMS:
        a = per_arm.get(arm_name, {"seeds": 0, "passed": 0, "mean_secs": 0,
                                   "launches": {}})
        lines.append(f"- `{arm_name}` (seeds {base + seed_offset}+): "
                     f"{a['passed']}/{a['seeds']} passed, "
                     f"{a['mean_secs']} s a seed, launches "
                     f"{json.dumps(a['launches'], sort_keys=True)} — "
                     f"`{' '.join(extra)}`\n")
    failures = [r for r in runs if not r["ok"]]
    if failures:
        lines.append("\n### FAILURES (repro commands)\n")
        for r in failures:
            lines.append(f"- {r['arm']} seed={r['seed']}: `{r['cmd']}`\n")
            if "expected" in r:
                lines.append(f"  - got: `{r['line']}`\n"
                             f"  - expected: `{r['expected']}`\n")
    else:
        lines.append("\nNo failures.\n")
    return lines


def write_ledger(path: str, lines: List[str]) -> None:
    """Replace the file's latest-wave section (from a partial or resumed
    soak) with ``lines``; anything before it is kept."""
    header = "\n## Port device-arm soak ledger (latest wave"
    try:
        existing = Path(path).read_text()
    except OSError:
        existing = ""
    cut = existing.find(header)
    if cut != -1:
        existing = existing[:cut]
    Path(path).write_text(existing + "".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m accord_tpu_torch.soak")
    ap.add_argument("--seeds-per-arm", type=int, default=14)
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="shift every arm's seed base (fresh-seed waves)")
    ap.add_argument("--ops", type=int, default=60)
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds a seed may take")
    ap.add_argument("--jobs", type=int, default=1,
                    help="seeds run at a time, each in its own process")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the burns' stores: the CUDA card "
                         "(default; fails without one) or the CPU")
    ap.add_argument("--expect", default=None, metavar="FILE",
                    help="expected summary lines; a seed whose line differs "
                         f"fails (the recorded matrix: {EXPECTED_LINES})")
    ap.add_argument("--out", required=True,
                    help="ledger file (markdown); its latest-wave section "
                         "is rewritten")
    ap.add_argument("--state", required=True,
                    help="resumable state file (JSON)")
    ns = ap.parse_args(argv)

    expected = load_expected(ns.expect) if ns.expect else None
    where = _build_kernels() if ns.device == "cuda" else "the CPU"
    print(f"soak: stores on {ns.device} ({where})", flush=True)

    state = {"runs": [], "elapsed_s": 0.0}
    if os.path.exists(ns.state):
        state = json.loads(Path(ns.state).read_text())
        state.setdefault("elapsed_s", 0.0)
    done = {(r["arm"], r["seed"]) for r in state["runs"]}

    # round-robin the arms so a partial soak still covers the whole matrix
    order, wave_pairs = [], set()
    for i in range(ns.seeds_per_arm):
        for arm_name, base, extra, _ in ARMS:
            seed = base + ns.seed_offset + i
            wave_pairs.add((arm_name, seed))
            if (arm_name, seed) not in done:
                order.append((arm_name, seed, extra))

    def save():
        Path(ns.state).write_text(json.dumps(state, indent=1))

    t_start = time.time()
    with ThreadPoolExecutor(max_workers=max(1, ns.jobs)) as pool:
        futures = [pool.submit(
            run_seed, arm_name, seed, ns.ops, extra, ns.timeout,
            device=ns.device,
            expect=None if expected is None else expected.get(
                (arm_name, seed), {"args": None, "line": None}))
            for arm_name, seed, extra in order]
        for fut in as_completed(futures):
            rec = fut.result()
            state["runs"].append(rec)
            name, seed = rec["arm"], rec["seed"]
            if rec["status"] == "pass":
                print(f"PASS {name} seed={seed} ({rec['secs']:.0f}s)",
                      flush=True)
            elif rec["status"] == "zero-ack":
                print(f"PASS(zero-ack) {name} seed={seed} "
                      f"({rec['secs']:.0f}s)", flush=True)
            else:
                print(f"FAIL {name} seed={seed}\n  repro: {rec['cmd']}\n"
                      f"{rec['tail']}", flush=True)
                if "expected" in rec:
                    print(f"  got:      {rec['line']}\n"
                          f"  expected: {rec['expected']}", flush=True)
            save()

    # cumulative across resumed invocations (state carries prior wall time)
    state["elapsed_s"] += time.time() - t_start
    save()
    runs = [r for r in state["runs"] if (r["arm"], r["seed"]) in wave_pairs]
    write_ledger(ns.out, ledger_lines(
        runs, state["elapsed_s"], ns.seeds_per_arm, ns.ops,
        ns.seed_offset, ns.jobs, ns.device, where))
    passed = sum(1 for r in runs if r["ok"])
    print("soak " + json.dumps({
        "passed": passed, "seeds": len(runs), "device": ns.device,
        "card": where, "elapsed_s": round(state["elapsed_s"], 1),
        "arms": arm_summary(runs)}, sort_keys=True))
    print(f"soak done: {passed}/{len(runs)} passed; ledger written to "
          f"{ns.out}")
    return 0 if passed == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
