"""accord-lint over the port: ``tests/test_analysis.py`` on
``accord_tpu_torch.analysis``.

Three layers of proof that the port's static-analysis suite does its job:

  1. each pass catches its seeded violation in tests/fixtures/lintfix/
     at the exact file:line, and the port's five passes give the JAX
     passes' findings over that tree;
  2. the blocking pass demonstrably covers the port's real loop roots: a
     scratch copy of the port with `time.sleep` inserted under
     `TcpHost._dispatch` is reported;
  3. the port runs clean against its checked-in baseline (whose policy —
     a justification per entry — round-trips below), inside a hard
     wall-clock budget.

Plus the reference's pins of the findings its linter's introduction fixed:
`WriteAheadLog.sync_soon` (persist-before-ack without parking the caller)
and the admin ack paths that use it.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from accord_tpu.analysis import blocking as jax_blocking
from accord_tpu.analysis import determinism as jax_determinism
from accord_tpu.analysis import layering as jax_layering
from accord_tpu.analysis import surface as jax_surface
from accord_tpu.analysis import threads as jax_threads
from accord_tpu.analysis.core import RepoIndex as JaxRepoIndex
from accord_tpu_torch.analysis import (blocking, determinism, layering,
                                       run_repo, surface, threads)
from accord_tpu_torch.analysis.baseline import (BaselineError, load_baseline,
                                                write_baseline)
from accord_tpu_torch.analysis.core import RepoIndex
from accord_tpu_torch.analysis.findings import Finding

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lintfix"


@pytest.fixture(scope="module")
def fix_index():
    return RepoIndex.build(FIXTURES, "lintfix")


def _line_of(path: Path, needle: str) -> int:
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if needle in line:
            return i
    raise AssertionError(f"{needle!r} not in {path}")


# ------------------------------------------------------------- pass proofs --
def test_blocking_pass_catches_seeded_sleep(fix_index):
    found = blocking.run(fix_index, roots=("lintfix.loopy::Loop._run",),
                         allowed={})
    assert len(found) == 1, [f.render() for f in found]
    f = found[0]
    assert f.file == "lintfix/loopy.py"
    assert f.line == _line_of(FIXTURES / "loopy.py", "time.sleep")
    assert f.qualname == "lintfix.loopy::Loop._slow_path"
    assert f.code == "blocking-call"
    # the report names the whole hop chain back to the loop root
    assert ("Loop._run -> Loop._dispatch -> Loop._handle -> "
            "Loop._slow_path") in f.message


def test_determinism_pass_catches_each_seeded_violation(fix_index):
    found = determinism.run(fix_index, scope=["lintfix.simmy"])
    got = {(f.code, f.line) for f in found}
    src = FIXTURES / "simmy.py"
    want = {
        ("wall-clock", _line_of(src, "time.monotonic")),
        ("global-random", _line_of(src, "random.random")),
        ("id-keyed", _line_of(src, "id(xs)")),
        ("env-read", _line_of(src, 'environ.get("MODE")')),
        ("set-iteration", _line_of(src, "for x in chosen")),
    }
    assert got == want, (got, want)
    # the sum()-laundered generator and the *_from_env read must NOT fire
    assert not any(f.line == _line_of(src, "sum(") for f in found)
    assert not any(f.line == _line_of(src, "TUNING") for f in found)


def test_threads_pass_catches_seeded_races(fix_index):
    found = threads.run(fix_index, extra_roots=())
    src = FIXTURES / "shared.py"
    by_code = {}
    for f in found:
        by_code.setdefault(f.code, set()).add((f.file, f.line))
    # Counter.n: written unlocked from both worker threads
    n_lines = {i for i, line in enumerate(
        src.read_text().splitlines(), 1) if "self.n += 1" in line}
    assert by_code.get("unlocked-write") == {
        ("lintfix/shared.py", i) for i in n_lines}, by_code
    # Counter.m: locked in _worker_a, bare in _worker_b
    assert by_code.get("inconsistent-lock") == {
        ("lintfix/shared.py",
         _line_of(src, "self.m += 1          # inconsistent-lock"))}, by_code


def test_surface_pass_catches_seeded_unclaimed_verb(fix_index):
    found = surface.verb_findings(fix_index, enum_name="WireVerb",
                                  messages_pkg="lintfix.messages",
                                  collapsed=frozenset())
    assert len(found) == 1, [f.render() for f in found]
    f = found[0]
    assert f.code == "verb-unclaimed"
    assert f.detail == "LOST_MSG"
    assert f.file == "lintfix/verbs.py"
    assert f.line == _line_of(FIXTURES / "verbs.py", "LOST_MSG = 2")


# ------------------------------------------- the JAX passes, same findings --
def _fixture_runs(blocking, determinism, threads, surface, layering):
    """Each pass over the fixture tree, with the proofs' arguments and with
    its defaults: {pass: callable(index) -> findings}."""
    return {
        "blocking": lambda ix: blocking.run(
            ix, roots=("lintfix.loopy::Loop._run",), allowed={})
        + blocking.run(ix),
        "determinism": lambda ix: determinism.run(
            ix, scope=["lintfix.simmy"]) + determinism.run(ix),
        "threads": lambda ix: threads.run(ix, extra_roots=())
        + threads.run(ix),
        "surface": lambda ix: surface.verb_findings(
            ix, enum_name="WireVerb", messages_pkg="lintfix.messages",
            collapsed=frozenset()) + surface.run(ix),
        "layering": layering.run,
    }


def _layered_tree(tmp_path):
    """A tree whose obs/ and analysis/ break the layering rules: the
    fixture tree has neither."""
    root = tmp_path / "layered"
    for sub, body in (("obs", "import numpy\nimport torch\n"
                              "from layered import core\n"),
                      ("analysis", "import jax\nimport torch.nn\n")):
        (root / sub).mkdir(parents=True)
        (root / sub / "__init__.py").write_text("")
        (root / sub / "mod.py").write_text(body)
    (root / "__init__.py").write_text("")
    (root / "core.py").write_text("import torch\n")
    return root


@pytest.mark.parametrize("name", ["blocking", "determinism", "threads",
                                  "surface", "layering"])
def test_passes_give_the_jax_passes_findings_on_the_fixtures(name,
                                                             tmp_path):
    """Each pass of the port over the fixture tree renders the JAX pass's
    findings.  The layering pass runs over a tree of its own, and the port's
    also bans torch from obs/ and analysis/: that is its only difference."""
    tree, pkg = FIXTURES, "lintfix"
    if name == "layering":
        tree, pkg = _layered_tree(tmp_path), "layered"
    port = _fixture_runs(blocking, determinism, threads, surface,
                         layering)[name](RepoIndex.build(tree, pkg))
    ref = _fixture_runs(jax_blocking, jax_determinism, jax_threads,
                        jax_surface, jax_layering)[name](
        JaxRepoIndex.build(tree, pkg))
    torch_only = [f.render() for f in port if f.detail.startswith("torch")]
    assert sorted(f.render() for f in port if f.render() not in torch_only) \
        == sorted(f.render() for f in ref)
    assert port, "the tree seeds a violation of every pass"
    if name == "layering":
        assert sorted(f.detail for f in port if f.code == "device-import") \
            == ["jax", "numpy", "torch", "torch.nn"]
        assert len(torch_only) == 2
    else:
        assert not torch_only


# ------------------------------------------------- real-loop-root coverage --
def test_blocking_pass_covers_real_tcp_dispatch(tmp_path):
    """Acceptance probe: insert a sleep under the port's REAL host/tcp.py
    `_dispatch` in a scratch copy of the port; the pass must report it.
    Proves the default roots actually reach the production loop."""
    copy = tmp_path / "accord_tpu_torch"
    shutil.copytree(REPO / "accord_tpu_torch", copy,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "_build"))
    tcp = copy / "host" / "tcp.py"
    lines = tcp.read_text().splitlines()
    at = next(i for i, line in enumerate(lines)
              if line.lstrip().startswith("def _dispatch("))
    indent = (len(lines[at]) - len(lines[at].lstrip()) + 4) * " "
    lines.insert(at + 1, f"{indent}time.sleep(0.001)")
    tcp.write_text("\n".join(lines) + "\n")

    index = RepoIndex.build(copy, "accord_tpu_torch")
    found = blocking.run(index)
    hits = [f for f in found
            if f.qualname == "accord_tpu_torch.host.tcp::TcpHost._dispatch"
            and f.detail.startswith("time.sleep")]
    assert hits, [f.render() for f in found]
    assert hits[0].line == at + 2  # 1-indexed line of the inserted sleep


# --------------------------------------------------------- baseline policy --
def test_baseline_round_trip(tmp_path):
    f = Finding(pass_id="blocking", file="x.py", line=3, qualname="m::f",
                code="blocking-call", message="boom", detail="time.sleep")
    path = tmp_path / "baseline.json"
    # unedited --write-baseline output must be rejected...
    write_baseline([f], path)
    with pytest.raises(BaselineError, match="justification"):
        load_baseline(path)
    # ...a justified entry loads and suppresses exactly that key
    write_baseline([f], path, justifications={f.key: "known idle wait"})
    loaded = load_baseline(path)
    assert loaded == {f.key: "known idle wait"}
    # keys are line-free: the same finding moved to another line still maps
    moved = Finding(pass_id="blocking", file="x.py", line=99, qualname="m::f",
                    code="blocking-call", message="boom", detail="time.sleep")
    assert moved.key in loaded
    # duplicate keys are a policy violation
    path.write_text(json.dumps({"entries": [
        {"key": f.key, "justification": "a"},
        {"key": f.key, "justification": "b"}]}))
    with pytest.raises(BaselineError, match="duplicate"):
        load_baseline(path)


def test_checked_in_baseline_entries_are_justified():
    loaded = load_baseline()  # raises on any TODO/empty justification
    for key, just in loaded.items():
        assert len(just) > 15, (key, just)


# ------------------------------------------------------------- repo gate --
def test_repo_is_clean():
    """`python -m accord_tpu_torch.analysis` semantics as a gate: all
    passes over the port, its checked-in baseline applied, no new
    findings, no stale suppressions, inside the wall budget."""
    t0 = time.perf_counter()
    report = run_repo()
    wall = time.perf_counter() - t0
    assert report.ok, "\n".join(f.render() for f in report.new)
    assert not report.stale, report.stale
    assert wall < 30.0, f"analyzer took {wall:.1f}s (budget 30s)"


def test_cli_runs_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "accord_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] and not payload["findings"]


# ----------------------------------------------------- fixed-finding pins --
def test_wal_sync_soon_does_not_block(tmp_path):
    """Regression for the blocking findings this suite flagged: the admin
    persist-before-ack path must not park the loop thread.  With the
    flush thread stalled, sync_soon returns immediately and the callback
    fires only once everything appended is durable."""
    from accord_tpu_torch.journal.wal import JournalConfig, WriteAheadLog
    from accord_tpu_torch.messages.commit import CommitInvalidate
    from accord_tpu_torch.primitives.keys import Route, RoutingKey, RoutingKeys
    from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind

    def msg(i=0):
        tid = TxnId.create(1, 1000 + i, TxnKind.WRITE, Domain.KEY, 1)
        return CommitInvalidate(
            tid, Route.of_keys(RoutingKey(5), RoutingKeys.of(5, 7)))

    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d, config=JournalConfig(d, fsync_window_us=2000))
    try:
        stall = threading.Event()
        orig = wal._write_batch

        def slow_batch(batch):
            stall.wait(5.0)
            return orig(batch)

        wal._write_batch = slow_batch
        seq = wal.append(msg())
        fired = threading.Event()
        state = {}

        t0 = time.perf_counter()
        wal.sync_soon(lambda: (state.update(d=wal.durable_seq),
                               fired.set()))
        returned_in = time.perf_counter() - t0
        assert returned_in < 1.0, f"sync_soon blocked {returned_in:.2f}s"
        assert not fired.is_set(), "ack fired before durability"
        stall.set()
        assert fired.wait(10.0), "durability callback never fired"
        assert state["d"] >= seq
    finally:
        wal.close()

    # sync mode: append IS durable, the callback must fire inline
    d2 = str(tmp_path / "wal2")
    wal2 = WriteAheadLog(d2, config=JournalConfig(d2, fsync_window_us=0))
    try:
        wal2.append(msg(1))
        inline = []
        wal2.sync_soon(lambda: inline.append(True))
        assert inline == [True]
    finally:
        wal2.close()


def test_fixed_findings_stay_fixed():
    """Pin the lint state of the reference linter's fixes: the admin ack paths carry
    no loop-thread Condition.wait and TcpClusterClient._out mutations are
    lock-consistent.  A revert re-opens the finding and fails here with
    its rendered path."""
    report = run_repo(select=["blocking", "threads"])
    regressions = [
        f.render() for f in report.new
        if ("wait_durable" in f.qualname)
        or (f.detail == "_out" and "TcpClusterClient" in f.qualname)]
    assert not regressions, regressions
