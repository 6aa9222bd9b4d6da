"""The port's bench history and regression gate against the JAX bench's.

The counterpart of ``tests/test_bench_guard.py``, in process: the port's
``bench_guard`` and the root ``bench.py`` (loaded from its file, its
``HISTORY_PATH`` pointed at a copy) read the same history and print the
same dry-run lines, reject the same broken rows with the same text and find
the same regressions in the same pairs of rows.  Then the gate of the
port's own lanes on the CPU against scratch histories, the history's
bookkeeping, the default lane's profile schema, ``--fill`` without a card,
and the committed port history of card rows.
"""

import copy
import importlib.util
import json
from pathlib import Path

import pytest

from accord_tpu_torch import bench, bench_guard

REPO = Path(__file__).resolve().parent.parent
JAX_HISTORY = REPO / "BENCH_HISTORY.json"
PORT_HISTORY = REPO / "accord_tpu_torch" / "BENCH_HISTORY.json"


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """The root bench.py as a module of its own (its top imports argparse,
    json, os, time and numpy), its history a copy under `tmp_path`, as is
    the port's."""
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = tmp_path / "hist.json"
    hist.write_text(JAX_HISTORY.read_text())
    monkeypatch.setattr(mod, "HISTORY_PATH", str(hist))
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(hist))
    return mod


def _jax_rows() -> dict:
    return json.loads(JAX_HISTORY.read_text())


def _dry_line(fn, capsys) -> dict:
    capsys.readouterr()
    assert fn() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line.pop("history")
    return line


def test_dry_run_lines_match_jax_for_every_history_key(jax_bench, capsys):
    keys = sorted(_jax_rows())
    assert len(keys) == 22
    for key in keys:
        want = _dry_line(lambda: jax_bench.run_guard_dry(key), capsys)
        got = _dry_line(lambda: bench_guard.run_guard_dry(key), capsys)
        assert got == want, key
        assert got["baselines"], key


def _head(slo):
    wan = slo["wan"]
    return next(a for a in wan["sweep"]
                if a["config"] == wan["headline_config"])


# each case: (history key, [(mutation of the row, text the message holds)])
REJECTED = {
    "bucket-quantiles": [
        ("slo-zipf", lambda r: r["slo"].__setitem__("quantile_source",
                                                    "log2-bucket"),
         "exact-sample"),
        ("tcp", lambda r: r["cpu"].__setitem__("quantile_source",
                                               "log2-bucket"),
         "exact-sample")],
    "reshard": [
        ("slo-reshard", lambda r: r["slo"]["reshard"].__setitem__(
            "lost_acks", 1), "lost acks"),
        ("slo-reshard", lambda r: r["slo"]["reshard"].__setitem__(
            "time_to_slo_recovery_s", None), "recovery")],
    "paging": [
        ("slo-zipf1m", lambda r: r["slo"]["paging"].__setitem__(
            "lost_acks", 3), "lost acks"),
        ("slo-zipf1m", lambda r: r["slo"]["paging"].__setitem__(
            "audit_agree", False), "divergence"),
        ("slo-zipf1m", lambda r: r["slo"]["paging"].pop(
            "resident_high_water"), "resident_high_water")],
    "overload": [
        ("slo-overload", lambda r: r["slo"]["overload"]["accounting"]
         .__setitem__("exact", False), "accounting identity"),
        ("slo-overload", lambda r: r["slo"]["overload"].__setitem__(
            "goodput_at_5x_frac_of_peak", 0.4), "goodput collapsed"),
        ("slo-overload", lambda r: r["slo"]["overload"].__setitem__(
            "high_p99_at_5x_us",
            10 * r["slo"]["overload"]["high_p99_uncontended_us"]),
         "blew out")],
    "wan": [
        ("slo-wan", lambda r: _head(r["slo"]).__setitem__(
            "fast_path_ratio", None), "fast_path_ratio broken"),
        ("slo-wan", lambda r: _head(r["slo"]).pop("fast_path_ratio"),
         "missing fast_path_ratio"),
        ("slo-wan", lambda r: _head(r["slo"]).__setitem__(
            "p99_rtt_multiple", "55204us"), "not an RTT multiple"),
        ("slo-wan", lambda r: r["slo"].__setitem__("quantile_source",
                                                   "log2-bucket"),
         "exact-sample"),
        ("slo-wan", lambda r: r["slo"]["wan"]["partition"]["audit"]
         .__setitem__("agree", False), "audit divergence"),
        ("slo-wan", lambda r: r["slo"]["wan"]["partition"].__setitem__(
            "lost_acks", 2), "lost acks")],
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_rows_fail_alike(case, jax_bench, tmp_path, capsys):
    good = _jax_rows()
    hist = Path(bench_guard.HISTORY_PATH)
    for key, mutate, needle in REJECTED[case]:
        lane = copy.deepcopy(good[key])
        mutate(lane["host"])
        hist.write_text(json.dumps({key: lane}))
        errors = []
        for run in (jax_bench.run_guard_dry, bench_guard.run_guard_dry):
            with pytest.raises(AssertionError) as e:
                run(key)
            errors.append(str(e.value))
        assert errors[0] == errors[1], (key, needle)
        assert needle in errors[1], (key, needle, errors[1])
    capsys.readouterr()


def _scaled(row: dict, path: tuple, factor: float) -> dict:
    out = copy.deepcopy(row)
    node = out
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = node[path[-1]] * factor
    return out


def test_guard_problems_match_jax(jax_bench, monkeypatch):
    rows = {k: v["host" if "host" in v else "cpu"]
            for k, v in _jax_rows().items()}
    verb = "PRE_ACCEPT_REQ"
    low_cpu = copy.deepcopy(rows["tcp"])
    low_cpu["cpu"]["verbs"][verb]["p50_us"] = 10.0
    few_cpu = copy.deepcopy(rows["tcp"])
    few_cpu["cpu"]["verbs"][verb]["count"] = 5
    few_slo = copy.deepcopy(rows["slo-zipf"])
    few_slo["slo"]["open_loop"]["count"] = 5
    low_slo = copy.deepcopy(rows["slo-zipf"])
    low_slo["slo"]["open_loop"]["p99_us"] = 400
    low_slo["slo"]["open_loop"]["p999_us"] = 450
    phase = sorted(rows["slo-zipf"]["slo"]["phases"])[0]
    tail = _scaled(_scaled(rows["slo-zipf"], ("slo", "open_loop", "p99_us"),
                           3), ("slo", "phases", phase, "p99_us"), 3)
    pairs = [  # (config, current, baseline, regressions expected)
        ("scalar", _scaled(rows["scalar"], ("value",), 0.8), rows["scalar"],
         True),
        ("scalar", _scaled(rows["scalar"], ("value",), 1.2), rows["scalar"],
         False),
        ("audit", _scaled(rows["audit"], ("value",), 1.2), rows["audit"],
         True),
        ("audit", _scaled(rows["audit"], ("value",), 0.8), rows["audit"],
         False),
        ("slo-wan", _scaled(rows["slo-wan"], ("value",), 1.2),
         rows["slo-wan"], True),
        ("tpcc", {"value": 12.0}, {"value": 10.0}, True),
        ("tpcc", {"value": 8.0}, {"value": 10.0}, False),
        ("default", _scaled(rows["default"],
                            ("profile", "kernels", "deps_kernel", "p50"), 2),
         rows["default"], True),
        ("slo-zipf", tail, rows["slo-zipf"], True),
        ("tcp", _scaled(rows["tcp"], ("cpu", "verbs", verb, "p50_us"), 2),
         rows["tcp"], True),
        ("tcp", _scaled(few_cpu, ("cpu", "verbs", verb, "p50_us"), 2),
         few_cpu, False),
        ("tcp", _scaled(low_cpu, ("cpu", "verbs", verb, "p50_us"), 2),
         low_cpu, False),
        ("slo-zipf", _scaled(few_slo, ("slo", "open_loop", "p99_us"), 3),
         few_slo, False),
        ("slo-zipf", _scaled(low_slo, ("slo", "open_loop", "p99_us"), 1.1),
         low_slo, False),
    ]
    for config, current, baseline, regressed in pairs:
        monkeypatch.setattr(jax_bench, "CONFIG", config)
        want = jax_bench._guard_problems(current, baseline)
        got = bench_guard._guard_problems(current, baseline, config)
        assert got == want, config
        assert bool(got) == regressed, (config, got)
    # the tail-only pair trips the tails, not the headline
    got = bench_guard._guard_problems(tail, rows["slo-zipf"], "slo-zipf")
    assert any(p.startswith("slo open_loop p99_us") for p in got)
    assert any(p.startswith(f"slo phase {phase} p99_us") for p in got)
    assert not any(p.startswith("headline") for p in got)


def _main(argv, capsys) -> tuple:
    capsys.readouterr()
    rc = bench.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _fixed_scalar_lane() -> dict:
    """The scalar lane's row with fixed samples in place of timed ones: its
    profile is built at run time, so ``ACCORD_PROFILE_SCALE`` scales it."""
    prof = bench.profile_from_samples({"scalar_scan": [0.2] * 32},
                                      {"scalar_scan": (64,)})
    return {"metric": "scalar_edges_resolved_per_sec", "value": 1000.0,
            "unit": "edges/s", "profile": prof, "device": "host"}


def _scalar_guard_runs(hist, monkeypatch, capsys) -> None:
    """``--config scalar --guard`` against a scratch history: the first run
    records the baseline; at a profile scale of 2 the gate exits 2 on
    ``kernel scalar_scan``, the failed row retired and the baseline
    restored; at 0.5 no kernel regresses."""
    monkeypatch.delenv("ACCORD_PROFILE_SCALE", raising=False)
    rc, _, err = _main(["--config", "scalar", "--guard"], capsys)
    assert rc == 0 and "no clean baseline" in err, err
    baseline = json.loads(hist.read_text())["scalar"]["host"]
    monkeypatch.setenv("ACCORD_PROFILE_SCALE", "2")
    rc, _, err = _main(["--config", "scalar", "--guard"], capsys)
    assert rc == 2, err
    assert "# GUARD REGRESSION (scalar): kernel scalar_scan" in err, err
    lane = json.loads(hist.read_text())["scalar"]
    assert lane["host"] == baseline
    assert any(e.get("guard_failed") and e.get("stale")
               for e in lane["superseded"])
    monkeypatch.setenv("ACCORD_PROFILE_SCALE", "0.5")
    rc, _, err = _main(["--config", "scalar", "--guard"], capsys)
    assert "kernel scalar_scan" not in err, err


def test_scalar_guard_on_cpu_with_a_scratch_history(tmp_path, monkeypatch,
                                                    capsys):
    hist = tmp_path / "hist.json"
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(hist))
    monkeypatch.setitem(bench.LANES, "scalar", _fixed_scalar_lane)
    _scalar_guard_runs(hist, monkeypatch, capsys)
    # a run without --record or --guard annotates its line and records
    # nothing
    before = hist.read_text()
    rc, out, _ = _main(["--config", "scalar"], capsys)
    assert rc == 0 and hist.read_text() == before
    assert json.loads(out)["prev_same_platform"]["value"] == 1000.0
    retired = len(json.loads(before)["scalar"]["superseded"])
    rc, _, _ = _main(["--config", "scalar", "--record"], capsys)
    assert rc == 0 and len(json.loads(hist.read_text())["scalar"][
        "superseded"]) == retired + 1


@pytest.mark.slow
def test_scalar_guard_on_cpu_with_the_timed_lane(tmp_path, monkeypatch,
                                                 capsys):
    hist = tmp_path / "hist.json"
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(hist))
    _scalar_guard_runs(hist, monkeypatch, capsys)


def test_history_bookkeeping(tmp_path, monkeypatch, capsys):
    hist = tmp_path / "hist.json"
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(hist))
    # a card lane on the CPU reports no number: nothing is recorded
    bench_guard.emit({"metric": "m", "value": None, "platform": "cpu"},
                     "default", record=True)
    # nor is any row unless asked
    bench_guard.emit({"metric": "m", "value": 1.0, "platform": "cpu"},
                     "default")
    assert not hist.exists()
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    bench_guard.emit({"metric": "m", "value": 2.0, "platform": card,
                      "hardware": card}, "default", record=True)
    bench_guard.emit({"metric": "m", "value": 3.0, "device": "cuda",
                      "hardware": card}, "tcp", record=True)
    bench_guard.emit({"metric": "m", "value": 4.0, "platform": "cpu"},
                     "rangestress", record=True)
    history = json.loads(hist.read_text())
    assert history["default"]["device"] == {
        "value": 2.0, "platform": card, "hardware": card,
        "unix": history["default"]["device"]["unix"]}
    assert history["tcp+device"]["host"]["hardware"] == card
    assert history["rangestress"]["cpu"]["value"] == 4.0
    assert bench_guard.history_key("pipeline") == "pipeline+device"
    assert bench_guard.history_key("multicore") == "multicore"
    rc, out, _ = _main(["--config", "tcp", "--dry-run"], capsys)
    assert rc == 0
    assert json.loads(out)["metric"] == "tcp+device_guard"
    # a retired row is kept, the newest 8 of them
    lane = {}
    for i in range(11):
        bench_guard._supersede(lane, {"value": i}, "test")
    assert [e["value"] for e in lane["superseded"]] == list(range(3, 11))
    assert all(e["stale"] for e in lane["superseded"])
    # the device lanes carry their hardware as their platform
    world = bench.build_world(n_keys=16, n_existing=64, n_batch=8, seed=1)
    assert bench.default_lane(world, device="cpu")["platform"] == "cpu"


def test_default_profile_has_the_jax_schema(monkeypatch):
    samples = {"deps_kernel": [0.04, 0.03, 0.05, 0.03],
               "in_batch_graph": [0.1] * 4, "wavefront": [0.02] * 4}
    shapes = {"deps_kernel": ((128768,), (512, 1024)),
              "in_batch_graph": ((512, 1024),), "wavefront": (512,)}
    monkeypatch.delenv("ACCORD_PROFILE_SCALE", raising=False)
    prof = bench.profile_from_samples(samples, shapes)
    jax_prof = _jax_rows()["default"]["cpu"]["profile"]
    assert set(prof) == set(jax_prof)
    assert set(prof["kernels"]) == set(jax_prof["kernels"])
    assert prof["retraces"] == jax_prof["retraces"] == {
        "deps_kernel": 1, "in_batch_graph": 1, "wavefront": 1}
    assert prof["kernels"]["deps_kernel"] == {"count": 4, "p50": 40.0,
                                              "p99": 50.0}
    monkeypatch.setenv("ACCORD_PROFILE_SCALE", "2")
    scaled = bench.profile_from_samples(samples, shapes)
    assert scaled["kernels"]["deps_kernel"] == {"count": 4, "p50": 80.0,
                                                "p99": 100.0}
    assert scaled["kernels"]["in_batch_graph"]["p50"] == 200.0


def test_fill_without_a_card_records_nothing(tmp_path, monkeypatch):
    rows = tmp_path / "rows.json"
    monkeypatch.setattr(bench_guard, "ROWS_PATH", str(rows))
    monkeypatch.setattr(bench_guard, "_probe_card", lambda: None)
    waits = []
    monkeypatch.setattr(bench_guard.time, "sleep", waits.append)
    assert bench_guard.fill_device_rows(0.2) == 3
    assert bench_guard.fill_device_rows(0.2, ["tpcc", "scalar"]) == 2
    assert waits and not rows.exists()
    # a row counts as done on the card, or on the host for a host lane
    rows.write_text(json.dumps({"default": {"device": "cuda"},
                                "rangestress": {"device": "cpu"},
                                "scalar": {"device": "host"}}))
    assert bench_guard.fill_device_rows(0.2) == 2
    assert bench_guard.fill_device_rows(0.2, ["scalar", "default"]) == 0


def test_committed_port_history_is_card_rows(monkeypatch, capsys):
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(PORT_HISTORY))
    history = json.loads(PORT_HISTORY.read_text())
    assert set(history) == {bench_guard.history_key(c) for c in bench.LANES}
    assert len(history) == 22
    for key, lane in history.items():
        line = _dry_line(lambda: bench_guard.run_guard_dry(key), capsys)
        assert line["metric"] == f"{key}_guard" and line["baselines"], key
        for pclass, row in lane.items():
            assert pclass in ("device", "host"), (key, pclass)
            assert isinstance(row["value"], (int, float)), key
            assert not row.get("stale") and not row.get("guard_failed")
            if pclass == "device":
                assert "H100" in row["platform"], (key, row["platform"])
                assert row["platform"].endswith(" W"), row["platform"]


@pytest.mark.slow
def test_slo_tail_only_regression_fails_the_gate(tmp_path, monkeypatch,
                                                  capsys):
    hist = tmp_path / "hist.json"
    monkeypatch.setattr(bench_guard, "HISTORY_PATH", str(hist))
    monkeypatch.setenv("ACCORD_SLO_OPS", "200")
    monkeypatch.setenv("ACCORD_SLO_RATE", "60")
    argv = ["--config", "slo-zipf", "--device", "cpu", "--guard"]
    rc, _, err = _main(argv, capsys)
    assert rc == 0 and "no clean baseline" in err, err
    baseline = json.loads(hist.read_text())["slo-zipf"]["host"]
    monkeypatch.setenv("ACCORD_SLO_STALL_US", "400000")
    rc, _, err = _main(argv, capsys)
    assert rc == 2, err
    assert "slo open_loop p99_us" in err
    assert "headline" not in err
    lane = json.loads(hist.read_text())["slo-zipf"]
    assert lane["host"] == baseline
    assert any(e.get("guard_failed") and e.get("stale")
               for e in lane["superseded"])
