"""The bench's row history and regression gate: the JAX package's
``bench.py`` history, ``--guard``, ``--dry-run`` and ``--fill`` for the
port's lanes.

    ACCORD_BENCH_HISTORY=/tmp/h.json \
        python -m accord_tpu_torch.bench --config scalar --guard
    python -m accord_tpu_torch.bench --config slo-zipf --guard --dry-run
    python -m accord_tpu_torch.bench --fill --only default
    python -m accord_tpu_torch.bench --fill --only all

Every lane's line goes through ``emit``: it prints the line, annotated with
the last row of its config in the history (``prev_same_platform``).  Only
when asked (``--record``, ``--guard``, ``--fill``) does it also record the
row's headline value (with its profile, SLO report, protocol-CPU waterfall
and scaling table) as the newest row of its config in
``accord_tpu_torch/BENCH_HISTORY.json`` (``ACCORD_BENCH_HISTORY`` names
another file), the row it replaces kept as ``stale`` under ``superseded``:
a plain run writes nothing, so the committed rows, taken on the card's
machine, change only on purpose.
Rows are classed by platform as in the JAX bench: the device lanes
(``default``, ``rangestress``, ``tpcc``) carry ``platform`` (the card's
name and power limit, or ``"cpu"``), every other lane is class ``"host"``.
A lane that reports no number (a card lane on the CPU) records nothing, so
no CPU time becomes a card baseline.

``--guard`` diffs the fresh row against the last clean row of its class:
the headline value (direction-aware), every kernel's profile p50, the SLO
tails and each verb's protocol-CPU p50, each at ``GUARD_PCT``; on a
regression it writes ``# GUARD REGRESSION (<config>): ...`` to stderr,
retires the fresh row (``stale``, ``guard_failed``), restores the baseline
and exits 2.  ``--dry-run`` runs no lane: it self-diffs the config's rows
and validates their SLO and CPU sections.  ``--fill`` captures the card
rows of ``FILL_CONFIGS`` into ``BENCH_DEVICE_ROWS.json``, each config in a
subprocess under its timeout, while a bounded probe finds the card;
``--fill --only all`` runs every config (``tcp`` first: ``slo-wan`` reads
its row) and so re-records the whole history.

Imports neither torch nor the lanes: the functions keep the JAX names.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
ROWS_PATH = os.path.join(_HERE, "BENCH_DEVICE_ROWS.json")
HISTORY_PATH = os.environ.get("ACCORD_BENCH_HISTORY",
                              os.path.join(_HERE, "BENCH_HISTORY.json"))

# configs whose metric is a time or an overhead (lower is better); every
# other metric is a throughput
LOWER_IS_BETTER = {"tpcc", "audit", "slo-wan"}

# the port's tcp and pipeline lanes are the JAX bench's device-store lanes,
# and take their history keys
DEVICE_STORE_KEYS = {"tcp": "tcp+device", "pipeline": "pipeline+device"}

GUARD_PCT = 15.0  # per-kernel (and headline) regression threshold, percent

# a tail gate needs enough samples to mean something, and an absolute floor
# so that microsecond noise on a wall-clock lane cannot trip a percentage
SLO_GUARD_MIN_COUNT = 20
SLO_GUARD_FLOOR_US = 500

# per-verb protocol-CPU gates (the row's "cpu" key, obs/cpuprof.py): the
# same sample-count rule, a lower floor since a verb's dispatch takes tens
# to hundreds of µs (ACCORD_CPU_GUARD_FLOOR_US gates small runs)
CPU_GUARD_MIN_COUNT = 20
CPU_GUARD_FLOOR_US = float(os.environ.get("ACCORD_CPU_GUARD_FLOOR_US", "20"))

# the device configs, cheapest first, with each subprocess's timeout (s)
FILL_CONFIGS = (("default", 600), ("rangestress", 900), ("tpcc", 2400))
# the timeout of any other config that --fill --only names (s)
FILL_TIMEOUT_S = 900


def history_key(config: str) -> str:
    """The history key of a ``--config``."""
    return DEVICE_STORE_KEYS.get(config, config)


def _platform_class(platform: str) -> str:
    return "cpu" if platform.startswith("cpu") else "device"


def _row_class(result: dict) -> str:
    return _platform_class(result["platform"]) if result.get("platform") \
        else "host"


def _write_history(history: dict) -> None:
    # a pid-unique temporary file: the --fill loop and a run by hand may
    # write at once
    tmp = f"{HISTORY_PATH}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(history, f, indent=1)
    os.replace(tmp, HISTORY_PATH)


def _regression_guard(result: dict, config: str, record: bool) -> None:
    """Annotate `result` with the last row of its config and platform class
    (``prev_same_platform``; ``REGRESSION_vs_prev_pct`` past 10%), then,
    if `record`, record it as that class's row.  Annotation, not assertion:
    the line is printed whatever this finds.  A value that is not a number
    records nothing; a failed write is ignored."""
    try:
        value = result.get("value")
        if not isinstance(value, (int, float)):
            return
        pclass = _row_class(result)
        history = _load_history()
        prev = history.get(config, {}).get(pclass)
        if prev and prev.get("value"):
            result["prev_same_platform"] = prev
            pct = (value - prev["value"]) / prev["value"] * 100.0
            if config in LOWER_IS_BETTER:
                pct = -pct
            if pct < -10.0:
                result["REGRESSION_vs_prev_pct"] = round(pct, 1)
        if not record:
            return
        entry = {"value": value, "platform": result.get("platform", "host"),
                 "unix": int(time.time())}
        # what --guard diffs (profile, slo, cpu), the metrics summary and the
        # multicore lane's scaling table ride with the value; the card's
        # name and power limit beside a time taken on it
        for key in ("hardware", "obs", "profile", "slo", "cpu", "per_shards",
                    "per_procs", "cpus_available", "scaling_first_to_last"):
            if key in result:
                entry[key] = result[key]
        lane = history.setdefault(config, {})
        old = lane.get(pclass)
        if old is not None:
            # a replaced row is retired (bounded), not deleted: every
            # re-baseline keeps its provenance
            _supersede(lane, old, "overwritten by newer run")
        lane[pclass] = entry
        _write_history(history)
    except OSError:
        pass


def _supersede(lane: dict, entry: dict, reason: str) -> None:
    """Retire a history row: marked stale and appended to the lane's
    ``superseded`` list, which keeps the last 8."""
    old = dict(entry)
    old["stale"] = True
    old["stale_reason"] = reason
    lane.setdefault("superseded", []).append(old)
    del lane["superseded"][:-8]


def emit(result: dict, config: str, json_out: Optional[str] = None,
         record: bool = False) -> None:
    """Annotate `result` with its history (and, if `record`, record it)
    under `config`'s history key, print its one JSON line, and write the
    line to `json_out` too when given (``--fill`` reads it back from its
    subprocess)."""
    _regression_guard(result, history_key(config), record)
    line = json.dumps(result)
    print(line, flush=True)
    if json_out:
        with open(json_out, "w") as f:
            f.write(line + "\n")


def _load_rows() -> dict:
    try:
        with open(ROWS_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_row(config: str, result: dict) -> None:
    """Write a finished config's row into the rows file at once, so that a
    later failure never costs a captured row."""
    rows = _load_rows()
    rows[config] = result
    tmp = ROWS_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)
    os.replace(tmp, ROWS_PATH)


# ---------------------------------------------------------------- guard ----

def _load_history() -> dict:
    try:
        with open(HISTORY_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _guard_problems(current: dict, baseline: dict, config: str) -> list:
    """The regressions of `current` against the clean `baseline` row of
    `config`: the headline value (direction-aware), every kernel's profile
    p50, the SLO tails and each verb's protocol-CPU p50."""
    problems = []
    bval, cval = baseline.get("value"), current.get("value")
    if isinstance(bval, (int, float)) and isinstance(cval, (int, float)) \
            and bval:
        pct = (cval - bval) / bval * 100.0
        if config in LOWER_IS_BETTER:
            pct = -pct
        if pct < -GUARD_PCT:
            problems.append(
                f"headline {current.get('metric', config)}: {bval} -> "
                f"{cval} ({pct:+.1f}%)")
    bkern = (baseline.get("profile") or {}).get("kernels", {})
    ckern = (current.get("profile") or {}).get("kernels", {})
    for kernel, c in sorted(ckern.items()):
        b = bkern.get(kernel)
        if not b or not b.get("p50"):
            continue
        if c.get("p50", 0) > b["p50"] * (1 + GUARD_PCT / 100.0):
            problems.append(
                f"kernel {kernel}: p50 {b['p50']}us -> {c['p50']}us "
                f"(+{(c['p50'] / b['p50'] - 1) * 100:.0f}%)")
    problems.extend(_slo_problems(current, baseline))
    problems.extend(_cpu_problems(current, baseline))
    return problems


def _cpu_problems(current: dict, baseline: dict) -> list:
    """Each verb's exact-sample per-dispatch protocol-CPU p50 against the
    baseline row's ``cpu`` key, at GUARD_PCT, for verbs with enough samples
    on both sides and a baseline over CPU_GUARD_FLOOR_US."""
    problems: list = []
    cver = (current.get("cpu") or {}).get("verbs") or {}
    bver = (baseline.get("cpu") or {}).get("verbs") or {}
    for verb, c in sorted(cver.items()):
        b = bver.get(verb)
        if not b:
            continue
        if min(b.get("count", 0), c.get("count", 0)) < CPU_GUARD_MIN_COUNT:
            continue
        bv, cv = b.get("p50_us"), c.get("p50_us")
        if not bv or not cv or bv < CPU_GUARD_FLOOR_US:
            continue
        if cv > bv * (1 + GUARD_PCT / 100.0):
            problems.append(
                f"cpu verb {verb}: p50 {bv}us -> {cv}us "
                f"(+{(cv / bv - 1) * 100:.0f}%)")
    return problems


def _validate_cpu_schema(cpu: dict, where: str) -> None:
    """The ``cpu`` row contract: exact-sample quantiles, each verb's
    quantiles with its stages, and the top-verbs table."""
    _require(cpu.get("quantile_source") == "exact-sample",
             f"{where}: cpu rows must use exact-sample quantiles")
    verbs = cpu.get("verbs")
    _require(isinstance(verbs, dict) and bool(verbs),
             f"{where}: missing cpu verbs")
    for verb, q in verbs.items():
        for k in ("count", "p50_us", "p99_us", "dispatches",
                  "est_total_ms", "stages"):
            _require(k in q, f"{where}: cpu verb {verb} missing {k}")
        _require(isinstance(q["stages"], dict), f"{where}: {verb} stages")
        for st, sq in q["stages"].items():
            _require("p50_us" in sq and "count" in sq,
                     f"{where}: cpu verb {verb} stage {st}")
    _require(isinstance(cpu.get("top"), list) and bool(cpu["top"]),
             f"{where}: missing cpu top table")
    _require(cpu.get("sampled", 0) > 0 and cpu.get("dispatches", 0) > 0,
             f"{where}: cpu row with no samples")


def _slo_tail_check(what: str, b: dict, c: dict, quantiles,
                    problems: list) -> None:
    if min(b.get("count", 0), c.get("count", 0)) < SLO_GUARD_MIN_COUNT:
        return
    for q in quantiles:
        bv, cv = b.get(q), c.get(q)
        if not bv or not cv or bv < SLO_GUARD_FLOOR_US:
            continue
        if cv > bv * (1 + GUARD_PCT / 100.0):
            problems.append(
                f"slo {what} {q}: {bv}us -> {cv}us "
                f"(+{(cv / bv - 1) * 100:.0f}%)")


def _slo_problems(current: dict, baseline: dict) -> list:
    """An SLO row's tail regressions against its baseline: the open-loop
    p99 and p99.9 (latency from the intended start) and every phase's p99,
    so that a slowdown of the tail alone fails the gate."""
    problems: list = []
    cslo = current.get("slo") or {}
    bslo = baseline.get("slo") or {}
    if not cslo or not bslo:
        return problems
    _slo_tail_check("open_loop", bslo.get("open_loop") or {},
                    cslo.get("open_loop") or {},
                    ("p99_us", "p999_us"), problems)
    bphases = bslo.get("phases") or {}
    for ph, c in sorted((cslo.get("phases") or {}).items()):
        b = bphases.get(ph)
        if b:
            _slo_tail_check(f"phase {ph}", b, c, ("p99_us",), problems)
    return problems


def _validate_slo_schema(slo: dict, where: str) -> None:
    """The SLO row contract: exact-sample quantile sections (bucket
    quantiles false-trip a 15% gate), the phases and rates, and the
    verdicts of the reshard, overload, paging and WAN lanes, so that a
    recorded baseline with a broken verdict fails instead of gating."""
    _require(slo.get("quantile_source") == "exact-sample",
             f"{where}: slo rows must use exact-sample quantiles")
    for sec in ("open_loop", "closed_loop"):
        q = slo.get(sec)
        _require(isinstance(q, dict) and "count" in q,
                 f"{where}: missing {sec}")
        if q["count"]:
            for k in ("p50_us", "p99_us", "p999_us", "mean_us", "max_us"):
                _require(k in q, f"{where}: {sec} missing {k}")
    phases = slo.get("phases")
    _require(isinstance(phases, dict) and bool(phases),
             f"{where}: missing phases")
    for ph, q in phases.items():
        _require("p99_us" in q and "count" in q, f"{where}: phase {ph}")
    for k in ("offered_per_s", "achieved_per_s", "counts", "shed_rate",
              "schedule"):
        _require(k in slo, f"{where}: missing {k}")
    if where.startswith("slo-reshard") or "reshard" in slo:
        rs = slo.get("reshard")
        _require(isinstance(rs, dict), f"{where}: missing reshard section")
        _require(rs.get("lost_acks") == 0,
                 f"{where}: reshard row with lost acks: {rs.get('lost_acks')}")
        _require(isinstance(rs.get("time_to_slo_recovery_s"), (int, float)),
                 f"{where}: reshard row without a measured SLO recovery time")
        for k in ("windows", "availability", "events", "audit"):
            _require(k in rs, f"{where}: reshard missing {k}")
        for w in ("before", "during", "after"):
            _require(w in rs["windows"], f"{where}: reshard window {w}")
        _require(rs["audit"].get("agree") is True,
                 f"{where}: reshard row with audit divergence")
    if where.startswith("slo-overload") or "overload" in slo:
        ov = slo.get("overload")
        _require(isinstance(ov, dict), f"{where}: missing overload section")
        for k in ("capacity_probe", "capacity_per_s", "windows",
                  "peak_goodput_per_s", "accounting", "retry_honor_rate"):
            _require(k in ov, f"{where}: overload missing {k}")
        acc = ov["accounting"]
        _require(acc.get("exact") is True,
                 f"{where}: overload accounting identity broken: {acc}")
        _require(acc.get("acked", 0) + acc.get("shed", 0)
                 + acc.get("failed", 0) + acc.get("pending", 0)
                 == acc.get("submitted"),
                 f"{where}: overload accounting does not balance: {acc}")
        _require(acc.get("pending") == 0,
                 f"{where}: overload row with pending ops: {acc}")
        ws = ov["windows"]
        _require(isinstance(ws, list) and bool(ws), f"{where}: empty sweep")
        for w in ws:
            for k in ("multiplier", "offered_per_s", "goodput_per_s",
                      "shed_rate", "classes"):
                _require(k in w, f"{where}: overload window missing {k}")
        g5 = ov.get("goodput_at_5x_frac_of_peak")
        _require(isinstance(g5, (int, float)) and g5 >= 0.9,
                 f"{where}: goodput collapsed past saturation: {g5}")
        hp5, hp0 = ov.get("high_p99_at_5x_us"), \
            ov.get("high_p99_uncontended_us")
        _require(hp5 is not None and bool(hp0) and hp5 <= 2 * hp0,
                 f"{where}: high-priority p99 blew out under overload: "
                 f"{hp5}us vs {hp0}us uncontended")
    if where.startswith("slo-zipf1m") or "paging" in slo:
        pg = slo.get("paging")
        _require(isinstance(pg, dict), f"{where}: missing paging section")
        for k in ("cap", "working_set", "resident_high_water", "hit_rate",
                  "evictions", "refaults", "spilled", "cfk_evictions",
                  "spill_disk_bytes"):
            _require(k in pg, f"{where}: paging missing {k}")
        _require(pg.get("lost_acks") == 0,
                 f"{where}: paging row with lost acks: {pg.get('lost_acks')}")
        _require(pg.get("audit_agree") is True,
                 f"{where}: paging row with audit divergence")
    if where.startswith("slo-wan") or "wan" in slo:
        wan = slo.get("wan")
        _require(isinstance(wan, dict), f"{where}: missing wan section")
        _require(isinstance(wan.get("rtt_us"), (int, float))
                 and wan["rtt_us"] > 0,
                 f"{where}: wan row without injected RTT")
        sweep = wan.get("sweep")
        _require(isinstance(sweep, list) and bool(sweep),
                 f"{where}: empty sweep")
        for arm in sweep:
            for k in ("config", "origin_dc", "electorate",
                      "fast_path_ratio", "p50_rtt_multiple",
                      "p99_rtt_multiple", "wan_crossings_per_txn",
                      "msgs_per_txn", "dcs"):
                _require(k in arm,
                         f"{where}: wan arm {arm.get('config')} missing {k}")
            _require(isinstance(arm["p99_rtt_multiple"], (int, float)),
                     f"{where}: {arm['config']} p99 not an RTT multiple")
        heads = [a for a in sweep
                 if a["config"] == wan.get("headline_config")]
        _require(bool(heads), f"{where}: headline config absent from sweep")
        _require(isinstance(heads[0].get("fast_path_ratio"), (int, float))
                 and heads[0]["fast_path_ratio"] >= 0.8,
                 f"{where}: headline fast_path_ratio broken: "
                 f"{heads[0].get('fast_path_ratio')}")
        pt = wan.get("partition")
        _require(isinstance(pt, dict), f"{where}: missing partition arm")
        for w in ("before", "during", "after"):
            _require(w in (pt.get("windows") or {}),
                     f"{where}: partition window {w}")
        _require(pt.get("lost_acks") == 0,
                 f"{where}: partition arm lost acks: {pt.get('lost_acks')}")
        _require((pt.get("audit") or {}).get("agree") is True,
                 f"{where}: partition arm with audit divergence")


def _guard_baseline(result: dict):
    """The last clean row of the result's config and class, as ``emit``
    found it before replacing it (a stale row never gates)."""
    prev = result.get("prev_same_platform")
    if not prev or prev.get("stale"):
        return None
    return prev


def run_guard(result: dict, config: str) -> int:
    """``--guard``: diff an emitted row against its clean baseline -> 0, or
    2 on a regression past GUARD_PCT, after retiring the fresh row (stale,
    guard_failed) and putting the baseline back."""
    key = history_key(config)
    baseline = _guard_baseline(result)
    if baseline is None:
        print(f"# guard: no clean baseline for config={key}; "
              f"recorded this run as the baseline", file=sys.stderr)
        return 0
    problems = _guard_problems(result, baseline, key)
    if not problems:
        print(f"# guard: OK vs baseline of unix={baseline.get('unix')}",
              file=sys.stderr)
        return 0
    for p in problems:
        print(f"# GUARD REGRESSION ({key}): {p}", file=sys.stderr)
    # the regressed row must not become the next run's baseline
    try:
        pclass = _row_class(result)
        history = _load_history()
        lane = history.setdefault(key, {})
        failed = lane.get(pclass)
        if failed is not None:
            failed = dict(failed)
            failed["guard_failed"] = True
            _supersede(lane, failed, "guard regression")
        restored = dict(baseline)
        restored.pop("stale", None)
        restored.pop("stale_reason", None)
        lane[pclass] = restored
        _write_history(history)
    except OSError:
        pass
    return 2


def run_guard_dry(config: str) -> int:
    """``--guard --dry-run``: no lane runs.  Each row of `config` (a history
    key) is diffed against itself (no regression by construction) and its
    SLO and CPU sections validated, so schema rot in the history fails
    here; prints one JSON object naming each baseline -> 0.  Raises
    AssertionError on a row that breaks the contract."""
    history = _load_history()
    lane = history.get(config, {})
    checked = []
    for pclass, entry in lane.items():
        if pclass == "superseded" or not isinstance(entry, dict):
            continue
        probe = dict(entry)
        probe["metric"] = config
        probe["prev_same_platform"] = entry
        _require(not _guard_problems(probe, entry, config),
                 f"self-diff of {config}/{pclass} reported a regression")
        row = {
            "pclass": pclass, "value": entry.get("value"),
            "stale_superseded": len(lane.get("superseded", [])),
            "profile_kernels": sorted(
                (entry.get("profile") or {}).get("kernels", {})),
        }
        if "slo" in entry:
            _validate_slo_schema(entry["slo"], f"{config}/{pclass}")
            row["slo_open_p99_us"] = entry["slo"]["open_loop"].get("p99_us")
            row["slo_phases"] = sorted(entry["slo"]["phases"])
        if "cpu" in entry:
            _validate_cpu_schema(entry["cpu"], f"{config}/{pclass}")
            row["cpu_verbs"] = sorted(entry["cpu"]["verbs"])
            row["cpu_top"] = [v for v, _ms, _share in entry["cpu"]["top"]]
        checked.append(row)
    print(json.dumps({"metric": f"{config}_guard", "dry_run": True,
                      "history": HISTORY_PATH, "baselines": checked}))
    return 0


# ----------------------------------------------------------------- fill ----

_PROBE = ("import torch\n"
          "ok = torch.cuda.is_available()\n"
          "print(torch.cuda.get_device_name(0) if ok else '')\n")


def _probe_card(timeout_s: float = 120.0) -> Optional[str]:
    """The card's name, from a subprocess bounded by `timeout_s` that asks
    ``torch.cuda.is_available()``; None when it finds no card, fails or
    hangs."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE],
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[-1] if proc.returncode == 0 and lines and lines[-1] \
        else None


def fill_device_rows(max_wait_s: float, configs=None) -> int:
    """Capture the rows of `configs` (in that order; None: FILL_CONFIGS) on
    the card's machine into the rows file and the history -> the number of
    configs still missing when it stops.

    Each config runs as ``python -m accord_tpu_torch.bench --config X
    --json-out <tmp> --record`` in a subprocess under its timeout
    (FILL_CONFIGS', else FILL_TIMEOUT_S), so a run that hangs is killed
    and tried again; each row is written to the rows file as it lands, and
    counts as done once it ran on ``cuda`` (or, for a host lane, on the
    host).  Before each attempt ``_probe_card`` looks for the card; while
    there is none the filler backs off (60 s, doubling to 600 s) and
    records nothing.  It gives up after `max_wait_s`."""
    root = os.path.dirname(_HERE)
    rows = _load_rows()
    timeouts = dict(FILL_CONFIGS)
    if configs is None:
        configs = list(timeouts)
    pending = [(c, timeouts.get(c, FILL_TIMEOUT_S)) for c in configs
               if rows.get(c, {}).get("device") not in ("cuda", "host")]
    deadline = time.time() + max_wait_s
    backoff = 60.0
    while pending and time.time() < deadline:
        card = _probe_card()
        if card is None:
            wait = min(backoff, max(0.0, deadline - time.time()))
            print(f"# no card; {len(pending)} rows pending; backing off "
                  f"{wait:.0f}s", flush=True)
            if wait <= 0:
                break
            time.sleep(wait)
            backoff = min(backoff * 2, 600.0)
            continue
        backoff = 60.0
        cfg, tmo = pending[0]
        fd, out_path = tempfile.mkstemp(prefix=f"bench_{cfg}_",
                                        suffix=".json")
        os.close(fd)
        print(f"# card {card}; running {cfg} (timeout {tmo}s)", flush=True)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "accord_tpu_torch.bench", "--config",
                 cfg, "--json-out", out_path, "--record"],
                timeout=tmo, capture_output=True, text=True, cwd=root)
        except subprocess.TimeoutExpired:
            os.unlink(out_path)
            print(f"# {cfg} timed out after {tmo}s; will retry", flush=True)
            continue
        result = None
        try:
            with open(out_path) as f:
                result = json.loads(f.read())
        except (OSError, ValueError):
            pass
        finally:
            os.unlink(out_path)
        if proc.returncode != 0 or result is None:
            tail = (proc.stderr or "")[-500:]
            print(f"# {cfg} failed (rc={proc.returncode}): {tail}",
                  flush=True)
            time.sleep(30)
            continue
        result["captured_unix"] = int(time.time())
        _store_row(cfg, result)
        print(f"# {cfg} captured on {result.get('device')} "
              f"({result.get('hardware')}): {result.get('value')} "
              f"{result.get('unit')} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if result.get("device") not in ("cuda", "host"):
            continue
        pending.pop(0)
    return len(pending)
