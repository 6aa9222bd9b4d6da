"""Cross-node snapshot merging + the human/bench summary + SLO reports.

`summarize` turns a (possibly merged) registry snapshot into the compact
report the bench records next to its BENCH_HISTORY row and the burn prints
at end of run: fast-path ratio, coordination outcomes, per-phase latency
quantiles, device flush-window counts, pipeline admission counters.

`slo_report` builds the open-loop workload harness's SLO row
(accord_tpu_torch/workload/): exact-sample p50/p99/p99.9 — NEVER the registry's
log2-bucket quantiles, whose up-to-2x error would false-trip a 15% tail
gate (the reason the kernel profiler keeps a raw-sample buffer) —
for open-loop (intended-start) and closed-loop (submit-start) latency,
per-phase attribution, and achieved-vs-offered rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from accord_tpu_torch.obs.cpuprof import merge_cpu_exports
from accord_tpu_torch.obs.registry import (merge_snapshots, parse_labels,
                                     snapshot_quantile)


def merge_node_snapshots(snaps: List[dict]) -> dict:
    """Merge NodeObs.snapshot() dicts from several nodes/processes into one
    cluster view: {"nodes": [...], "metrics": merged, "summary": ...}.
    Protocol-CPU raw samples ("cpu" key, obs/cpuprof.py) pool across nodes
    so the summary's exact-sample per-verb quantiles stay exact."""
    snaps = [s for s in snaps if s]
    metrics = merge_snapshots([s.get("metrics", {}) for s in snaps])
    cpu = merge_cpu_exports([s.get("cpu") for s in snaps])
    return {"nodes": [s.get("node") for s in snaps], "metrics": metrics,
            "summary": summarize(metrics, cpu=cpu)}


def _counter_by_label(metrics: dict, name: str, label: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for lk, v in metrics.get("counters", {}).get(name, {}).items():
        key = parse_labels(lk).get(label, "")
        out[key] = out.get(key, 0) + v
    return out


def _counter_total(metrics: dict, name: str) -> int:
    return sum(metrics.get("counters", {}).get(name, {}).values())


def _gauge_max(metrics: dict, name: str) -> int:
    vals = metrics.get("gauges", {}).get(name, {}).values()
    return max(vals) if vals else 0


def _gauge_sum_by_label(metrics: dict, name: str, label: str) -> Dict[str, int]:
    """Sum one gauge family across label sets grouped by `label` — census
    gauges carry a node label, so the cross-node merge (max per label set)
    keeps per-node values distinct and summing over them is the cluster
    total."""
    out: Dict[str, int] = {}
    for lk, v in metrics.get("gauges", {}).get(name, {}).items():
        key = parse_labels(lk).get(label, "")
        out[key] = out.get(key, 0) + v
    return out


def _gauge_total(metrics: dict, name: str) -> int:
    return sum(metrics.get("gauges", {}).get(name, {}).values())


def _per_shard_census(metrics: dict) -> Dict[str, dict]:
    """Cluster-wide per-shard command/pager table from the shard-labeled
    gauge series (emitted only under the worker runtime — local/audit.py
    census_once; empty dict when in-loop).  Series WITHOUT a shard label
    are the node rollups and are deliberately excluded: the rollup and
    the shard rows would double-count if folded together."""
    out: Dict[str, dict] = {}

    def row(shard: str) -> dict:
        return out.setdefault(shard, {"resident": 0, "spilled": 0,
                                      "pager": {}})

    for lk, v in metrics.get("gauges", {}).get("accord_census_commands",
                                               {}).items():
        labels = parse_labels(lk)
        shard = labels.get("shard", "")
        tier = labels.get("tier", "")
        if shard and tier in ("resident", "spilled"):
            row(shard)[tier] += v
    for name, series in metrics.get("gauges", {}).items():
        if not name.startswith("accord_pager_"):
            continue
        key = name[len("accord_pager_"):]
        for lk, v in series.items():
            shard = parse_labels(lk).get("shard", "")
            if shard:
                pg = row(shard)["pager"]
                pg[key] = pg.get(key, 0) + v
    return out


def _gauge_max_by_label(metrics: dict, name: str, label: str
                        ) -> Dict[str, int]:
    """Worst (max) value of one gauge family grouped by `label`."""
    out: Dict[str, int] = {}
    for lk, v in metrics.get("gauges", {}).get(name, {}).items():
        key = parse_labels(lk).get(label, "")
        out[key] = max(out.get(key, v), v)
    return out


def _hists_by_label(metrics: dict, name: str, label: str) -> Dict[str, dict]:
    """Merge one histogram family's snapshots grouped by a label value."""
    out: Dict[str, dict] = {}
    for lk, h in metrics.get("histograms", {}).get(name, {}).items():
        key = parse_labels(lk).get(label, "")
        cur = out.setdefault(key, {"count": 0, "sum": 0, "buckets": {}})
        cur["count"] += h.get("count", 0)
        cur["sum"] += h.get("sum", 0)
        for e, n in h.get("buckets", {}).items():
            cur["buckets"][e] = cur["buckets"].get(e, 0) + n
    return out


def _merged_hist(metrics: dict, name: str) -> dict:
    """One histogram family merged across every label set."""
    out = {"count": 0, "sum": 0, "buckets": {}}
    for h in metrics.get("histograms", {}).get(name, {}).values():
        out["count"] += h.get("count", 0)
        out["sum"] += h.get("sum", 0)
        for e, n in h.get("buckets", {}).items():
            out["buckets"][e] = out["buckets"].get(e, 0) + n
    return out


def _hist_report(h: dict) -> dict:
    count = h.get("count", 0)
    return {"count": count,
            "mean": round(h.get("sum", 0) / count, 1) if count else 0.0,
            "p50": snapshot_quantile(h, 0.50),
            "p95": snapshot_quantile(h, 0.95)}


def _infer_section(metrics: dict) -> dict:
    """The Infer-ladder A/B (coordinate/infer.py): every
    accord_infer_total kind, plus the no-round ratio — of the
    interrogations that established a per-shard evidence quorum
    (resolvable with zero extra rounds), how many the active
    configuration actually settled without a ballot round.  Comparing
    this section across ACCORD_INFER_FULL=0/1 snapshots of the same seed
    IS the pricing comparison (tests/test_infer.py)."""
    kinds = _counter_by_label(metrics, "accord_infer_total", "kind")
    quorum = kinds.get("quorum_evidence", 0)
    no_round = kinds.get("no_round_commits", 0)
    kinds["no_round_ratio"] = (round(no_round / quorum, 4)
                               if quorum else None)
    return kinds


# ------------------------------------------------------------- SLO rows ----

SLO_QUANTILES = ((0.50, "p50_us"), (0.99, "p99_us"), (0.999, "p999_us"))


def exact_quantiles_us(samples) -> dict:
    """Exact nearest-rank quantiles from raw microsecond samples.  The
    quantile path every SLO lane uses (quantile_source=exact-sample): the
    log2-bucket histograms stay for always-on monitoring, but a tail GATE
    needs sample-exact numbers (tests/test_obs.py pins the bucket path's
    error bound at [1x, 2x) — far above a 15% threshold)."""
    s = sorted(samples)
    n = len(s)
    if n == 0:
        return {"count": 0}
    out = {"count": n,
           "mean_us": round(sum(s) / n, 1),
           "max_us": int(s[-1])}
    for q, name in SLO_QUANTILES:
        rank = max(1, min(n, int(q * n + 0.9999999)))
        out[name] = int(s[rank - 1])
    return out


def slo_report(open_samples_us, closed_samples_us,
               phase_samples_us: Dict[str, list],
               counts: Dict[str, int], offered_per_s: float,
               duration_s: float, schedule: Optional[dict] = None,
               summary: Optional[dict] = None) -> dict:
    """The SLO row an open-loop lane records into BENCH_HISTORY (and
    `bench.py --guard` gates): open-loop latency is measured from each
    op's INTENDED start, so coordinator stalls are charged to the tail
    instead of silently pausing the load (coordinated omission);
    closed-loop is the same acked ops measured from actual submit — the
    two diverge exactly by the omitted time.

    phase_samples_us: per-phase exact samples from joining the intended-
    start ledger against the trace spans (obs/spans.phase_deltas),
    plus the synthetic "admission" phase (begin - intended: scheduling +
    pipeline queueing + any stall ahead of the coordinator)."""
    submitted = sum(counts.get(k, 0)
                    for k in ("acked", "shed", "failed", "pending"))
    acked = counts.get("acked", 0)
    report = {
        "quantile_source": "exact-sample",
        "schedule": schedule or {},
        "offered_per_s": round(offered_per_s, 1),
        "achieved_per_s": (round(acked / duration_s, 1)
                           if duration_s > 0 else 0.0),
        "duration_s": round(duration_s, 3),
        "counts": dict(counts),
        "shed_rate": (round(counts.get("shed", 0) / submitted, 4)
                      if submitted else 0.0),
        "open_loop": exact_quantiles_us(open_samples_us),
        "closed_loop": exact_quantiles_us(closed_samples_us),
        "phases": {ph: exact_quantiles_us(samples)
                   for ph, samples in sorted(phase_samples_us.items())
                   if samples},
    }
    if summary is not None:
        report["fast_path_ratio"] = summary.get("fast_path_ratio")
        report["recoveries"] = summary.get("recoveries", 0)
    return report


# ------------------------------------------------------------ CPU rows ----

# how many verbs the "top verbs by total CPU" table keeps
_CPU_TOP_N = 10


def cpu_section(cpu: Optional[dict]) -> dict:
    """The protocol-CPU waterfall summary: per-verb
    exact-sample p50/p99 of the per-dispatch total plus per-(verb, stage)
    quantiles, and the top-verbs-by-total-CPU table.  `cpu` is a (possibly
    cross-node pooled) CpuProfiler export; estimated totals scale each
    verb's sampled mean by its FULL dispatch census, so 1-in-N sampling
    does not skew the ranking.  Exact-sample quantiles only — the log2
    buckets stay for always-on monitoring, but a `--guard` gate needs
    sample-exact numbers, as the kernel profiler does)."""
    section = {"quantile_source": "exact-sample", "sampled": 0,
               "dispatches": 0, "verbs": {}, "top": []}
    if not cpu:
        return section
    section["sampled"] = cpu.get("sampled", 0)
    dispatches = cpu.get("dispatches", {})
    section["dispatches"] = sum(dispatches.values())
    verbs = {}
    grand_ms = 0.0
    for verb, samples in sorted(cpu.get("totals", {}).items()):
        if not samples:
            continue
        q = exact_quantiles_us(samples)
        n_disp = dispatches.get(verb, q["count"])
        est_ms = round(q["mean_us"] * n_disp / 1e3, 2)
        grand_ms += est_ms
        stages = {st: exact_quantiles_us(ss) for st, ss in
                  sorted(cpu.get("stages", {}).get(verb, {}).items()) if ss}
        verbs[verb] = dict(q, dispatches=n_disp, est_total_ms=est_ms,
                           stages=stages)
    section["verbs"] = verbs
    top = sorted(((v, d["est_total_ms"]) for v, d in verbs.items()),
                 key=lambda x: -x[1])[:_CPU_TOP_N]
    section["top"] = [[v, ms, round(ms / grand_ms, 4) if grand_ms else 0.0]
                      for v, ms in top]
    return section


def loop_section(metrics: dict) -> dict:
    """Event-loop health (obs/cpuprof.LoopHealth, always-on in the
    wall-clock hosts): timer lag, tick busy time, dispatch-burst shape,
    high-water backlog, and alarm counts."""
    return {
        "lag_us": _hist_report(_merged_hist(metrics, "accord_loop_lag_us")),
        "tick_us": _hist_report(_merged_hist(metrics,
                                             "accord_loop_tick_us")),
        "burst_msgs": _hist_report(_merged_hist(metrics,
                                                "accord_loop_burst_msgs")),
        "depth_max": _gauge_max(metrics, "accord_loop_depth_max"),
        "lag_alarms": _counter_total(metrics,
                                     "accord_loop_lag_alarms_total"),
        "saturation_alarms": _counter_total(
            metrics, "accord_loop_queue_saturation_total"),
    }


def _qos_section(metrics: dict) -> dict:
    """QoS admission-tier report (qos/): cluster totals, per-priority
    split (the fairness surface: shed{high} must stay 0 while best_effort
    is being admitted), and per-tenant admitted-goodput/shed-rate."""
    submitted = _counter_total(metrics, "accord_qos_submitted_total")
    inner = _counter_total(metrics, "accord_qos_inner_shed_total")
    if not submitted and not inner:
        return {"submitted": 0}
    by_tenant_sub = _counter_by_label(metrics, "accord_qos_submitted_total",
                                      "tenant")
    by_tenant_adm = _counter_by_label(metrics, "accord_qos_admitted_total",
                                      "tenant")
    tenants = {}
    for tenant, sub in sorted(by_tenant_sub.items()):
        adm = by_tenant_adm.get(tenant, 0)
        tenants[tenant] = {
            "submitted": sub, "admitted": adm,
            "shed_rate": round(1.0 - adm / sub, 4) if sub else 0.0}
    return {
        "submitted": submitted,
        "admitted": _counter_total(metrics, "accord_qos_admitted_total"),
        "shed": _counter_total(metrics, "accord_qos_shed_total"),
        "throttled": _counter_total(metrics, "accord_qos_throttled_total"),
        "inner_shed": inner,
        "admitted_by_priority": _counter_by_label(
            metrics, "accord_qos_admitted_total", "priority"),
        "shed_by_priority": _counter_by_label(
            metrics, "accord_qos_shed_total", "priority"),
        "throttled_by_priority": _counter_by_label(
            metrics, "accord_qos_throttled_total", "priority"),
        "tenants": tenants,
        "pressure_milli_max": _gauge_max(metrics,
                                         "accord_qos_pressure_milli"),
    }


def _wan_section(metrics: dict) -> dict:
    """Geo-placement attribution (topology/geo.GeoProfile): fast/slow
    split per coordinator DC and per electorate membership (the dc=/elect=
    labels NodeObs adds when a profile is installed), plus messages/txn
    per link class — the slo-wan lane's recorded surface, and the
    msgs_per_txn census doubles as the yardstick for the structural
    message-reduction roadmap item.  Empty dict when the run is geo-free
    (no dc-labeled counters, no link census)."""
    per_dc: Dict[str, dict] = {}
    per_elect: Dict[str, dict] = {}
    for lk, v in metrics.get("counters", {}).get(
            "accord_path_total", {}).items():
        labels = parse_labels(lk)
        dc = labels.get("dc")
        if not dc:
            continue
        path = labels.get("path", "")
        d = per_dc.setdefault(dc, {"fast": 0, "slow": 0})
        d[path] = d.get(path, 0) + v
        elect = labels.get("elect")
        if elect:
            e = per_elect.setdefault(elect, {"fast": 0, "slow": 0})
            e[path] = e.get(path, 0) + v
    for d in list(per_dc.values()) + list(per_elect.values()):
        done = d.get("fast", 0) + d.get("slow", 0)
        d["fast_path_ratio"] = (round(d.get("fast", 0) / done, 4)
                                if done else None)
    link_msgs = _counter_by_label(metrics, "accord_link_msgs_total", "cls")
    link_bytes = _counter_by_label(metrics, "accord_link_bytes_total", "cls")
    if not per_dc and not link_msgs and not link_bytes:
        return {}
    committed = sum(d.get("fast", 0) + d.get("slow", 0)
                    for d in per_dc.values())
    return {
        "dcs": {dc: per_dc[dc] for dc in sorted(per_dc)},
        "by_elect": {e: per_elect[e] for e in sorted(per_elect)},
        "link_msgs": link_msgs,
        "link_bytes": link_bytes,
        "msgs_per_txn": ({cls: round(n / committed, 2)
                          for cls, n in sorted(link_msgs.items())}
                         if committed else {}),
        "wan_crossings_per_txn": (round(link_msgs.get("wan", 0)
                                        / committed, 2)
                                  if committed else None),
        "wan_bytes_per_txn": (round(link_bytes.get("wan", 0) / committed, 1)
                              if committed and link_bytes else None),
    }


def summarize(metrics: dict, cpu: Optional[dict] = None) -> dict:
    paths = _counter_by_label(metrics, "accord_path_total", "path")
    fast = paths.get("fast", 0)
    slow = paths.get("slow", 0)
    outcomes = _counter_by_label(metrics,
                                 "accord_coordinate_outcomes_total",
                                 "outcome")
    started = _counter_by_label(metrics, "accord_coordinate_started_total",
                                "path")
    phase_hists = _hists_by_label(metrics, "accord_phase_latency_us",
                                  "phase")
    frames = _counter_total(metrics, "accord_tcp_frames_total")
    msgs = _counter_total(metrics, "accord_tcp_msgs_total")
    return {
        "fast_path": fast,
        "slow_path": slow,
        "fast_path_ratio": (round(fast / (fast + slow), 4)
                            if fast + slow else None),
        "started": started,
        "outcomes": outcomes,
        "recoveries": started.get("recovery", 0),
        "phase_latency_us": {ph: _hist_report(h)
                             for ph, h in sorted(phase_hists.items())},
        "txn_latency_us": {p: _hist_report(h) for p, h in sorted(
            _hists_by_label(metrics, "accord_txn_latency_us",
                            "path").items())},
        "device": {
            "flush_windows": _counter_total(
                metrics, "accord_device_flush_windows_total"),
            "cross_txn_windows": _counter_total(
                metrics, "accord_device_cross_txn_windows_total"),
            "window_txn_max": _gauge_max(metrics,
                                         "accord_device_window_txn_max"),
            "hits": _counter_total(metrics, "accord_device_hits_total"),
            "misses": _counter_total(metrics, "accord_device_misses_total"),
            "compile_shapes": _counter_total(
                metrics, "accord_device_compile_shapes_total"),
        },
        "pipeline": {
            "submitted": _counter_total(metrics,
                                        "accord_pipeline_submitted_total"),
            "shed": _counter_total(metrics, "accord_pipeline_shed_total"),
            "batches": _counter_total(metrics,
                                      "accord_pipeline_batches_total"),
            "dispatched": _counter_total(metrics,
                                         "accord_pipeline_dispatched_total"),
            "batch_size_max": _gauge_max(metrics,
                                         "accord_pipeline_batch_size_max"),
            # admission->dispatch wait (per-txn mean per batch): the
            # pipeline's contribution to the SLO lanes' "admission" phase
            "queue_wait_us": _hist_report(_merged_hist(
                metrics, "accord_pipeline_queue_wait_us")),
        },
        "qos": _qos_section(metrics),
        "transport": {
            # per-peer frame coalescing at the TCP egress buffer
            # (host/tcp.py): how many protocol messages each wire frame
            # amortised, and the frame-size shape — the coalescing-ratio
            # surface the tcp/multicore bench rows record
            "frames": frames,
            "msgs": msgs,
            "coalesce_ratio": (round(msgs / frames, 3) if frames else None),
            "frame_bytes": _hist_report(_merged_hist(
                metrics, "accord_tcp_frame_bytes")),
            "frame_msgs": _hist_report(_merged_hist(
                metrics, "accord_tcp_frame_msgs")),
            "shed": _counter_total(metrics, "accord_tcp_peer_shed_total"),
            "send_drops": _counter_total(
                metrics, "accord_tcp_peer_send_drops_total"),
            "retries": _counter_total(metrics,
                                      "accord_tcp_peer_retries_total"),
            # per-link-class census under a geo profile (topology/geo.py):
            # msgs counted at the sim delivery / tcp flush, bytes+frames
            # at the tcp flush with real frame sizes — WAN bytes/txn is
            # the first-class per-txn number in the "wan" section
            "link_msgs": _counter_by_label(metrics,
                                           "accord_link_msgs_total", "cls"),
            "link_bytes": _counter_by_label(metrics,
                                            "accord_link_bytes_total",
                                            "cls"),
            "link_frames": _counter_by_label(metrics,
                                             "accord_link_frames_total",
                                             "cls"),
        },
        "wan": _wan_section(metrics),
        "cpu": cpu_section(cpu),
        "loop": loop_section(metrics),
        "infer": _infer_section(metrics),
        "audit": {
            # replica-state auditor (local/audit.py): digest-round
            # outcomes, confirmed divergences by kind, drill-down volume
            "rounds": _counter_by_label(metrics,
                                        "accord_audit_rounds_total",
                                        "outcome"),
            "mismatches": _counter_total(metrics,
                                         "accord_audit_mismatch_total"),
            "divergences": _counter_by_label(
                metrics, "accord_audit_divergence_total", "kind"),
            "drill_requests": _counter_total(metrics,
                                             "accord_audit_drill_total"),
            "entries_checked": _counter_total(
                metrics, "accord_audit_entries_total"),
        },
        "census": {
            # state-lifecycle census (local/audit.py): cluster-wide
            # resident totals by class, cleanup-leak alarms, and the
            # worst per-node cleanup lag per watermark kind
            "sweeps": _counter_total(metrics, "accord_census_sweeps_total"),
            "resident": _gauge_total(metrics,
                                     "accord_census_resident_total"),
            "by_class": _gauge_sum_by_label(metrics,
                                            "accord_census_resident",
                                            "cls"),
            "quiescent_uncleaned": _gauge_total(
                metrics, "accord_census_quiescent_uncleaned"),
            "resident_bytes_est": _gauge_total(
                metrics, "accord_census_resident_bytes_est"),
            "leak_alarms": _counter_total(
                metrics, "accord_census_leak_alarms_total"),
            "watermark_lag_us": _gauge_max_by_label(
                metrics, "accord_watermark_lag_us", "kind"),
            # worker runtime only: per-shard resident/spilled/pager rows
            # (shard-labeled series; {} when every node runs in-loop)
            "per_shard": _per_shard_census(metrics),
        },
        "journal": {
            "appends": _counter_total(metrics,
                                      "accord_journal_appends_total"),
            "append_bytes": _counter_total(
                metrics, "accord_journal_append_bytes_total"),
            "fsyncs": _counter_total(metrics, "accord_journal_fsync_total"),
            "rotations": _counter_total(metrics,
                                        "accord_journal_rotations_total"),
            "snapshots": _counter_total(metrics,
                                        "accord_journal_snapshots_total"),
            "group_commit_batch": _hist_report(_merged_hist(
                metrics, "accord_journal_group_commit_batch")),
            "replay_records": _counter_total(
                metrics, "accord_journal_replay_records_total"),
            "replay_us": _hist_report(_merged_hist(
                metrics, "accord_journal_replay_duration_us")),
        },
    }
