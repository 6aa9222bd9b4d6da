"""Always-on flight recorder: a bounded per-node ring of structured events.

Spans (obs/spans.py) answer "where did the time go" for transactions we
chose to follow; the flight recorder answers "what happened just before it
went wrong" for EVERYTHING, all the time.  Each node keeps one fixed-size
ring (a deque with maxlen — no allocation beyond the event slot itself)
recording command status transitions, message tx/rx/drop, progress-log
escalations and pipeline admission decisions, each stamped with the span
trace id where one exists.  On a burn/verify/journal failure the rings are
stitched across replicas into one causally ordered timeline for the
offending transactions — the failure artifact (sim/burn.py), also exposed
live via `burn --flight-dump`, the tcp host's "flight" frame, and the
metrics endpoint's `/flight?txn=` route.

Event layout (one fixed tuple per slot, hot paths avoid dicts):

    (at_us, seq, kind, trace_id, data)

`kind` MUST appear in EVENT_KINDS below — tests/test_span_coverage.py
statically asserts every literal kind recorded anywhere in the tree is
documented here (and vice versa), so a new event class cannot silently
skip the forensics layer.  `data` is kind-specific (see the table).

HARD CONSTRAINT (package docstring): no jax/numpy imports, intra-package
accord_tpu_torch imports only; always-on overhead is budgeted <2% of the scalar
hot loop by tests/test_obs_budget.py.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# Every event kind any call site may record, with its data layout.
# Documentation IS the registry: the span-coverage lint fails when a
# `flight.record("<kind>", ...)` literal is absent from this table.
EVENT_KINDS = {
    "status": "command status transition (local/command.py); "
              "data=(store_id, prev_status, new_status)",
    "tx": "outbound request (local/node.py Node.send); data=(to, verb)",
    "reply": "outbound reply (local/node.py Node.reply); data=(to, verb)",
    "rx": "inbound request dispatched (local/node.py Node._process); "
          "data=(from_id, verb)",
    "drop": "simulated network dropped a message (sim/network.py), "
            "recorded on the SENDER's ring; data=(from_id, to, verb)",
    "escalate": "progress-log escalation (impl/progress_log.py); "
                "data=(store_id, what, attempts)",
    "pipeline_admit": "ingest admission (pipeline/ingest.py); "
                      "data=(queue_depth,)",
    "pipeline_shed": "ingest admission shed -> Rejected "
                     "(pipeline/ingest.py); data=(queue_depth,)",
    "pipeline_batch": "ingest batch closed (pipeline/ingest.py); "
                      "data=(size, by_deadline)",
    "journal_append": "WAL record framed into the active segment "
                      "(journal/wal.py); data=(seq, payload_bytes)",
    "journal_rotate": "WAL segment rotated at the size threshold "
                      "(journal/wal.py); data=(new_segment_index,)",
    "journal_snapshot": "snapshot compaction folded + retired segments "
                        "(journal/wal.py); data=(records_in, records_out, "
                        "segments_retired)",
    "journal_replay_begin": "crash-restart journal replay started "
                            "(journal/replay.py); data=(records,)",
    "journal_replay_end": "crash-restart journal replay finished "
                          "(journal/replay.py); data=(records, txns)",
    "infer_evidence": "per-shard quorum of InvalidIf invalidation evidence "
                      "established by a CheckStatus round "
                      "(coordinate/fetch.py); data=(evidence_replies, "
                      "contacted)",
    "infer_invalidate": "invalidation committed with no extra round off "
                        "quorum evidence, or inferred locally by the "
                        "safe-to-clean sweep (coordinate/infer.py, "
                        "coordinate/recover.py, local/cleanup.py); "
                        "data=(site, merged_status)",
    "audit_digest": "cross-replica range-digest round settled "
                    "(local/audit.py); data=(range_start, range_end, "
                    "replicas, outcome)",
    "audit_divergence": "replica-state divergence confirmed by the audit "
                        "drill-down (local/audit.py), trace id = the "
                        "divergent txn; data=(kind, range_start, "
                        "range_end, disagreeing_nodes)",
    "census_sweep": "state-lifecycle census sweep completed "
                    "(local/audit.py); data=(resident, "
                    "quiescent_uncleaned, bytes_est)",
    "frame_coalesce": "message captured into a peer's transport egress "
                      "buffer (host/tcp.py), trace id = the bundled "
                      "message's; data=(peer, pending_in_buffer)",
    "frame_flush": "per-peer egress buffer left as ONE coalesced wire "
                   "frame (host/tcp.py); data=(peer, messages, bytes)",
    "loop_lag": "event-loop timer fired later than its deadline by more "
                "than the alarm threshold (obs/cpuprof.LoopHealth, wired "
                "by host/tcp.py and host/maelstrom.py; rate-limited); "
                "data=(lag_us,)",
    "queue_saturation": "event-loop backlog crossed the saturation "
                        "threshold (obs/cpuprof.LoopHealth, wired by "
                        "host/tcp.py and host/maelstrom.py; edge-"
                        "triggered); data=(depth,)",
    "epoch_install": "admin-plane epoch install accepted/journaled "
                     "(impl/config_service.py); data=(epoch, from_id)",
    "bootstrap_begin": "bootstrap attempt fenced + fetch started "
                       "(local/bootstrap.py); data=(epoch, attempt)",
    "bootstrap_checkpoint": "bootstrap progress checkpoint journaled — "
                            "crash resumes from here instead of "
                            "re-fetching (local/bootstrap.py); "
                            "data=(epoch, attempt, n_ranges)",
    "bootstrap_done": "bootstrap attempt chain settled ok/failed "
                      "(local/bootstrap.py); data=(epoch, attempt, "
                      "outcome)",
    "drain_begin": "scale-in drain fence raised on/about a retiring node "
                   "(messages/admin.py); data=(node_id, from_id)",
    "drain_done": "retiring node durably handed off + retired "
                  "(messages/admin.py); data=(node_id, from_id)",
    "cmd_evict": "quiescent command evicted from the resident tier to the "
                 "spill store (local/paging.py), trace id = the evicted "
                 "txn; data=(store_id, save_status)",
    "cmd_fault": "spilled command faulted back resident on access — one "
                 "fault-index point read (local/paging.py), trace id = "
                 "the faulted txn; data=(store_id, save_status)",
    "page_spill": "spill frame appended to the paging tier's on-disk "
                  "store (journal/fault_index.py); data=(segment, offset, "
                  "payload_bytes)",
    "qos_admit": "submit admitted by the QoS tier (qos/admission.py; "
                 "sampled 1-in-64 so a healthy host does not wash out its "
                 "own ring); data=(tenant, priority, admitted_since_last)",
    "qos_shed": "submit shed by the QoS tier — pressure above the class "
                "threshold, or the pipeline's last-resort inner ring "
                "(qos/admission.py); data=(tenant, priority, reason, "
                "millipressure)",
    "qos_throttle": "submit throttled by the QoS tier — tenant token "
                    "bucket empty (qos/admission.py); data=(tenant, "
                    "priority, retry_after_us)",
    "shard_spawn": "shard worker process spawned (or respawned after a "
                   "crash) by the supervisor (shard/supervisor.py); "
                   "data=(shard, pid, generation)",
    "shard_submit": "shard-affine request shipped over a worker pipe "
                    "(shard/supervisor.py), trace id = the request's; "
                    "data=(shard, verb)",
    "shard_reduce": "cross-worker fan-out reduced to one reply "
                    "(shard/supervisor.py), trace id = the request's; "
                    "data=(n_shards, verb)",
    "shard_retire": "shard worker drained and retired "
                    "(shard/supervisor.py); data=(shard, generation)",
    "geo_install": "geo placement profile installed on this node "
                   "(sim/cluster.py at build; host/tcp.py from ACCORD_GEO "
                   "or an EpochInstall frame); data=(profile_name, dc)",
    "dc_partition_begin": "a whole datacenter severed from the rest of "
                          "the cluster (sim/network.py DcPartitionNemesis; "
                          "recorded on every live node); data=(dc, "
                          "dc_node_ids)",
    "dc_partition_heal": "the DC partition healed (sim/network.py "
                         "DcPartitionNemesis); data=(dc, dc_node_ids)",
}


class FlightRecorder:
    """Bounded always-on event ring for one node.

    `record` is the only hot-path entry: one clock read, one tuple, one
    deque append.  The ring is a deque with maxlen, so capacity overflow
    evicts the oldest slot with no per-event allocation churn."""

    __slots__ = ("node_id", "capacity", "events", "enabled", "_clock_us",
                 "_seq", "recorded_total")

    def __init__(self, node_id: int = 0, capacity: int = 4096,
                 clock_us=None):
        self.node_id = node_id
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        # always-on by design; ACCORD_FLIGHT=0 is the emergency kill
        # switch (and the overhead-A/B lever for the bench)
        self.enabled = os.environ.get("ACCORD_FLIGHT", "1") != "0"
        self._clock_us = clock_us if clock_us is not None else (lambda: 0)
        self._seq = 0
        self.recorded_total = 0  # lifetime count (ring wrap diagnostics)

    def record(self, kind: str, trace_id: Optional[str] = None,
               data=None) -> None:
        if not self.enabled:
            return
        seq = self._seq = self._seq + 1
        self.recorded_total += 1
        self.events.append((self._clock_us(), seq, kind, trace_id, data))

    # ------------------------------------------------------------- query --
    def tail(self, n: int = 200) -> List[tuple]:
        events = list(self.events)
        return events[-n:]

    def for_trace(self, trace_id: str) -> List[tuple]:
        return [e for e in self.events if e[3] == trace_id]

    def trace_ids(self) -> set:
        return {e[3] for e in self.events if e[3] is not None}

    def __len__(self):
        return len(self.events)


def stitch_flight(recorders: Iterable[FlightRecorder],
                  trace_ids=None, limit: Optional[int] = None
                  ) -> List[tuple]:
    """Merge rings across replicas into one causally ordered timeline:
    [(at_us, node_id, seq, kind, trace_id, data)].  `trace_ids` (a set)
    filters to the offending transactions; None merges everything.  Order
    is (at_us, node_id, seq) — per-node clocks may drift in sim, so the
    global order is best-effort while each node's subsequence is exact."""
    ids = set(trace_ids) if trace_ids is not None else None
    merged = []
    for rec in recorders:
        for at, seq, kind, tid, data in rec.events:
            if ids is None or tid in ids:
                merged.append((at, rec.node_id, seq, kind, tid, data))
    merged.sort(key=lambda e: (e[0], e[1], e[2]))
    if limit is not None and len(merged) > limit:
        merged = merged[-limit:]
    return merged


def trace_ids_in_text(recorders: Iterable[FlightRecorder],
                      text: str) -> set:
    """Trace ids present in any ring that also appear verbatim in `text`
    (failure messages embed TxnId reprs == trace ids; this recovers the
    offending transactions from an arbitrary assertion string)."""
    found = set()
    for rec in recorders:
        for tid in rec.trace_ids():
            if tid not in found and tid in text:
                found.add(tid)
    return found


def first_divergence(events: List[tuple]) -> Optional[tuple]:
    """First point where replicas' per-trace status histories disagree.

    Groups the stitched timeline's "status" events by node and walks the
    per-node transition sequences in lockstep: the first index at which
    the nodes that got that far do not all agree is the earliest observable
    divergence — the event a replay/verify failure should lead with.
    Returns (index, {node_id: transition-or-None}) or None when every
    node's recorded history is a prefix of the longest one."""
    by_node: Dict[int, List[Tuple]] = {}
    for _at, node_id, _seq, kind, _tid, data in events:
        if kind == "status":
            by_node.setdefault(node_id, []).append(data)
    if len(by_node) < 2:
        return None
    longest = max(len(v) for v in by_node.values())
    for i in range(longest):
        at_i = {n: (seqs[i] if i < len(seqs) else None)
                for n, seqs in by_node.items()}
        present = {v for v in at_i.values() if v is not None}
        if len(present) > 1:
            return (i, at_i)
    return None


def format_timeline(events: List[tuple], header: str = "") -> str:
    """Human-readable failure artifact for a stitched timeline."""
    lines = [header] if header else []
    if not events:
        lines.append("  (no flight events retained for these trace ids — "
                     "ring may have wrapped)")
        return "\n".join(lines)
    t0 = events[0][0]
    for at, node_id, _seq, kind, tid, data in events:
        body = f"  +{at - t0:>9}us n{node_id} {kind:<14}"
        if data is not None:
            body += f" {_fmt_data(kind, data)}"
        if tid is not None:
            body += f"  [{tid}]"
        lines.append(body)
    return "\n".join(lines)


def _fmt_data(kind: str, data) -> str:
    if kind == "status" and isinstance(data, tuple) and len(data) == 3:
        return f"s{data[0]} {data[1]}->{data[2]}"
    if kind in ("tx", "reply") and isinstance(data, tuple):
        return f"to=n{data[0]} {data[1]}"
    if kind == "rx" and isinstance(data, tuple):
        return f"from=n{data[0]} {data[1]}"
    if kind == "drop" and isinstance(data, tuple) and len(data) == 3:
        return f"n{data[0]}->n{data[1]} {data[2]}"
    if isinstance(data, tuple):
        return " ".join(str(d) for d in data)
    return str(data)
