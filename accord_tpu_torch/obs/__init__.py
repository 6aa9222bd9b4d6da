"""Unified observability: metrics registry + per-transaction trace spans.

The reference observes through slf4j logging plus ad-hoc burn counters;
this package replaces the port's scattered stat dicts (`Node.infer_stats`,
the pipeline's per-stage counters, the device store's flush-window tallies)
with one process-local layer:

  * `registry` — counters, gauges and log-bucketed histograms with labels,
    snapshot()-able to plain JSON and renderable as Prometheus text;
  * `spans` — lightweight per-transaction trace spans keyed by the txn id,
    following a transaction through PreAccept -> Accept -> Commit ->
    Execute/Apply and tagging fast-path / slow-path / recovery.  The trace
    id rides INSIDE the existing wire envelopes (`messages/base.py` sets an
    optional `trace_id` attribute that `host/wire.py`'s structural codec
    round-trips for free), so a span stitches across replicas in sim and
    over TCP alike;
  * `flight` — the always-on bounded flight recorder: one fixed-size ring
    per node of status transitions / message tx-rx / escalations /
    admission decisions, stitched across replicas into the failure
    artifact when a burn or verify check goes red;
  * `profiler` — kernel-level fenced wall timers and a shape ledger
    (sampled via `ACCORD_PROFILE=N`, off by default; fences are injected
    by the device layer so this package stays jax- and torch-free), and
    the span hook: `span(name)` is a range of the factory `set_tracer`
    installed, else one shared null context.  The device store opens
    ``accord.flush`` (a drained window) over ``accord.deps.snapshot``,
    ``.encode`` (the index walk), ``.upload`` (the copies to the
    device), ``.launch``, ``.download`` (the wait and the mask's copy
    back), ``.decode``, ``.install``, ``accord.waves.encode``,
    ``.upload``, ``.launch``, ``.download``, ``accord.recovery`` and
    ``accord.range``; the transitions of ``local/commands.py`` open
    ``accord.op.preaccept``, ``.accept``, ``.commit``, ``.apply``,
    ``.deps`` (building the deps), ``.waiting_on`` and ``.execute``, and
    ``local/store.py`` ``accord.op.index`` (the per-key index walk).  To
    see them in Nsight, ``set_tracer(torch.cuda.nvtx.range)``; in
    ``torch.profiler``'s trace, ``set_tracer(torch.autograd.profiler.
    record_function)`` (or the cheaper
    ``torch._C._profiler._RecordFunctionFast``) while it records;
    ``set_tracer(None)`` turns them off.  The device store also counts
    ``accord_device_copy_bytes_total{dir=h2d|d2h}``,
    ``accord_device_encoded_entries_total``,
    ``accord_device_served_deps_total`` and the
    ``accord_device_wave_depth`` histogram;
  * `cpuprof` — the protocol-tier CPU attribution profiler (sampled
    per-dispatch decode/apply/cfk/reply-encode waterfall, labeled by
    verb, `ACCORD_CPU_PROFILE=N`, off by default) and the always-on
    event-loop health gauges (`LoopHealth`) the wall-clock hosts wire;
  * `node_obs.NodeObs` — the per-Node facade the engine instruments
    against (one registry + one span store + one flight ring per node);
  * `httpd` — the Prometheus-style text endpoint (`ACCORD_METRICS_PORT`)
    plus the live `/flight?txn=` forensics view;
  * `report` — cross-node snapshot merging and the human summary the
    bench and burn harnesses record.

HARD CONSTRAINT: nothing in this package may import jax (directly or
transitively) — the registry lives on the host path only, never inside
jitted code.  tests/test_obs_budget.py enforces this plus a <5% overhead
bound on the scalar hot loop.
"""

from accord_tpu_torch.obs.cpuprof import (CpuProfiler, LoopHealth,
                                    cpu_profiler_from_env,
                                    merge_cpu_exports)
from accord_tpu_torch.obs.flight import (EVENT_KINDS, FlightRecorder,
                                   first_divergence, format_timeline,
                                   stitch_flight, trace_ids_in_text)
from accord_tpu_torch.obs.node_obs import NodeObs
from accord_tpu_torch.obs.profiler import (Profiler, profiler_from_env,
                                           set_tracer, span)
from accord_tpu_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                     parse_labels)
from accord_tpu_torch.obs.spans import (SpanStore, find_trace_ids, stitch,
                                  trace_key)
from accord_tpu_torch.obs.views import CounterDict, MetricView, bind_metric_views

__all__ = [
    "Counter", "CounterDict", "CpuProfiler", "EVENT_KINDS",
    "FlightRecorder", "Gauge", "Histogram", "LoopHealth", "MetricView",
    "NodeObs", "Profiler", "Registry", "SpanStore", "bind_metric_views",
    "cpu_profiler_from_env", "find_trace_ids", "first_divergence",
    "format_timeline", "merge_cpu_exports", "parse_labels",
    "profiler_from_env", "set_tracer", "span", "stitch", "stitch_flight",
    "trace_ids_in_text", "trace_key",
]
