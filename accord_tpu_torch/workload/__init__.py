"""Open-loop SLO workload harness.

Closed-loop clients (a fixed in-flight window, submit-on-ack) suffer
coordinated omission: when a coordinator stalls, the client stops
submitting, so the stall never appears in the recorded latencies — the
measurement understates tail latency exactly when the slow path, recovery,
or an fsync stall fires.  This package generates load OPEN-LOOP instead:
arrival times are fixed by a deterministic-seeded schedule (`arrival.py`),
independent of completions, and every latency is measured from the op's
INTENDED start — omitted time is charged, not hidden.

`profiles.py` names the workload shapes (zipfian hot-key skew, range-stab
mix, TPC-C-style neworder, ephemeral-read-heavy); `openloop.py` drives them
end-to-end through the pipeline host — the deterministic sim cluster
(virtual time) or the multi-process TCP cluster (wall time) — and joins the
intended-start ledger against the trace spans for per-phase latency
attribution.  The SLO report itself (exact-sample p50/p99/p99.9 overall,
per phase, open- vs closed-loop) is built by `obs/report.slo_report`.
"""

from accord_tpu_torch.workload.arrival import make_offsets_us
from accord_tpu_torch.workload.openloop import (run_open_loop_sim,
                                          run_open_loop_tcp,
                                          run_reshard_tcp)
from accord_tpu_torch.workload.profiles import PROFILES, build_txn, make_profile
from accord_tpu_torch.workload.worlds import *  # noqa: F401,F403

__all__ = ["PROFILES", "build_txn", "make_profile", "make_offsets_us",
           "run_open_loop_sim", "run_open_loop_tcp", "run_reshard_tcp"]
