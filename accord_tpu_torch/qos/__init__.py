"""Host-boundary QoS admission tier (graceful overload, multi-tenant).

Past saturation, drop-tail mechanisms (pipeline `Rejected`, per-peer
in-flight bounds, drain shed) keep a node alive but are blind to WHO is
overloading it and WHAT the traffic is worth.  This package adds the
missing outer ring at the pluggable-host boundary (the reference protocol
leaves admission to `accord.api.*` hosts):

  * `admission.QosTier` — per-tenant token buckets with burst credit plus
    priority classes (`high` / `normal` / `best_effort`) carried on submit
    frames; admission runs BEFORE journal append and coordination state
    are spent, and every rejection is a typed retriable `QosRejected` nack
    with a `retry_after_us` hint;
  * `controller.PressureController` — adaptive shed threshold derived
    from the loop-health lag/saturation gauges (plus WAL group-commit
    queue depth when journaling is on), so shedding tracks the real
    bottleneck rather than a static queue depth.

Hosts enable it with `ACCORD_QOS=1` (host/tcp.py, host/maelstrom.py);
the deterministic burn drives it via `SimCluster(qos=True)` /
`python -m accord_tpu_torch.sim.burn --qos`.  Default off: with `ACCORD_QOS`
unset (or `0`) no tier is constructed and the submit path is byte-for-byte
today's, pinned by a differential burn in tests/test_qos.py.
"""

from __future__ import annotations

import os
from typing import Optional

from accord_tpu_torch.qos.admission import (PRIORITIES, QosConfig, QosRejected,
                                      QosTier, TokenBucket)
from accord_tpu_torch.qos.controller import PressureController


def qos_enabled() -> bool:
    """The host-side gate: ACCORD_QOS=1 (default off)."""
    return os.environ.get("ACCORD_QOS", "") == "1"


def qos_tier_from_env(registry, flight, clock_us, loop_health=None,
                      wal=None, sources=(),
                      n_shards: int = 0) -> Optional[QosTier]:
    """Construct one node's QoS tier from the environment, or None when the
    gate is off (hosts then keep today's submit path untouched).
    `n_shards >= 2` (the worker runtime) arms the per-(tenant, shard)
    sub-buckets."""
    if not qos_enabled():
        return None
    config = QosConfig.from_env()
    controller = PressureController(config, clock_us,
                                    loop_health=loop_health, wal=wal,
                                    sources=sources)
    return QosTier(config, registry, flight, clock_us, controller=controller,
                   n_shards=n_shards)
