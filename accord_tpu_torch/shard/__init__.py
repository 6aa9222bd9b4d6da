"""Per-shard worker runtime: a true multi-core multi-store node.

The reference's core intra-node parallelism construct is range sharding:
`CommandStores` splits the owned keyspace over N single-threaded
`CommandStore` shards behind a `mapReduceConsume` fan-out that crosses a
per-store thread boundary (CommandStores.java:78,563).  Our logical shard
manager (local/store.py) has always existed, but every shard ran on one
event loop in one process — the GIL makes in-process threads a dead end,
so this package gives each shard its own PROCESS with its own event loop:

  * supervisor.py — ShardSupervisor spawns/monitors/respawns N workers and
    WorkerCommandStores routes the same map_reduce_request fan-out over
    framed duplex pipes (host/wire.py codec, native tier when available);
    store-affine callbacks are marshalled back to the owning worker
  * worker.py — the worker process: a full Node confined to its shard's
    EvenSplit slice (SlicedCommandStores), a pipe-backed sink, an HLC
    congruence stripe so same-id processes never mint colliding
    timestamps, and its own WAL band (journal-where-processed)
  * frames.py — the wire-registered pipe frames

In-loop mode (`ACCORD_SHARDS` unset, 0 or 1) is pinned bit-identical to
the pre-worker dispatch: hosts only swap in WorkerCommandStores when the
knob asks for 2+ workers.
"""

from __future__ import annotations

import os


def workers_from_env() -> int:
    """Number of shard worker processes the host should run, or 0 for the
    in-loop tier.  ACCORD_SHARDS=N with N >= 2 enables the worker runtime;
    unset/0/1 keeps every store on the host's own loop."""
    raw = os.environ.get("ACCORD_SHARDS", "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        return 0
    return n if n >= 2 else 0
