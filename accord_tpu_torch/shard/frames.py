"""Worker-pipe frames for the per-shard runtime (shard/).

Every class here crosses the supervisor<->worker pipe through the
host/wire.py structural codec (the module is listed in wire._MODULES), so
frames ride the same binary framing — native tier when available — as
peer-to-peer traffic, and tests/test_wire_roundtrip.py synthesizers pin
their round trip on both codec tiers.

Parent -> worker:  ShardInit, ShardEpoch, ShardSubmit, ShardDeliver,
                   ShardStatsReq, ShardAudit, ShardRetire
Worker -> parent:  ShardHello, ShardReply, ShardSend, ShardStatsRsp,
                   ShardAuditRsp, ShardRetired

Two id spaces, one per direction: `seq` numbers parent-initiated RPCs
(submit/stats/audit/retire), `wmsg` numbers worker-initiated sends whose
replies the parent marshals back (the worker-side CallbackSink msg id).
Keep this module import-light: wire.py imports it while building the
registry, so it must not import wire (or anything host-tier) itself.
"""

from __future__ import annotations

from typing import Optional, Tuple


class ShardInit:
    """First frame on a fresh pipe: identity + slice arithmetic + the
    EpochInstall chain so far, so a (re)spawned worker rebuilds topology
    BEFORE replaying its WAL band.  `mod` is the HLC congruence modulus
    (workers + parent), `stripe` this worker's class (parent keeps 0)."""

    def __init__(self, node_id: int, shard: int, n_shards: int,
                 stripe: int, mod: int, generation: int,
                 installs: Tuple = ()):
        self.node_id = node_id
        self.shard = shard
        self.n_shards = n_shards
        self.stripe = stripe
        self.mod = mod
        self.generation = generation
        self.installs = tuple(installs)

    def __repr__(self):
        return (f"ShardInit(node={self.node_id} shard={self.shard}"
                f"/{self.n_shards} gen={self.generation})")


class ShardHello:
    """Worker is live (journal band replayed, stores initialized): the
    supervisor re-ships pending submits only after this lands."""

    def __init__(self, shard: int, pid: int, generation: int):
        self.shard = shard
        self.pid = pid
        self.generation = generation

    def __repr__(self):
        return f"ShardHello(shard={self.shard} pid={self.pid})"


class ShardEpoch:
    """One topology epoch for the worker's config service; `install` is the
    ordinary wire-registered EpochInstall spec (messages/admin.py)."""

    def __init__(self, install):
        self.install = install

    def __repr__(self):
        return f"ShardEpoch({self.install!r})"


class ShardSubmit:
    """Shard-affine fan-out: run `request` against the worker's stores
    (CommandStores.map_reduce_request) and answer with ShardReply(seq)."""

    def __init__(self, seq: int, request):
        self.seq = seq
        self.request = request

    def __repr__(self):
        return f"ShardSubmit(#{self.seq} {type(self.request).__name__})"


class ShardReply:
    """The worker-local reduce of one ShardSubmit: `value` is the shard's
    Reply (None for consume-only dispatches), `failure` a repr string."""

    def __init__(self, seq: int, value=None, failure: Optional[str] = None):
        self.seq = seq
        self.value = value
        self.failure = failure

    def __repr__(self):
        return (f"ShardReply(#{self.seq} "
                + (f"failure={self.failure!r}" if self.failure
                   else type(self.value).__name__) + ")")


class ShardSend:
    """Worker-initiated outbound request (recovery, progress log, audit
    fan-outs started inside a worker store): the parent forwards it through
    its own transport — self-addressed sends loop back through the parent's
    shard routing, so cross-shard coordination stays correct.  `wmsg` is
    the worker's callback id (None = fire-and-forget)."""

    def __init__(self, wmsg: Optional[int], to: int, request):
        self.wmsg = wmsg
        self.to = to
        self.request = request

    def __repr__(self):
        return (f"ShardSend(w#{self.wmsg} to=n{self.to} "
                f"{type(self.request).__name__})")


class ShardDeliver:
    """Reply delivery for a ShardSend: parent -> owning worker, which hands
    it to its CallbackSink under the original worker msg id."""

    def __init__(self, wmsg: int, from_id: int, reply):
        self.wmsg = wmsg
        self.from_id = from_id
        self.reply = reply

    def __repr__(self):
        return f"ShardDeliver(w#{self.wmsg} from=n{self.from_id})"


class ShardStatsReq:
    """Pull one obs snapshot from the worker (census, pager stats, flight
    tail) for the parent's merged node view."""

    def __init__(self, seq: int, flight_tail: int = 256):
        self.seq = seq
        self.flight_tail = flight_tail

    def __repr__(self):
        return f"ShardStatsReq(#{self.seq})"


class ShardStatsRsp:
    """One worker obs snapshot.  `census` is local/audit.census_node output
    (JSON-safe), `paging` the summed Pager.stats(), `flight` the ring tail
    as (at_us, seq, kind, trace_id, data) tuples, `metrics` the worker's
    metrics registry snapshot and its process's device evidence
    (host/tcp.process_evidence): its stores' device counters and kernel
    laps reach the parent's metrics reply only this way."""

    def __init__(self, seq: int, shard: int, pid: int, generation: int,
                 census=None, paging=None, flight: Tuple = (),
                 metrics=None):
        self.seq = seq
        self.shard = shard
        self.pid = pid
        self.generation = generation
        self.census = census
        self.paging = paging
        self.flight = tuple(tuple(e) for e in flight)
        self.metrics = metrics

    def __repr__(self):
        return f"ShardStatsRsp(#{self.seq} shard={self.shard})"


class ShardAudit:
    """One audit walk over the worker's stores: kind 'digest' answers with
    an AuditDigestOk, 'entries' with an AuditEntriesOk (messages/audit.py).
    The worker applies the min-token ownership filter so a cross-shard
    transaction contributes exactly one leaf node-wide."""

    def __init__(self, seq: int, kind: str, ranges, lo, hi,
                 limit: int = 0):
        self.seq = seq
        self.kind = kind
        self.ranges = ranges
        self.lo = lo
        self.hi = hi
        self.limit = limit

    def __repr__(self):
        return f"ShardAudit(#{self.seq} {self.kind} {self.ranges!r})"


class ShardAuditRsp:
    """The worker's audit answer; `reply` is the ordinary wire-registered
    AuditDigestOk / AuditEntriesOk the parent merges across workers."""

    def __init__(self, seq: int, reply):
        self.seq = seq
        self.reply = reply

    def __repr__(self):
        return f"ShardAuditRsp(#{self.seq} {self.reply!r})"


class ShardRetire:
    """Drain and exit: the worker flushes its WAL band, answers
    ShardRetired, and terminates."""

    def __init__(self, seq: int):
        self.seq = seq

    def __repr__(self):
        return f"ShardRetire(#{self.seq})"


class ShardRetired:
    def __init__(self, seq: int, shard: int, generation: int):
        self.seq = seq
        self.shard = shard
        self.generation = generation

    def __repr__(self):
        return f"ShardRetired(#{self.seq} shard={self.shard})"
