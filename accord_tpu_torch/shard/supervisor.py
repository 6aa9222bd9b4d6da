"""Parent-side shard runtime: worker lifecycle + shard-affine routing.

ShardSupervisor owns the worker processes (spawn, monitor, respawn on
crash, retire on close) and the framed duplex pipes; WorkerCommandStores
is the CommandStores the parent node runs with — same fan-out API the
in-loop tier exposes, but `map_reduce_request` ships each shard's leg over
its worker pipe and reduces the ShardReplies in shard order, exactly like
the reference's mapReduceConsume across store threads.

Crash contract (zero lost acks): a submit stays in `pending` until its
ShardReply arrives; a SIGKILL'd worker is respawned with a bumped
generation, replays its own WAL band, answers ShardHello, and only then
gets the still-pending submits re-shipped.  Replay and re-execution are
idempotent for the same reason journal replay is — Accord message
application is state-merge.

Threading: every node-facing structure is touched ONLY on the host loop
thread; the per-worker reader threads decode frames and marshal them in
via host.call_soon, and pipe writes are blocking under a per-worker lock
(shard/pipe.py's contract: the worker's reader thread always drains).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional

from accord_tpu_torch.local.store import CommandStores, EmptyFanout
from accord_tpu_torch.messages.base import FunctionCallback
from accord_tpu_torch.primitives.keys import Ranges, _SortedKeyList
from accord_tpu_torch.shard import frames
from accord_tpu_torch.shard.pipe import read_frame, write_frame

# parent-side TTL for forwarding a worker-initiated RPC's reply: the
# WORKER's own _SafeCallback timeout governs protocol behavior — this
# bound only stops a lost reply from pinning parent callback state
_FORWARD_TTL_S = 60.0


class _Worker:
    """One worker process and its pipe state."""

    __slots__ = ("shard", "proc", "generation", "live", "retired",
                 "write_lock", "pid")

    def __init__(self, shard: int, proc, generation: int):
        self.shard = shard
        self.proc = proc
        self.generation = generation
        self.live = False      # ShardHello received for this generation
        self.retired = False   # planned exit: do not respawn
        self.write_lock = threading.Lock()
        self.pid = proc.pid


class ShardSupervisor:
    """Spawns and supervises the N shard workers for one host node.

    `host` provides call_soon (cross-thread marshal onto the node's loop)
    and the node is used for its scheduler, flight ring, sink, and config
    service (the EpochInstall ledger workers are seeded from)."""

    def __init__(self, host, node, n_workers: int):
        self.host = host
        self.node = node
        self.n_workers = n_workers
        self.flight = node.obs.flight
        self.workers: List[Optional[_Worker]] = [None] * n_workers
        # seq -> (shard, request, on_reply(value, failure)) for submits;
        # control RPCs (stats/audit/retire) track their own continuations
        self.pending: Dict[int, tuple] = {}
        self._ctl: Dict[int, Callable] = {}
        self._seq = 0
        self._spawned = False
        self._closing = False
        self.stats_cache: Dict[int, frames.ShardStatsRsp] = {}
        self._stats_timer = None
        try:
            self._cpus = sorted(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            self._cpus = []

    # ------------------------------------------------------------ spawning --
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _installs(self) -> tuple:
        """The EpochInstall chain a fresh worker needs, oldest first."""
        service = self.node.config_service
        if service is not None:
            out = []
            for epoch in range(1, self.node.topology.epoch + 1):
                spec = service.spec_for(epoch)
                if spec is not None:
                    out.append(spec)
            if out:
                return tuple(out)
        from accord_tpu_torch.messages.admin import EpochInstall
        topo = self.node.topology.current()
        return (EpochInstall.from_topology(topo),) if topo.shards else ()

    def spawn_all(self) -> None:
        if self._spawned:
            return
        self._spawned = True
        for shard in range(self.n_workers):
            self._spawn(shard, generation=1)
        if self._stats_timer is None:
            self._stats_timer = self.node.scheduler.recurring(
                2.0, self._poll_stats)

    def _spawn(self, shard: int, generation: int) -> None:
        env = dict(os.environ)
        # the worker is a plain Node, not a host: no metrics port (would
        # collide), no auditor (the parent audits THROUGH the workers), no
        # QoS/pipeline tiers (admission happens before routing), and no
        # nested worker runtime
        for k in ("ACCORD_SHARDS", "ACCORD_METRICS_PORT", "ACCORD_QOS",
                  "ACCORD_PIPELINE", "ACCORD_TCP_PROFILE"):
            env.pop(k, None)
        env["ACCORD_AUDIT_S"] = "0"
        proc = subprocess.Popen(
            [sys.executable, "-m", "accord_tpu_torch.shard.worker",
             f'{{"node": {self.node.id}, "shard": {shard}}}'],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        w = _Worker(shard, proc, generation)
        self.workers[shard] = w
        if len(self._cpus) > self.n_workers:
            # enough cores that parent and workers need not share: pin
            # worker k off the parent's first core (best effort)
            try:
                os.sched_setaffinity(
                    proc.pid,
                    {self._cpus[1 + shard % (len(self._cpus) - 1)]})
            except OSError:
                pass
        self.flight.record("shard_spawn", None,
                           (shard, proc.pid, generation))
        write_frame(proc.stdin, w.write_lock, frames.ShardInit(
            self.node.id, shard, self.n_workers,
            stripe=shard + 1, mod=self.n_workers + 1,
            generation=generation, installs=self._installs()))
        threading.Thread(target=self._reader, args=(w,), daemon=True,
                         name=f"shard-{shard}-reader").start()

    def _reader(self, w: _Worker) -> None:
        while True:
            try:
                fr = read_frame(w.proc.stdout)
            except Exception:  # noqa: BLE001 — torn pipe == EOF
                fr = None
            if fr is None:
                self.host.call_soon(lambda: self._on_exit(w))
                return
            self.host.call_soon(lambda f=fr: self._on_frame(w, f))

    # ----------------------------------------------------- lifecycle (loop) --
    def _on_exit(self, w: _Worker) -> None:
        if self.workers[w.shard] is not w:
            return  # already replaced
        w.live = False
        try:
            w.proc.wait(timeout=1.0)
        except Exception:  # noqa: BLE001
            w.proc.kill()
        if self._closing or w.retired:
            return
        # crash: fail in-flight control RPCs (audit rounds turn
        # inconclusive), keep submits pending, respawn with a new
        # generation — ShardHello triggers the re-ship
        for seq in [s for s, cb in list(self._ctl.items())
                    if getattr(cb, "shard", None) == w.shard]:
            cb = self._ctl.pop(seq)
            cb(None)
        self._spawn(w.shard, w.generation + 1)

    def _on_frame(self, w: _Worker, fr) -> None:
        if self.workers[w.shard] is not w:
            return  # stale generation
        if isinstance(fr, frames.ShardReply):
            ent = self.pending.pop(fr.seq, None)
            if ent is not None:
                _shard, request, on_reply = ent
                failure = (RuntimeError(fr.failure)
                           if fr.failure is not None else None)
                on_reply(fr.value, failure)
        elif isinstance(fr, frames.ShardSend):
            self._forward(w, fr)
        elif isinstance(fr, frames.ShardHello):
            w.live = True
            w.pid = fr.pid
            for seq, ent in list(self.pending.items()):
                if ent[0] == w.shard:
                    self._write(w, frames.ShardSubmit(seq, ent[1]))
        elif isinstance(fr, (frames.ShardStatsRsp, frames.ShardAuditRsp,
                             frames.ShardRetired)):
            cb = self._ctl.pop(fr.seq, None)
            if cb is not None:
                cb(fr)
        else:
            self.node.agent.on_handled_exception(
                RuntimeError(f"unknown worker frame {fr!r}"))

    def _forward(self, w: _Worker, fr: frames.ShardSend) -> None:
        """Forward a worker-initiated send through the parent's OWN
        transport.  Self-addressed sends land back in the parent's local
        queue and re-enter WorkerCommandStores routing — cross-shard
        coordination needs no special case."""
        if fr.wmsg is None:
            self.node.sink.send(fr.to, fr.request)
            return
        shard, wmsg = w.shard, fr.wmsg

        def ok(from_id, reply):
            cur = self.workers[shard]
            if cur is not None and cur.live:
                self._write(cur, frames.ShardDeliver(wmsg, from_id, reply))

        # failure leg intentionally drops: the WORKER armed its own
        # _SafeCallback timeout when it sent — the parent-side TTL only
        # garbage-collects the forwarding state
        self.node.send(fr.to, fr.request, FunctionCallback(ok),
                       timeout_s=_FORWARD_TTL_S)

    # ------------------------------------------------------------- routing --
    def submit(self, shard: int, request, on_reply) -> None:
        seq = self._next_seq()
        self.pending[seq] = (shard, request, on_reply)
        mt = request.type
        verb = mt.label if mt is not None else type(request).__name__
        self.flight.record("shard_submit",
                           getattr(request, "trace_id", None), (shard, verb))
        w = self.workers[shard]
        if w is not None and w.live:
            self._write(w, frames.ShardSubmit(seq, request))
        # not live: ShardHello re-ships everything pending for the shard

    def _write(self, w: _Worker, frame) -> None:
        try:
            write_frame(w.proc.stdin, w.write_lock, frame)
        except (OSError, ValueError):
            pass  # torn pipe: the reader's EOF path owns recovery

    def control(self, shard: int, frame, done: Callable) -> bool:
        """Send one control RPC (stats/audit/retire); done(rsp|None)."""
        w = self.workers[shard]
        if w is None or not w.live:
            return False
        done.shard = shard  # let _on_exit fail RPCs of a dead worker
        self._ctl[frame.seq] = done
        self._write(w, frame)
        return True

    # --------------------------------------------------------------- stats --
    def _poll_stats(self) -> None:
        for shard in range(self.n_workers):
            seq = self._next_seq()

            def done(rsp, shard=shard):
                if rsp is not None:
                    self.stats_cache[shard] = rsp

            self.control(shard, frames.ShardStatsReq(seq), done)

    # --------------------------------------------------------------- audit --
    def audit_fan(self, kind: str, ranges, lo, hi, limit: int,
                  done: Callable) -> None:
        """Fan one audit walk over every worker and merge: XOR digests,
        sum counts, max lo floors / min hi floors (each worker already
        applied the min-token ownership filter, so the union is exactly
        one leaf per transaction node-wide).  done(reply|None)."""
        replies: Dict[int, object] = {}
        remaining = [0]
        failed = [False]

        def mk(shard):
            def on_rsp(rsp):
                remaining[0] -= 1
                if rsp is None:
                    failed[0] = True
                else:
                    replies[shard] = rsp.reply
                if remaining[0] == 0:
                    done(None) if failed[0] else done(
                        self._merge_audit(kind, replies))
            return on_rsp

        for shard in range(self.n_workers):
            seq = self._next_seq()
            cb = mk(shard)
            if self.control(shard,
                            frames.ShardAudit(seq, kind, ranges, lo, hi,
                                              limit), cb):
                remaining[0] += 1
            else:
                failed[0] = True
        if remaining[0] == 0:
            done(None)

    @staticmethod
    def _merge_audit(kind: str, replies: Dict[int, object]):
        from accord_tpu_torch.messages.audit import AuditDigestOk, AuditEntriesOk
        vals = [replies[s] for s in sorted(replies)]
        if kind == "digest":
            acc = 0
            count = 0
            for r in vals:
                acc ^= int(r.digest, 16)
                count += r.count
            lo = max(r.lo_floor for r in vals)
            hi = min(r.hi_floor for r in vals)
            return AuditDigestOk(f"{acc:032x}", count, lo, hi)
        entries = sorted((e for r in vals for e in r.entries),
                         key=lambda e: e[0])
        return AuditEntriesOk(tuple(entries),
                              truncated=any(r.truncated for r in vals))

    # --------------------------------------------------------------- close --
    def close(self) -> None:
        self._closing = True
        if self._stats_timer is not None:
            self._stats_timer.cancel()
        for w in self.workers:
            if w is None:
                continue
            w.retired = True
            if w.live:
                self._write(w, frames.ShardRetire(self._next_seq()))
            try:
                w.proc.wait(timeout=2.0)
            except Exception:  # noqa: BLE001
                w.proc.kill()
            self.flight.record("shard_retire", None,
                               (w.shard, w.generation))

    def admin_view(self) -> List[dict]:
        """One row per worker for the host's "shards" admin frame."""
        return [{"shard": w.shard, "pid": w.pid,
                 "generation": w.generation, "live": w.live}
                if w is not None else {"shard": i, "live": False}
                for i, w in enumerate(self.workers)]


class WorkerCommandStores(CommandStores):
    """The parent node's CommandStores under the worker runtime: no local
    stores — the split snapshot routes every fan-out over the pipes."""

    remote = True

    def __init__(self, node, supervisor: ShardSupervisor):
        super().__init__(node, num_shards=supervisor.n_workers)
        self.supervisor = supervisor
        # per-shard cumulative ranges, mirroring each worker store's
        # only-grow update_ranges semantics so routing always reaches the
        # worker that still holds previously-owned state
        self.split: List[Ranges] = [Ranges.EMPTY] * supervisor.n_workers
        self._owned = Ranges.EMPTY

    # -- topology ----------------------------------------------------------
    def initialize(self, ranges: Ranges) -> None:
        self.update_topology(ranges)

    def update_topology(self, ranges: Ranges) -> Ranges:
        added = ranges.subtract(self._owned)
        self._owned = self._owned.union(ranges)
        slices = self._splitter.split(ranges)
        self.split = [old.union(sl)
                      for old, sl in zip(self.split, slices)]
        if not self.supervisor._spawned:
            self.supervisor.spawn_all()
        else:
            # stream the new epoch to every worker; each re-slices the
            # same owned ranges itself (no range list crosses the pipe)
            service = self.node.config_service
            spec = (service.spec_for(self.node.topology.epoch)
                    if service is not None else None)
            if spec is not None:
                for w in self.supervisor.workers:
                    if w is not None and w.live:
                        self.supervisor._write(w, frames.ShardEpoch(spec))
        return added

    # -- store access ------------------------------------------------------
    def all(self) -> List:
        return []

    def intersecting(self, participants) -> List:
        return []

    def _intersecting_shards(self, participants) -> List[int]:
        if participants is None:
            return list(range(self.num_shards))
        out = []
        for i, r in enumerate(self.split):
            if r.is_empty:
                continue
            if isinstance(participants, _SortedKeyList):
                if participants.intersects_ranges(r):
                    out.append(i)
            elif isinstance(participants, Ranges):
                if r.intersects(participants):
                    out.append(i)
            else:
                raise TypeError(type(participants))
        return out

    def shard_of(self, participants) -> int:
        idxs = self._intersecting_shards(participants)
        return idxs[0] if idxs else 0

    # -- fan-out -----------------------------------------------------------
    def map_reduce_request(self, request, consume) -> None:
        idxs = self._intersecting_shards(request.participants())
        if not idxs:
            consume(None, EmptyFanout("no intersecting shard"))
            return
        sup = self.supervisor
        mt = request.type
        verb = mt.label if mt is not None else type(request).__name__
        tid = getattr(request, "trace_id", None)
        vals: List = [None] * len(idxs)
        left = [len(idxs)]
        first_failure: List = [None]

        def mk(j):
            def on_reply(value, failure):
                if failure is not None and first_failure[0] is None:
                    first_failure[0] = failure
                vals[j] = value
                left[0] -= 1
                if left[0]:
                    return
                if first_failure[0] is not None:
                    consume(None, first_failure[0])
                    return
                sup.flight.record("shard_reduce", tid, (len(idxs), verb))
                acc = None
                for v in vals:  # shard order; None = EmptyFanout leg
                    if v is None:
                        continue
                    acc = v if acc is None else request.reduce(acc, v)
                consume(acc, None)
            return on_reply

        for j, shard in enumerate(idxs):
            sup.submit(shard, request, mk(j))

    # -- audit -------------------------------------------------------------
    def audit_local(self, req, done: Callable) -> None:
        """Serve a node-local audit walk by fanning over the workers."""
        kind = "digest" if type(req).__name__ == "AuditDigest" else "entries"
        limit = getattr(req, "limit", 0)
        self.supervisor.audit_fan(kind, req.ranges, req.lo, req.hi, limit,
                                  done)

    def audit_request(self, req, from_id: int, reply_context) -> None:
        """Serve a peer's AUDIT_* request (messages/audit.py remote
        branch); a dead worker leaves the peer to its RPC timeout, which
        audits as missing -> inconclusive."""

        def done(reply):
            if reply is not None:
                self.node.reply(from_id, reply_context, reply)

        self.audit_local(req, done)

    def merged_census(self) -> Optional[dict]:
        """Fold the cached per-worker censuses into one node view (the
        stats poll refreshes the cache every ~2s)."""
        rsps = [self.supervisor.stats_cache.get(s)
                for s in range(self.num_shards)]
        rsps = [r for r in rsps if r is not None]
        if not rsps:
            return None
        from accord_tpu_torch.local.audit import merge_censuses
        return merge_censuses([r.census for r in rsps],
                              node_id=self.node.id,
                              at_us=self.node.obs.now_us())
