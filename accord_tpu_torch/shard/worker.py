"""The shard worker process: one CommandStore slice on its own core.

Spawned by shard/supervisor.py as `python -m accord_tpu_torch.shard.worker`,
speaking length-prefixed wire frames (shard/pipe.py) on stdin/stdout.
Holds a FULL Node under the parent's node id — coordination started inside
a worker store (recovery, progress-log escalation, bootstrap fetch) runs
the ordinary Node.send machinery — but with three worker-mode twists:

  * SlicedCommandStores: the node's owned ranges are cut down to this
    worker's EvenSplit slice, recomputed the same way on every epoch, so
    the worker and the parent's router always agree on who owns what
  * PipeSink: every outbound request becomes a ShardSend the parent
    forwards through its OWN transport (self-addressed sends loop back
    through the parent's shard routing — cross-shard coordination costs
    one extra pipe hop, not a special case); replies come back as
    ShardDeliver frames
  * HLC stripe: Node.set_hlc_stripe confines minted HLCs to this worker's
    congruence class, so N processes minting under one node id can never
    collide without any cross-process clock coordination

Durability is journal-where-processed: the worker appends every
side-effecting TxnRequest to its OWN WAL band (<journal>/node-<id>/
shard-<k>) before executing it, with group commit forced OFF — a
ShardReply must never precede its record's fsync, because the parent acks
clients off worker replies.  On respawn the band replays before ShardHello
and the supervisor re-ships whatever was pending, so a SIGKILL'd worker
loses zero acknowledged work.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time

from accord_tpu_torch.api.spi import CallbackSink
from accord_tpu_torch.local.store import CommandStores, EmptyFanout, EvenSplit
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.shard import frames
from accord_tpu_torch.shard.pipe import read_frame, write_frame


class SlicedCommandStores(CommandStores):
    """CommandStores confined to one EvenSplit slice: the worker holds a
    single CommandStore whose id IS the shard index (census/flight labels
    line up node-wide), ranged at slice `shard` of the same N-way split
    the parent's router computes — both sides derive ownership from the
    node's owned ranges alone, so no range list ever crosses the pipe."""

    def __init__(self, node, shard: int, n_shards: int, store_factory=None):
        super().__init__(node, num_shards=1, store_factory=store_factory)
        self.shard = shard
        self.n_slices = n_shards
        self._slice_splitter = EvenSplit(n_shards)

    def _slice(self, ranges: Ranges) -> Ranges:
        return self._slice_splitter.split(ranges)[self.shard]

    def initialize(self, ranges: Ranges) -> None:
        sl = self._slice(ranges)
        self.stores = [self.store_factory(self.shard, self.node, sl)]

    def update_topology(self, ranges: Ranges) -> Ranges:
        sl = self._slice(ranges)
        if not self.stores:
            self.initialize(ranges)
            return sl
        store = self.stores[0]
        added = sl.subtract(store.ranges)
        store.update_ranges(sl, unsafe=added)
        return added

    def owned(self) -> Ranges:
        return self.stores[0].ranges if self.stores else Ranges.EMPTY


class PipeSink(CallbackSink):
    """MessageSink marshalling every outbound request to the parent as a
    ShardSend frame.  The CallbackSink msg-id space (`wmsg` on the wire)
    is this worker's own; the parent maps it to ITS transport callback and
    routes the reply back as ShardDeliver."""

    def __init__(self, host: "WorkerHost"):
        super().__init__()
        self.host = host

    def send(self, to: int, request) -> None:
        if self._capture(to, None, request):
            return
        self.host.out(frames.ShardSend(None, to, request))

    def send_with_callback(self, to: int, request, callback,
                           executor=None) -> None:
        wmsg = self._register(callback)
        if self._capture(to, wmsg, request):
            return
        self.host.out(frames.ShardSend(wmsg, to, request))

    def _send_prepared(self, to: int, reply_context, request) -> None:
        self.host.out(frames.ShardSend(reply_context, to, request))

    def reply(self, to: int, reply_context, reply) -> None:
        if reply_context is None:
            return
        # requests reach worker stores only through ShardSubmit (whose
        # reply path is the consume callback) — a transport reply context
        # inside a worker means a routing bug, not a silent drop
        raise RuntimeError(
            f"worker reply without a pipe path: to={to} {reply!r}")


class WorkerHost:
    """The worker's event loop: maelstrom-idiom single-threaded core — a
    reader thread only enqueues decoded frames; the node is touched
    exclusively on the loop thread.  Writes to the parent are blocking
    under a mutex (shard/pipe.py's deadlock-freedom contract: the
    supervisor gives this pipe a dedicated always-draining reader)."""

    def __init__(self):
        from accord_tpu_torch.host.rt import RealTimeScheduler
        self.scheduler = RealTimeScheduler()
        self.sink = PipeSink(self)
        self.node = None
        self.shard = -1
        self.n_shards = 0
        self.generation = 0
        self.running = True
        self._inq: "queue.Queue" = queue.Queue()
        self._out_lock = threading.Lock()
        self._stdout = sys.stdout.buffer

    # ------------------------------------------------------------- egress --
    def out(self, frame) -> None:
        write_frame(self._stdout, self._out_lock, frame)

    # -------------------------------------------------------------- build --
    def _apply_init(self, init: "frames.ShardInit") -> None:
        from accord_tpu_torch.host.maelstrom import HostAgent
        from accord_tpu_torch.host.tcp import _env_store_factory
        from accord_tpu_torch.impl.list_store import ListStore
        from accord_tpu_torch.journal import attach_journal_from_env
        from accord_tpu_torch.local.node import Node
        from accord_tpu_torch.utils.random_source import RandomSource

        self.shard = init.shard
        self.n_shards = init.n_shards
        self.generation = init.generation
        agent = HostAgent()
        self.scheduler.on_error = agent.on_uncaught_exception
        node = Node(init.node_id, self.sink, agent, self.scheduler,
                    ListStore(init.node_id),
                    # distinct stream per (node, shard): same-id workers
                    # must not mirror each other's jitter/backoff draws
                    RandomSource(init.node_id * 8191 + init.shard + 1),
                    num_shards=1, store_factory=_env_store_factory(),
                    now_us=lambda: time.time_ns() // 1000)
        node.command_stores = SlicedCommandStores(
            node, init.shard, init.n_shards,
            store_factory=_env_store_factory())
        node.set_hlc_stripe(init.stripe, init.mod)
        self.node = node
        for install in init.installs:
            self._apply_install(install)
        # journal-where-processed: this worker's own WAL band, group commit
        # forced OFF — the parent acks clients off ShardReply, so a reply
        # must never precede its record's fsync (perf residual: per-append
        # fsync on the worker tier; see ROADMAP)
        os.environ["ACCORD_JOURNAL_FSYNC_US"] = "0"
        attach_journal_from_env(node, band=f"shard-{self.shard}")

    def _apply_install(self, install) -> None:
        """Adopt one EpochInstall directly (no config service in workers:
        the parent's service is the single epoch authority and streams the
        chain over the pipe in order).  start_sync=False — the PARENT owns
        epoch-sync negotiation with peers; the worker only re-ranges its
        slice and marks the added spans safe."""
        if self.node.topology.has_epoch(install.epoch):
            return
        self.node.on_topology_update(install.build_topology(),
                                     start_sync=False)

    # --------------------------------------------------------------- loop --
    def run(self) -> None:
        stdin = sys.stdin.buffer
        init = read_frame(stdin)
        if not isinstance(init, frames.ShardInit):
            print(f"shard worker: bad init frame {init!r}", file=sys.stderr,
                  flush=True)
            return
        self._apply_init(init)
        from accord_tpu_torch.host.tcp import hold_off_full_collections
        hold_off_full_collections()

        def reader():
            while True:
                fr = read_frame(stdin)
                self._inq.put(fr)
                if fr is None:  # EOF: the parent is gone
                    return

        threading.Thread(target=reader, daemon=True,
                         name=f"shard-{self.shard}-reader").start()
        # replay is done (attach_journal_from_env) — tell the supervisor
        # this generation is live so it re-ships pending submits
        self.out(frames.ShardHello(self.shard, os.getpid(), self.generation))
        while self.running:
            self.scheduler.run_due()
            deadline = self.scheduler.next_deadline()
            timeout = (max(0.0, deadline - time.monotonic())
                       if deadline is not None else 0.5)
            try:
                batch = [self._inq.get(timeout=min(timeout, 0.5))]
            except queue.Empty:
                continue
            while len(batch) < 64:
                try:
                    batch.append(self._inq.get_nowait())
                except queue.Empty:
                    break
            for fr in batch:
                if fr is None:
                    self.running = False
                    break
                try:
                    self._dispatch(fr)
                except Exception as e:  # noqa: BLE001
                    print(f"shard worker dispatch error: {e!r} on {fr!r}",
                          file=sys.stderr, flush=True)
            self.scheduler.run_due()

    # ----------------------------------------------------------- dispatch --
    def _dispatch(self, fr) -> None:
        node = self.node
        if isinstance(fr, frames.ShardSubmit):
            self._on_submit(fr)
        elif isinstance(fr, frames.ShardDeliver):
            self.sink.deliver_reply(fr.wmsg, fr.from_id, fr.reply)
        elif isinstance(fr, frames.ShardEpoch):
            self._apply_install(fr.install)
        elif isinstance(fr, frames.ShardStatsReq):
            self._on_stats(fr)
        elif isinstance(fr, frames.ShardAudit):
            self._on_audit(fr)
        elif isinstance(fr, frames.ShardRetire):
            if node is not None and node.journal is not None:
                node.journal.close()
            self.out(frames.ShardRetired(fr.seq, self.shard,
                                         self.generation))
            self.running = False
        else:
            print(f"shard worker: unknown frame {fr!r}", file=sys.stderr,
                  flush=True)

    def _on_submit(self, fr: "frames.ShardSubmit") -> None:
        node = self.node
        request = fr.request
        # mirror Node._process for a routed request: absorb witnessed
        # HLCs, record the hop, journal side effects BEFORE executing
        txn_id = getattr(request, "txn_id", None)
        if txn_id is not None:
            node.on_remote_timestamp(txn_id)
        execute_at = getattr(request, "execute_at", None)
        if execute_at is not None:
            node.on_remote_timestamp(execute_at)
        mt = request.type
        verb = mt.label if mt is not None else type(request).__name__
        node.obs.flight.record("rx", getattr(request, "trace_id", None),
                               (node.id, verb))
        if node.journal is not None and mt is not None \
                and mt.has_side_effects:
            node.journal.record(node.id, request)
        seq = fr.seq

        def consume(value, failure):
            if failure is not None and not isinstance(failure, EmptyFanout):
                self.out(frames.ShardReply(seq, None, repr(failure)))
            else:
                # EmptyFanout folds as a no-op leg: the parent's reduce
                # skips None values (epoch-skew tolerance)
                self.out(frames.ShardReply(seq, value, None))

        try:
            node.command_stores.map_reduce_request(request, consume)
        except BaseException as e:  # noqa: BLE001
            self.out(frames.ShardReply(seq, None, repr(e)))

    def _on_stats(self, fr: "frames.ShardStatsReq") -> None:
        from accord_tpu_torch.host.tcp import process_evidence
        from accord_tpu_torch.local.audit import census_node
        node = self.node
        census = census_node(node)
        paging = census.get("paging")
        self.out(frames.ShardStatsRsp(
            fr.seq, self.shard, os.getpid(), self.generation,
            census=census, paging=paging,
            flight=node.obs.flight.tail(fr.flight_tail),
            metrics={"node": node.id, "shard": self.shard,
                     "metrics": node.obs.registry.snapshot(),
                     "process": process_evidence(node)}))

    def _on_audit(self, fr: "frames.ShardAudit") -> None:
        from accord_tpu_torch.local import audit as A
        from accord_tpu_torch.messages.audit import AuditEntriesOk
        node = self.node
        owned = node.command_stores.owned()
        if fr.kind == "digest":
            reply = A.digest_reply(node, fr.ranges, fr.lo, fr.hi,
                                   owned=owned)
        else:
            entries = A.collect_entries(node, fr.ranges, fr.lo, fr.hi,
                                        owned=owned)
            limit = fr.limit or len(entries)
            reply = AuditEntriesOk(tuple(entries[:limit]),
                                   truncated=len(entries) > limit)
        self.out(frames.ShardAuditRsp(fr.seq, reply))


def main() -> None:
    # argv carries only a ps-visible identity tag; real configuration
    # arrives as the ShardInit frame (wire objects cannot ride argv)
    _tag = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    WorkerHost().run()
    # the reader daemon thread is parked in a blocking stdin read;
    # interpreter finalization would trip over its buffer lock — hard
    # exit instead (the WAL band is already closed/fsynced on retire)
    sys.stdout.buffer.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
