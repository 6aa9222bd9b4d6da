"""Maelstrom protocol host: one Accord node as a stdin/stdout JSON process.

Reference: accord-maelstrom/Main.java:145 — reads newline-delimited JSON
envelopes {"src","dest","body"} from stdin, writes them to stdout. Supports:
  * init            — builds the Node; topology derives deterministically
                      from the init node list so every process agrees
  * txn             — Maelstrom txn-list-append workload: micro-ops
                      [["r", k, null], ["append", k, v], ...] become one
                      Accord transaction over the list-register data plane
  * accord          — inter-node Accord traffic, wire.py-encoded; request
                      callbacks ride msg_id/in_reply_to like the reference's
                      Packet/MaelstromReplyContext

Run: python -m accord_tpu_torch.host.maelstrom
"""

from __future__ import annotations

import json
import sys
import time
import zlib
from typing import Dict, Optional

from accord_tpu_torch.api.spi import Agent, CallbackSink
from accord_tpu_torch.host.rt import RealTimeScheduler
from accord_tpu_torch.host.wire import decode_message, encode_message
from accord_tpu_torch.impl.list_store import (ListQuery, ListRead, ListResult,
                                        ListStore, ListUpdate)
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.keys import Key, Keys, Range, Ranges
from accord_tpu_torch.primitives.timestamp import TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.random_source import RandomSource

TOKEN_SPAN = 1 << 31


def node_num(name: str) -> int:
    """'n3' -> 3; anything else hashes stably."""
    if name.startswith("n") and name[1:].isdigit():
        return int(name[1:])
    return (zlib.crc32(name.encode()) % 1_000_000) + 1_000


def build_topology(ids, rf: int, n_shards: int) -> Topology:
    """Static epoch-1 topology over the token span: `n_shards` even ranges,
    replicas rotated over the sorted node ids (shared by every host
    transport so deployments cannot diverge on shard boundaries)."""
    ids = sorted(ids)
    width = TOKEN_SPAN // n_shards
    shards = []
    for i in range(n_shards):
        start = i * width
        end = TOKEN_SPAN if i == n_shards - 1 else (i + 1) * width
        replicas = [ids[(i + j) % len(ids)] for j in range(rf)]
        shards.append(Shard(Range(start, end), replicas))
    return Topology(1, shards)


def key_token(k) -> int:
    if isinstance(k, bool) or not isinstance(k, int):
        return zlib.crc32(str(k).encode()) % TOKEN_SPAN
    return k % TOKEN_SPAN


class HostAgent(Agent):
    def __init__(self):
        # env-tunable RPC timeout, parsed once (constant for the process):
        # a device-store host (ACCORD_TCP_DEVICE_STORE) whose first flush
        # jit-compiles inside the dispatch loop needs rounds to survive
        # multi-second peer stalls
        import os
        try:
            self._rpc_timeout_s = float(
                os.environ.get("ACCORD_HOST_RPC_TIMEOUT_S", "1.0"))
        except ValueError:
            self._rpc_timeout_s = 1.0

    def on_uncaught_exception(self, failure: BaseException) -> None:
        print(f"uncaught: {failure!r}", file=sys.stderr, flush=True)

    def on_handled_exception(self, failure: BaseException) -> None:
        # recovered-from incidents (e.g. the device tier degrading to
        # scalar on a mid-run backend death) must still be operator-visible
        print(f"handled: {failure!r}", file=sys.stderr, flush=True)

    def pre_accept_timeout(self) -> float:
        return self._rpc_timeout_s

    def empty_txn(self, kind: TxnKind, keys_or_ranges) -> Txn:
        return Txn(kind, keys_or_ranges)


class MaelstromSink(CallbackSink):
    """MessageSink writing Maelstrom envelopes (reference Wrapper/Packet).

    A single-slot encode memo (identity-keyed) covers the fan-out pattern:
    Node.send encodes the SAME request object once per recipient — the
    PreAccept/Commit/Apply rounds each pay one structural walk instead of
    rf of them.  Requests are never mutated between their fan-out sends
    (the trace id is stamped before the first), so identity implies an
    identical tree."""

    def __init__(self, host: "MaelstromHost"):
        super().__init__()
        self.host = host
        self._memo_req = None
        self._memo_tree = None

    def _enc(self, request):
        if self._memo_req is request:
            return self._memo_tree
        tree = encode_message(request)
        self._memo_req = request
        self._memo_tree = tree
        return tree

    def send(self, to: int, request: Request) -> None:
        if self._capture(to, None, request):
            return
        self.host.emit_node(to, {"type": "accord",
                                 "payload": self._enc(request)})

    def send_with_callback(self, to: int, request: Request, callback,
                           executor=None) -> None:
        msg_id = self._register(callback)
        if self._capture(to, msg_id, request):
            return
        self.host.emit_node(to, {"type": "accord", "msg_id": msg_id,
                                 "payload": self._enc(request)})

    def _send_prepared(self, to: int, reply_context, request) -> None:
        body = {"type": "accord", "payload": self._enc(request)}
        if reply_context is not None:
            body["msg_id"] = reply_context
        self.host.emit_node(to, body)

    def reply(self, to: int, reply_context, reply: Reply) -> None:
        if reply_context is None:
            return
        self.host.emit_node(to, {"type": "accord",
                                 "in_reply_to": reply_context,
                                 "payload": self._enc(reply)})


class MaelstromHost:
    def __init__(self, stdin=None, stdout=None, rf: Optional[int] = None):
        self.stdin = stdin if stdin is not None else sys.stdin
        self.stdout = stdout if stdout is not None else sys.stdout
        self.rf = rf
        self.node = None
        self.pipeline = None  # built with the node when ACCORD_PIPELINE=1
        self.metrics_server = None  # built with the node (obs/httpd)
        self.auditor = None         # built with the node (local/audit.py)
        self.loop_health = None     # built with the node (obs/cpuprof.py)
        self.config_service = None  # built with the node (admin epoch plane)
        self.node_name = ""
        self.names: Dict[int, str] = {}
        self.scheduler = RealTimeScheduler()
        self.sink = MaelstromSink(self)
        self._msg_seq = 0
        self.running = True
        self._pre_init: list = []
        self.wal = None  # ACCORD_JOURNAL: attached in _build_node
        # stdout is shared by the loop thread and (with a journal in
        # group-commit mode) the WAL flush thread releasing durability-
        # gated replies: envelope writes must not interleave
        import threading
        self._emit_lock = threading.Lock()

    # ------------------------------------------------------------- output --
    def _emit(self, dest: str, body: dict) -> None:
        with self._emit_lock:
            print(json.dumps({"src": self.node_name, "dest": dest,
                              "body": body}),
                  file=self.stdout, flush=True)

    def emit_node(self, to: int, body: dict) -> None:
        self._emit(self.names.get(to, f"n{to}"), body)

    # -------------------------------------------------------------- wiring --
    def _build_node(self, name: str, node_names) -> None:
        from accord_tpu_torch.local.node import Node
        self.node_name = name
        my_id = node_num(name)
        ids = sorted(node_num(n) for n in node_names)
        self.names = {node_num(n): n for n in node_names}
        rf = self.rf if self.rf is not None else min(3, len(ids))
        topology = build_topology(ids, rf, n_shards=len(ids))
        agent = HostAgent()
        self.scheduler.on_error = agent.on_uncaught_exception
        self.node = Node(my_id, self.sink, agent, self.scheduler,
                         ListStore(my_id), RandomSource(my_id),
                         num_shards=1,
                         now_us=lambda: int(time.time() * 1e6))
        # always-on event-loop health telemetry, same layer the TCP loop
        # wires (obs/cpuprof.LoopHealth): the due-timer scheduling gave this
        # loop correct timer scheduling but no way to OBSERVE timer
        # lateness — the lag histogram closes that
        from accord_tpu_torch.obs.cpuprof import LoopHealth
        self.loop_health = LoopHealth(self.node.obs.registry,
                                      self.node.obs.flight)
        self.scheduler.lag_observer = self.loop_health.timer_lag
        # topology flows through a real ConfigurationService (same layer
        # the TCP host wires): admin_epoch installs gossip over ordinary
        # "accord" envelopes and gaps heal via TOPOLOGY_FETCH
        from accord_tpu_torch.impl.config_service import LedgerConfigService
        from accord_tpu_torch.messages.admin import EpochInstall
        self.config_service = LedgerConfigService(my_id)
        self.config_service.attach_node(self.node)
        self.config_service.remember_spec(EpochInstall.from_topology(topology))
        self.config_service.report_topology(topology)
        # ACCORD_JOURNAL=<dir>: replay surviving state from
        # <dir>/node-<id>, then journal every side-effecting request before
        # it is acked (group-commit fsync windows; see journal/wal.py)
        from accord_tpu_torch.journal import attach_journal_from_env
        self.wal = attach_journal_from_env(self.node)
        # ACCORD_QOS=1: per-tenant QoS admission tier (same layer the TCP
        # host wires; see accord_tpu_torch/qos/).  Default off — with the gate
        # unset the lag observer and txn path are the pre-QoS wiring.
        from accord_tpu_torch.qos import qos_tier_from_env
        self.qos = qos_tier_from_env(
            self.node.obs.registry, self.node.obs.flight,
            clock_us=lambda: int(time.time() * 1e6),
            loop_health=self.loop_health, wal=self.wal)
        if self.qos is not None:
            lh_hook, qos_hook = self.loop_health.timer_lag, self.qos.observe_lag

            def _lag_chain(lag_s, _lh=lh_hook, _qos=qos_hook):
                _lh(lag_s)
                _qos(lag_s)
            self.scheduler.lag_observer = _lag_chain
        # ACCORD_PIPELINE=1: continuous micro-batching ingest (same layer
        # the TCP host wires; see accord_tpu_torch/pipeline/).  Default off.
        from accord_tpu_torch.pipeline import (Pipeline, PipelineConfig,
                                         pipeline_enabled)
        self.pipeline = Pipeline(self.node, self.scheduler,
                                 PipelineConfig.from_env(), qos=self.qos) \
            if pipeline_enabled() else None
        # ACCORD_METRICS_PORT=<base>: per-process Prometheus/JSON metrics
        # endpoint (base + node_id - 1), same layer the TCP host exposes
        from accord_tpu_torch.obs.httpd import maybe_start_from_env
        self.metrics_server = maybe_start_from_env(lambda: self.node.obs,
                                                   node_id=my_id)
        # ACCORD_AUDIT_S=<s>: periodic replica-state audit + census over
        # the AUDIT_* verbs (local/audit.py; default on at 5 s, 0 off) —
        # the audit traffic rides ordinary "accord" envelopes, the live
        # view rides the metrics endpoint's /audit route
        from accord_tpu_torch.local.audit import auditor_from_env
        self.auditor = auditor_from_env(self.node)

    # ------------------------------------------------------------ handlers --
    def handle(self, envelope: dict) -> None:
        body = envelope.get("body", {})
        typ = body.get("type")
        src = envelope.get("src", "")
        if typ == "init":
            self._build_node(body["node_id"], body["node_ids"])
            self._emit(src, {"type": "init_ok",
                             "in_reply_to": body.get("msg_id")})
            replay, self._pre_init = self._pre_init, []
            for env in replay:
                self.handle(env)
        elif self.node is None:
            # a faster peer's traffic raced our init: hold it
            self._pre_init.append(envelope)
        elif typ == "txn":
            self._handle_txn(src, body)
        elif typ == "accord":
            self._handle_accord(src, body)
        elif typ == "final_read":
            # harness-only: linearizable read of a key set via a READ txn
            self._handle_txn(src, {
                "msg_id": body.get("msg_id"),
                "type": "txn",
                "txn": [["r", k, None] for k in body["keys"]]})
        elif typ == "admin_epoch":
            # admin plane: propose a topology epoch over the Maelstrom
            # transport — journaled before the ack, gossiped so one
            # contacted node converges the whole membership
            self._handle_admin_epoch(src, body)
        elif typ == "admin_drain":
            # admin plane: scale-in — fence, hand off in-flight work, wait
            # the durability barrier, retire without losing an ack
            self._handle_admin_drain(src, body)

    def _handle_admin_epoch(self, client: str, body: dict) -> None:
        from accord_tpu_torch.messages.admin import EpochInstall
        spec = body.get("topology", {})
        install = EpochInstall(
            int(spec["epoch"]),
            [(s[0], s[1], tuple(s[2])) for s in spec["shards"]])
        self.node.receive(install, 0, None)

        def ack():
            # _emit serializes under _emit_lock, so firing from the WAL
            # flush thread is safe
            self._emit(client, {"type": "admin_epoch_ok",
                                "in_reply_to": body.get("msg_id"),
                                "epoch": self.node.epoch})

        if self.wal is not None:
            # persist-before-ack without parking the scheduler loop
            self.wal.sync_soon(ack)
        else:
            ack()

    def _handle_admin_drain(self, client: str, body: dict) -> None:
        """`{"type":"admin_drain"}`: scale-in this node (the TCP host's
        drain ladder, host/tcp.py:_admin_drain, over Maelstrom envelopes).
        DrainBegin fences new client coordination (journaled: a crashed
        drainer comes back fenced) and tells peers to deprioritize us as a
        fetch source; then we wait for in-flight coordinations to settle,
        raise a GLOBAL_SYNC durability barrier over our ranges, and only
        then ack + DrainDone."""
        from accord_tpu_torch.messages.admin import DrainBegin, DrainDone
        node = self.node
        msg_id = body.get("msg_id")
        topology = node.topology.current()
        members = sorted(n for n in topology.nodes() if n != node.id)
        node.receive(DrainBegin(node.id), 0, None)
        for to in members:
            node.send(to, DrainBegin(node.id))
        deadline = time.monotonic() + float(body.get("timeout_s", 60.0))

        def finish(_v=None, failure=None):
            node.receive(DrainDone(node.id), 0, None)
            for to in members:
                node.send(to, DrainDone(node.id))

            def ack():
                # every acked write is on disk before we go; _emit holds
                # _emit_lock so the flush thread may fire this directly
                self._emit(client, {"type": "admin_drain_ok",
                                    "in_reply_to": msg_id, "node": node.id,
                                    "durable": failure is None})

            if self.wal is not None:
                self.wal.sync_soon(ack)
            else:
                ack()

        def durability_barrier():
            owned = topology.ranges_for_node(node.id)
            if owned.is_empty:
                # the current epoch already moved everything away; older
                # in-flight work still needs the watermark — barrier all
                owned = Ranges([s.range for s in topology.shards])
            from accord_tpu_torch.coordinate.syncpoint import BarrierType, barrier
            barrier(node, owned, BarrierType.GLOBAL_SYNC) \
                .add_callback(finish)

        def wait_idle():
            # hand off in-flight work: poll until nothing this node is
            # coordinating remains (new client work is already fenced)
            if not node.coordinating or time.monotonic() >= deadline:
                durability_barrier()
                return
            self.scheduler.once(0.05, wait_idle)

        wait_idle()

    def _handle_txn(self, client: str, body: dict) -> None:
        ops = body["txn"]
        msg_id = body.get("msg_id")
        if self.node.draining:
            # drain fence: never coordinated — Maelstrom code 11 is
            # temporarily-unavailable (retriable), so the workload remaps
            # to another coordinator instead of losing the op
            self._emit(client, {"type": "error", "in_reply_to": msg_id,
                                "code": 11, "text": "draining",
                                "drained": True})
            return
        if self.qos is not None:
            # QoS outer ring: admission before any coordination/journal
            # state is spent.  Maelstrom code 11 is temporarily-unavailable
            # (retriable); the tenant defaults to the client name so every
            # Maelstrom client gets its own token bucket
            nack = self.qos.admit(str(body.get("tenant") or client),
                                  str(body.get("priority") or "normal"))
            if nack is not None:
                self._emit(client, {"type": "error", "in_reply_to": msg_id,
                                    "code": 11, "text": repr(nack),
                                    "qos": True, "reason": nack.reason,
                                    "retry_after_us": nack.retry_after_us})
                return
        reads = []
        appends: Dict[Key, int] = {}
        for op, k, v in ops:
            token = key_token(k)
            if op == "r":
                reads.append(Key(token))
            elif op == "append":
                if Key(token) in appends:
                    # the list-register data plane carries one append per
                    # key per txn; acking a collapsed second append would be
                    # a lost acknowledged write
                    if self.qos is not None:
                        self.qos.op_done()  # admitted but never coordinated
                    self._emit(client, {"type": "error",
                                        "in_reply_to": msg_id, "code": 10,
                                        "text": f"duplicate append to {k}"})
                    return
                appends[Key(token)] = v
            else:
                if self.qos is not None:
                    self.qos.op_done()  # admitted but never coordinated
                self._emit(client, {"type": "error", "in_reply_to": msg_id,
                                    "code": 10,
                                    "text": f"unsupported op {op}"})
                return
        keys = Keys(set(reads) | set(appends))
        txn = Txn(TxnKind.WRITE if appends else TxnKind.READ, keys,
                  read=ListRead(Keys(reads)) if reads else None,
                  query=ListQuery(),
                  update=ListUpdate(appends) if appends else None)

        def done(result, failure):
            if self.qos is not None:
                # admitted op settled (either way): shrink the tier's
                # inflight backlog signal
                self.qos.op_done()
            if failure is not None:
                self._emit(client, {"type": "error", "in_reply_to": msg_id,
                                    "code": 11, "text": repr(failure)})
                return
            out = []
            values = (result.read_values
                      if isinstance(result, ListResult) else {})
            applied: Dict[Key, list] = {}  # own appends, in micro-op order
            for op, k, v in ops:
                kk = Key(key_token(k))
                if op == "r":
                    # txn-list-append semantics: a read observes the
                    # pre-state PLUS this txn's earlier appends to the key
                    pre = values.get(kk)
                    got = list(pre) if pre is not None else []
                    out.append([op, k, got + applied.get(kk, [])])
                else:
                    applied.setdefault(kk, []).append(v)
                    out.append([op, k, v])
            self._emit(client, {"type": "txn_ok", "in_reply_to": msg_id,
                                "txn": out})

        if self.pipeline is not None:
            self.pipeline.submit(txn).add_callback(done)
        else:
            self.node.coordinate(txn).add_callback(done)

    def _handle_accord(self, src: str, body: dict) -> None:
        prof = self.node.obs.cpuprof
        if prof.enabled:
            # decode lap for the CPU waterfall (obs/cpuprof.py): parked on
            # the profiler, consumed by the dispatch it precedes
            t0 = time.perf_counter()
            payload = decode_message(body["payload"])
            prof.note_decode(time.perf_counter() - t0)
        else:
            payload = decode_message(body["payload"])
        from_id = node_num(src)
        if "in_reply_to" in body:
            self.sink.deliver_reply(body["in_reply_to"], from_id, payload)
        else:
            reply_context = body.get("msg_id")
            self.node.receive(payload, from_id, reply_context)

    # ---------------------------------------------------------------- loop --
    def run(self) -> None:
        """Single-threaded core: a reader thread only enqueues stdin lines
        (select+readline over buffered pipes loses lines parked in the
        Python-side buffer); the node is touched exclusively here."""
        import queue
        import threading
        lines: "queue.Queue[Optional[str]]" = queue.Queue()

        def reader():
            for line in self.stdin:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=reader, daemon=True).start()
        eof = False
        while self.running and not eof:
            # due timers run BEFORE blocking: `min(timeout, 0.5) or 0.01`
            # used to turn a due-now deadline (timeout == 0.0) into a 10ms
            # sleep — the host/tcp.py event loop fixed the same bug
            self.scheduler.run_due()
            deadline = self.scheduler.next_deadline()
            timeout = (max(0.0, deadline - time.monotonic())
                       if deadline is not None else 0.5)
            try:
                batch = [lines.get(timeout=min(timeout, 0.5))]
            except queue.Empty:
                batch = []
            # pipeline mode: drain the stdin burst and process it under one
            # sink coalescing window (same-destination messages the burst
            # produces leave as one envelope per peer per tick)
            while self.pipeline is not None and len(batch) < 64:
                try:
                    batch.append(lines.get_nowait())
                except queue.Empty:
                    break
            coalesce = self.pipeline is not None and len(batch) > 1
            if coalesce:
                self.sink.batch_begin()
            t_busy = time.perf_counter()
            try:
                for line in batch:
                    if line is None:
                        eof = True
                        break
                    if line and line.strip():
                        try:
                            self.handle(json.loads(line))
                        except Exception as e:  # noqa: BLE001
                            print(f"handle error: {e!r} on {line[:200]}",
                                  file=sys.stderr, flush=True)
            finally:
                if coalesce:
                    self.sink.batch_flush()
            self.scheduler.run_due()
            if batch and self.loop_health is not None:
                # loop-health parity with the TCP event loop
                # (obs/cpuprof.LoopHealth): busy time of this pass (the
                # blocking stdin get excluded), burst length, and the
                # stdin backlog left unread — the saturation signal
                self.loop_health.tick(time.perf_counter() - t_busy,
                                      len(batch), lines.qsize())
        if self.wal is not None:
            self.wal.close()  # final fsync on clean shutdown


def main():
    MaelstromHost().run()


if __name__ == "__main__":
    main()
