"""TCP transport host: Accord nodes over real sockets.

Reference context: the MessageSink SPI (api/MessageSink.java) is the
distributed communication backend; the reference ships a simulated sink, a
mock, and Maelstrom's stdio JSON sink, with real transports host-provided
(SURVEY §5.8).  This module is that real transport, rearchitected for raw
per-node speed (the BASELINE r5 profile showed the host tier — not the
protocol — as the binding constraint: ~14 small frames/txn of cross-thread
and cross-process scheduling):

  * ONE selector-driven event loop thread owns everything: the Node,
    RealTimeScheduler timers (deadlines are the poll timeout — due timers
    run before every block, never floored into a sleep), all sockets
    (non-blocking), and all framing.  No per-frame thread handoffs: the
    old architecture paid a queue.Queue hop per inbound frame plus a
    dedicated writer thread per peer.
  * Universal per-peer frame coalescing: every message a flush tick
    produces for a given peer leaves as ONE multi-message frame (the
    transport-level generalisation of the pipeline's MultiPreAccept
    envelope — amortising syscalls the way the pipeline amortises device
    dispatch), decoded back into individual dispatches on the far side.
    `ACCORD_TCP_FLUSH_TICK_US` bounds how long a frame may wait for
    company (0 = flush at the end of every loop pass, the default: a pass
    already coalesces everything a burst of input produced).
  * Binary frame codec (host/wire.py pack_frame/unpack_frame): the native
    tier when the toolchain is present, the byte-identical pure-Python
    tier otherwise; legacy JSON frames are auto-detected on decode.

Client transactions enter through `submit()` (any thread), which enqueues
onto the loop and hands back a thread-safe future.
"""

from __future__ import annotations

import os
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.host.maelstrom import (HostAgent, MaelstromSink,
                                       build_topology)
from accord_tpu_torch.host.rt import RealTimeScheduler
from accord_tpu_torch.host.wire import (decode_message, pack_frame, unpack_frame,
                                  unpack_frame_obj)
from accord_tpu_torch.impl.list_store import ListQuery, ListRead, ListStore, ListUpdate
from accord_tpu_torch.obs.views import MetricView, bind_metric_views
from accord_tpu_torch.primitives.keys import Key, Keys
from accord_tpu_torch.primitives.timestamp import TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.random_source import RandomSource

_LEN = struct.Struct(">I")
_MAX_FRAME = 256 << 20  # corrupt-length guard: drop the connection instead
_RECV_CHUNK = 1 << 18
# max bulk-tier client submits dispatched per loop pass under QoS: bounds
# pass length during an overload flood so high submits, protocol messages
# and timers keep a few-ms service cadence (see _run_loop's lane comment)
_BULK_PER_PASS = 32


def _build_list_txn(read_tokens, appends: Dict[int, int],
                    ephemeral: bool = False) -> Txn:
    """List-register read/append txn (shared by the in-process and wire
    client paths).  `ephemeral` routes a pure read down the single-round
    invisible EPHEMERAL_READ path (coordinate/ephemeral.py) — the
    workload harness's read-heavy SLO lane."""
    if ephemeral:
        assert read_tokens and not appends, \
            "ephemeral txns are pure reads"
        keys = Keys.of(*read_tokens)
        return Txn(TxnKind.EPHEMERAL_READ, keys, read=ListRead(keys),
                   query=ListQuery())
    keys = Keys.of(*(set(read_tokens) | set(appends)))
    return Txn(
        TxnKind.WRITE if appends else TxnKind.READ, keys,
        read=ListRead(Keys.of(*read_tokens)) if read_tokens else None,
        query=ListQuery(),
        update=ListUpdate({Key(t): v for t, v in appends.items()})
        if appends else None)


def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = pack_frame(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    data = _recv_exact(sock, n)
    return None if data is None else unpack_frame(data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpSink(MaelstromSink):
    """MaelstromSink over the socket transport, plus two codec shortcuts:

    * object-identity loopback: self-addressed traffic (the coordinator is
      a replica of everything it coordinates at rf=n) skips the
      encode->decode round trip entirely and is delivered as the original
      object on the next loop pass — exactly the sim sink's delivery
      semantics, worth ~1/3 of all codec work on a 3-node cluster;
    * raw payloads: in the binary wire modes, bodies carry the protocol
      message OBJECT and the frame codec serialises it in one native pass
      at flush time (host/wire.py pack_frame) — no intermediate structural
      tree at all.  Legacy JSON framing pre-encodes as before.

    The envelope framing for real peers stays MaelstromSink's, so the two
    transports cannot diverge."""

    _packs_objects = None  # resolved once per process (env-dependent)

    def _enc(self, request):
        packs = TcpSink._packs_objects
        if packs is None:
            from accord_tpu_torch.host.wire import packs_objects
            packs = TcpSink._packs_objects = packs_objects()
        if packs:
            return request
        return super()._enc(request)

    def send(self, to, request) -> None:
        if to == self.host.my_id:
            if self._capture(to, None, request):
                return
            self.host.deliver_local(request, None)
            return
        super().send(to, request)

    def send_with_callback(self, to, request, callback,
                           executor=None) -> None:
        if to == self.host.my_id:
            msg_id = self._register(callback)
            if self._capture(to, msg_id, request):
                return
            self.host.deliver_local(request, msg_id)
            return
        super().send_with_callback(to, request, callback, executor)

    def _send_prepared(self, to, reply_context, request) -> None:
        if to == self.host.my_id:
            self.host.deliver_local(request, reply_context)
            return
        super()._send_prepared(to, reply_context, request)

    def reply(self, to, reply_context, reply) -> None:
        if to == self.host.my_id:
            if reply_context is not None:
                self.host.deliver_local_reply(reply_context, reply)
            return
        super().reply(to, reply_context, reply)


class SubmitResult:
    """Thread-safe completion handle for a submitted transaction."""

    def __init__(self):
        self._event = threading.Event()
        self.value = None
        self.failure: Optional[BaseException] = None

    def _complete(self, value, failure) -> None:
        self.value = value
        self.failure = failure
        self._event.set()

    def wait(self, timeout_s: float = 30.0) -> "SubmitResult":
        if not self._event.wait(timeout_s):
            self.failure = TimeoutError("txn did not complete")
        return self


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _trace_of(body: dict) -> Optional[str]:
    """The trace id riding an accord payload — raw message object
    (binary modes) or encoded tree (JSON mode); the frame_coalesce flight
    events stamp the bundled messages' ids at the egress buffer."""
    payload = body.get("payload")
    if payload is None:
        return None
    if type(payload) is dict:
        fields = payload.get("f")
        if type(fields) is dict:
            tid = fields.get("trace_id")
            return tid if type(tid) is str else None
    tid = getattr(payload, "trace_id", None)
    return tid if type(tid) is str else None


class _PeerLane:
    """The outbound lane to one peer, owned by the event loop thread: a
    coalescing egress buffer (bodies awaiting the next flush tick), a FIFO
    of packed frames awaiting socket writability, and the non-blocking
    connection itself with backoff reconnect.

    Ordering contract: frames leave in enqueue order, always.  On a broken
    connection the partially-written head frame is resent IN FULL on the
    fresh connection (the peer's reader discarded the torn tail at EOF),
    so reconnection can duplicate a frame but never reorder or lose one
    silently — duplicates are idempotent at the protocol layer, exactly as
    with the old per-frame retry loop.  Only admission (buffer bound
    exceeded -> `shed`) and a peer that outlives the whole backoff
    schedule (`send_drops`, frames dropped whole) lose frames, degrading
    to the lossy-link model that RPC timeouts and the progress log heal.

    Obs: shed/send_drops/retries keep their first names; frames/msgs
    counters and the frame-size histograms are the coalescing-ratio
    surface the bench rows record."""

    shed = MetricView("accord_tcp_peer_shed_total")
    send_drops = MetricView("accord_tcp_peer_send_drops_total")
    retries = MetricView("accord_tcp_peer_retries_total")
    frames = MetricView("accord_tcp_frames_total")
    msgs = MetricView("accord_tcp_msgs_total")

    def __init__(self, host: "TcpHost", to: int):
        from accord_tpu_torch.pipeline.backpressure import SendBackoff
        self.host = host
        self.to = to
        self.pending: List[dict] = []   # bodies awaiting the flush tick
        self.flush_at: Optional[float] = None
        self.frames_q: deque = deque()  # packed frames awaiting the socket
        self.head_off = 0               # bytes of frames_q[0] already sent
        self.buffered_bytes = 0
        # bytes held by the geo egress shim (frames waiting out their
        # injected one-way delay on the scheduler before joining frames_q);
        # counted against the admission bound so a WAN lane under load
        # still backpressures
        self.delayed_bytes = 0
        self.max_buffered = _env_int("ACCORD_TCP_PEER_BUF_BYTES", 8 << 20)
        self.max_pending = _env_int("ACCORD_TCP_PEER_INFLIGHT", 4096)
        self.sock: Optional[socket.socket] = None
        self.connecting = False
        self.backoff = SendBackoff()
        self.attempt = 0
        self._retry_timer = None
        registry = host.node.obs.registry
        bind_metric_views(self, registry, peer=to)
        self._g_buffered = registry.gauge("accord_tcp_peer_buffered_bytes",
                                          peer=to)
        self._h_frame_bytes = registry.histogram("accord_tcp_frame_bytes",
                                                 peer=to)
        self._h_frame_msgs = registry.histogram("accord_tcp_frame_msgs",
                                                peer=to)

    # ----------------------------------------------------------- egress --
    def enqueue(self, body: dict) -> None:
        if len(self.pending) >= self.max_pending \
                or self.buffered_bytes + self.delayed_bytes \
                > self.max_buffered:
            self.shed += 1  # backpressure: shed like a drop-tail link
            return
        self.pending.append(body)
        self.host.flight.record("frame_coalesce", _trace_of(body),
                                (self.to, len(self.pending)))
        if self.flush_at is None:
            tick = self.host.flush_tick_us
            # tick 0 flushes as soon as the producing dispatch returns; a
            # positive tick lets the frame wait for company so a burst
            # amortises into one syscall per peer.  Either way the
            # deadline is enforced DURING long dispatch passes (the loop
            # checks after every body), never only at pass end — an
            # egress buffer must add bounded latency, not pass-length
            # latency.
            self.flush_at = time.monotonic() + tick / 1e6 if tick else 0.0
            self.host.mark_dirty(self)

    def flush(self) -> None:
        """Close the coalescing window: everything pending leaves as ONE
        frame (single-body frames skip the multi-envelope key)."""
        bodies, self.pending = self.pending, []
        self.flush_at = None
        if not bodies:
            return
        if len(bodies) == 1:
            frame = {"src": self.host.my_id, "body": bodies[0]}
        else:
            frame = {"src": self.host.my_id, "m": bodies}
        data = pack_frame(frame)
        packed = _LEN.pack(len(data)) + data
        self.frames += 1
        self.msgs += len(bodies)
        self._h_frame_bytes.observe(len(data))
        self._h_frame_msgs.observe(len(bodies))
        self.host.flight.record("frame_flush", None,
                                (self.to, len(bodies), len(data)))
        # getattr: unit tests drive lanes with a minimal host stub that
        # predates the geo field
        geo = getattr(self.host, "geo", None)
        if geo is not None:
            cls = geo.link_class(self.host.my_id, self.to)
            if cls is not None:
                # per-link-class census with REAL frame bytes (the wan
                # report's WAN bytes/txn numerator)
                reg = self.host.node.obs.registry
                reg.counter("accord_link_msgs_total",
                            cls=cls).inc(len(bodies))
                reg.counter("accord_link_frames_total", cls=cls).inc()
                reg.counter("accord_link_bytes_total",
                            cls=cls).inc(len(packed))
                d = geo.one_way_nominal_us(self.host.my_id, self.to)
                if d:
                    # tc-free egress delay shim: hold the packed frame on
                    # the loop's own timer heap for the nominal one-way
                    # delay.  The delay is CONSTANT per pair and the heap
                    # is FIFO-stable on ties, so per-lane frame order is
                    # preserved.
                    self.delayed_bytes += len(packed)
                    self.host.scheduler.once(
                        d / 1e6, lambda p=packed: self._release(p))
                    return
        self.frames_q.append(packed)
        self.buffered_bytes += len(packed)
        self._g_buffered.value = self.buffered_bytes
        if self.sock is None and not self.connecting:
            self._connect()
        elif self.sock is not None and not self.connecting:
            self.drain()

    def _release(self, packed: bytes) -> None:
        """A geo-delayed frame served its injected one-way latency: move
        it onto the socket FIFO (loop thread — scheduler timers run in
        run_due)."""
        self.delayed_bytes -= len(packed)
        self.frames_q.append(packed)
        self.buffered_bytes += len(packed)
        self._g_buffered.value = self.buffered_bytes
        if self.sock is None and not self.connecting:
            self._connect()
        elif self.sock is not None and not self.connecting:
            self.drain()

    # ------------------------------------------------------- connection --
    def _connect(self) -> None:
        addr = self.host.peers.get(self.to)
        if addr is None:
            # peer address not (yet) known — an epoch install's `peers`
            # spec teaches it; until then back off like a dead link
            self._fail()
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        self.sock = sock
        self.connecting = True
        try:
            rc = sock.connect_ex(addr)
        except OSError:
            self._fail()
            return
        if rc == 0:
            self._connected()
        else:
            # completion (or refusal) arrives as writability
            self.host.register(sock, selectors.EVENT_WRITE, self)

    def _connected(self) -> None:
        self.connecting = False
        self.attempt = 0
        # consensus rounds are small request/reply frames: Nagle +
        # delayed-ACK otherwise stalls each ~40ms
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.host.register(self.sock, selectors.EVENT_READ, self)
        self.drain()

    def on_io(self, mask: int) -> None:
        """Selector event on this lane's socket."""
        if self.connecting:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            self.host.unregister(self.sock)
            if err != 0:
                self._fail()
                return
            self._connected()
            return
        if mask & selectors.EVENT_READ:
            # peers never send on our outbound connection: readability is
            # EOF/reset (recv b"" or an error) — tear down and reconnect
            try:
                if self.sock.recv(4096) == b"":
                    self._fail()
                    return
            except BlockingIOError:
                pass
            except OSError:
                self._fail()
                return
        if mask & selectors.EVENT_WRITE:
            self.drain()

    def drain(self) -> None:
        """Write as much of the frame FIFO as the socket accepts; keep
        EVENT_WRITE armed exactly while bytes remain."""
        sock = self.sock
        if sock is None or self.connecting:
            return
        try:
            while self.frames_q:
                head = self.frames_q[0]
                n = sock.send(head[self.head_off:] if self.head_off
                              else head)
                self.head_off += n
                self.buffered_bytes -= n
                if self.head_off >= len(head):
                    self.frames_q.popleft()
                    self.head_off = 0
        except BlockingIOError:
            pass
        except OSError:
            self._fail()
            return
        self._g_buffered.value = self.buffered_bytes
        want = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if self.frames_q else 0)
        self.host.register(sock, want, self)

    def _fail(self) -> None:
        """Connection failed or broke: resend the head frame whole on the
        next connection (never a torn tail), back off, and after the
        whole schedule drop the buffered frames (lossy-link model)."""
        self._teardown()
        # the peer saw a torn (discarded) tail: restore head-frame bytes
        self.buffered_bytes += self.head_off
        self.head_off = 0
        self.attempt += 1
        delay = self.backoff.delay_s(self.attempt)
        if delay is None:
            dropped = len(self.frames_q)
            if dropped:
                self.send_drops += dropped  # dead peer: timeouts heal
                self.frames_q.clear()
                self.buffered_bytes = 0
                self._g_buffered.value = 0
            # keep probing a dead peer at the backoff cap so a restarted
            # process is rediscovered without a fresh frame having to pay
            # the whole schedule again
            self.attempt = self.backoff.max_attempts - 1
            delay = self.backoff.cap_s
        self.retries += 1
        self._retry_timer = self.host.scheduler.once(delay, self._retry)

    def _retry(self) -> None:
        self._retry_timer = None
        if self.sock is None and not self.connecting \
                and (self.frames_q or self.pending):
            self._connect()

    def _teardown(self) -> None:
        if self.sock is not None:
            self.host.unregister(self.sock)
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.connecting = False

    def close(self) -> None:
        if self._retry_timer is not None:
            self._retry_timer.cancel()
        self._teardown()


class _InConn:
    """One accepted inbound connection: a read buffer and its incremental
    length-prefix frame parser (all on the loop thread)."""

    __slots__ = ("sock", "rbuf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()

    def read_frames(self) -> Optional[List[dict]]:
        """Drain readable bytes and parse complete frames; None = close
        this connection (EOF, reset, or corrupt stream)."""
        try:
            while True:
                chunk = self.sock.recv(_RECV_CHUNK)
                if chunk == b"":
                    return None
                self.rbuf += chunk
                if len(chunk) < _RECV_CHUNK:
                    break
        except BlockingIOError:
            pass
        except OSError:
            return None
        frames = []
        buf = self.rbuf
        pos = 0
        try:
            while len(buf) - pos >= _LEN.size:
                (n,) = _LEN.unpack_from(buf, pos)
                if n > _MAX_FRAME:
                    return None
                if len(buf) - pos - _LEN.size < n:
                    break
                start = pos + _LEN.size
                frames.append(unpack_frame_obj(bytes(buf[start:start + n])))
                pos = start + n
        except (ValueError, UnicodeDecodeError):
            return None  # corrupt stream: drop the connection
        if pos:
            del buf[:pos]
        return frames


def _env_store_factory():
    """Optional batched-device command stores for the real-socket host:
    ACCORD_TCP_DEVICE_STORE=1 puts DeviceCommandStore behind every node
    (flush window ACCORD_TCP_FLUSH_US wall-clock µs, default 1000; inline
    scalar verification with ACCORD_TCP_DEVICE_VERIFY=1).  The same tier
    the burn exercises, demonstrated on the black-box transport.

    The stores sit on ACCORD_TCP_DEVICE, a torch device: unset means the
    CUDA card (the store raises without one), ``cpu`` the plain PyTorch
    versions.  On the card the CUDA context, K1's and K2's libraries and the
    matmul library are made ready here, before the host serves: a node whose
    first flush stalls its dispatch loop on nvcc or on context creation
    makes its peers' wall-clock RPC rounds time out."""
    if os.environ.get("ACCORD_TCP_DEVICE_STORE", "") != "1":
        return None
    device = os.environ.get("ACCORD_TCP_DEVICE") or None
    _warm_card(device)
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    return DeviceCommandStore.factory(
        flush_window_us=int(os.environ.get("ACCORD_TCP_FLUSH_US", "1000")),
        verify=os.environ.get("ACCORD_TCP_DEVICE_VERIFY", "") == "1",
        device=device)


def native_tiers() -> dict:
    """Which tier each native extension runs in this process: "native" (the
    C++ module, built at first use) or "python"; the wire codec as
    ``codec_tier()`` says."""
    from accord_tpu_torch import native
    from accord_tpu_torch.host.wire import codec_tier
    return {"sorted_arrays": "native" if native.get() else "python",
            "cfk": "native" if native.get_cfk() else "python",
            "wire": codec_tier()}


# how much rarer a node process's full collections are than the
# interpreter's default
FULL_COLLECTIONS_RARER = 100


def hold_off_full_collections() -> None:
    """A node process's garbage collection once the node is built (and its
    card warmed): every object made so far (modules, torch, the node's
    structures) frozen out of all collections, and full (generation-2)
    collections a hundred times rarer, while the young generations still
    collect as before.  Under the overload lane on an H100's host each node
    made 18-24 full collections of up to 469 ms (``node_probe.py``), and
    those pauses were the high class's p99 at 5x."""
    import gc
    gc.freeze()
    young, middle, full = gc.get_threshold()
    gc.set_threshold(young, middle, full * FULL_COLLECTIONS_RARER)


def process_evidence(node) -> dict:
    """Where this process's command stores run, for a metrics reply: its
    native tiers, its collector's frozen objects and thresholds, each
    store's class, device and whether it left its device tier, and the
    launches of the port's CUDA kernels in this process (none
    on the CPU), those of the card's warm-up (``_warm_card``) included and
    also given apart.  The launch counts are read only where the kernels'
    module is loaded: a scalar host does not import torch for them."""
    import gc
    import sys
    ck = sys.modules.get("accord_tpu_torch.ops.cuda_kernels")
    return {"pid": os.getpid(), "native": native_tiers(),
            "gc": {"frozen": gc.get_freeze_count(),
                   "threshold": list(gc.get_threshold())},
            "warm_launches": dict(WARM_LAUNCHES),
            "stores": [{"type": type(s).__name__,
                        "device": str(getattr(s, "device", "host")),
                        "disabled": bool(getattr(s, "device_disabled",
                                                 False))}
                       for s in node.command_stores.all()],
            "launches": ({k.name: k.launches for k in ck.KERNELS}
                         if ck is not None else {})}


# the kernel launches _warm_card made in this process: process_evidence
# reports them apart from the node's
WARM_LAUNCHES: Dict[str, int] = {}
_WARMED: set = set()  # the devices warmed in this process


def _warm_card(device) -> None:
    """Create the CUDA context, build and load the kernels a store's flush
    launches (K6, K1, K2), and run every step of a store's flush once
    (``workload.warm_flush_path``), so that no torch kernel is first loaded
    inside the node's loop; nothing for a CPU device."""
    from accord_tpu_torch.utils.backend import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda" or str(dev) in _WARMED:
        return
    _WARMED.add(str(dev))
    from accord_tpu_torch.ops import cuda_kernels as ck
    from accord_tpu_torch.workload import warm_flush_path
    flush_kernels = (ck.SUCC_W, ck.DEPS_TILE, ck.WAVEFRONT)
    ck.build(flush_kernels)
    for k in flush_kernels:
        k.lib()
    before = {k.name: k.launches for k in ck.KERNELS}
    warm_flush_path(dev)
    for k in ck.KERNELS:
        WARM_LAUNCHES[k.name] = (WARM_LAUNCHES.get(k.name, 0)
                                 + k.launches - before[k.name])


class TcpHost:
    """One Accord node bound to a TCP port, peered with `peers`
    (node_id -> (host, port), including itself)."""

    def __init__(self, my_id: int, peers: Dict[int, Tuple[str, int]],
                 rf: Optional[int] = None, n_shards: int = 4,
                 topology_ids: Optional[List[int]] = None):
        self.my_id = my_id
        self.peers = dict(peers)
        self._loop_tid: Optional[int] = None  # set once the loop starts:
        # everything emitted before then (journal replay, topology
        # install) marshals through call_soon and drains on the first tick
        self.scheduler = RealTimeScheduler()
        self.sink = TcpSink(self)
        # coalescing default-on: up to 1ms of company-waiting per frame
        # WHILE A BURST IS IN PROGRESS (the loop flushes everything the
        # moment it would otherwise go idle, so an unloaded request never
        # pays the tick); 0 flushes after every dispatched item
        # coalescing window default raised 1000 -> 2500us: on a
        # core-starved box every frame syscall is also a likely preemption
        # point for the peer processes, so deeper coalescing cuts protocol
        # CPU twice over (measured: ~1/3 fewer frames, +6% tcp lane, lower
        # per-verb dispatch p50s).  Unloaded latency is unaffected — the
        # loop still flushes immediately on idle.
        self.flush_tick_us = _env_int("ACCORD_TCP_FLUSH_TICK_US", 2500)
        self._out: Dict[int, _PeerLane] = {}
        self.running = True

        self.selector = selectors.DefaultSelector()
        self._calls: deque = deque()     # cross-thread entry (thread-safe)
        self._local_q: deque = deque()   # self-addressed bodies (loop only)
        self._bulk_backlog: deque = deque()  # deferred bulk-tier submits
        self._dirty: List[_PeerLane] = []  # lanes with an open flush tick
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.selector.register(self._wake_r, selectors.EVENT_READ,
                               ("wake", None))

        self.server = socket.create_server(self.peers[my_id],
                                           reuse_port=False)
        # the OS may have assigned the port (port 0): record reality
        self.peers[my_id] = self.server.getsockname()
        self.server.setblocking(False)
        self.selector.register(self.server, selectors.EVENT_READ,
                               ("accept", None))

        # non-positive ids are CLIENT endpoints: they share the frame
        # transport (their replies travel as ordinary frames to their own
        # listening socket) but are not cluster members.  `topology_ids`
        # pins which members form EPOCH 1: a node joining an established
        # cluster mid-run (scale-out) must build the same genesis topology
        # the founders did — one that does NOT include it — and acquire
        # its ranges only through the epoch that assigns them.
        ids = (sorted(topology_ids) if topology_ids
               else sorted(i for i in self.peers if i > 0))
        rf = rf if rf is not None else min(3, len(ids))
        topology = build_topology(ids, rf, n_shards)

        from accord_tpu_torch.local.node import Node
        agent = HostAgent()
        self.scheduler.on_error = agent.on_uncaught_exception
        self.node = Node(my_id, self.sink, agent, self.scheduler,
                         ListStore(my_id), RandomSource(my_id), num_shards=1,
                         store_factory=_env_store_factory(),
                         # time_ns // 1000: no float round-trip — this
                         # clock runs per flight/span event, not just per
                         # HLC mint
                         now_us=lambda: time.time_ns() // 1000)
        self.flight = self.node.obs.flight
        # always-on event-loop health telemetry (obs/cpuprof.LoopHealth):
        # timer-lag histogram via the scheduler hook, tick/burst/backlog
        # gauges from _tick, loop_lag/queue_saturation flight alarms
        from accord_tpu_torch.obs.cpuprof import LoopHealth
        self.loop_health = LoopHealth(self.node.obs.registry, self.flight)
        self.scheduler.lag_observer = self.loop_health.timer_lag
        # ACCORD_SHARDS=<n> (n >= 2): per-shard worker runtime (shard/) —
        # the node's command stores live in n forked worker processes, one
        # event loop + one store + one WAL band each, and this host's
        # command_stores becomes the supervisor-side router.  Unset or 1:
        # the in-loop CommandStores built by Node above is untouched —
        # bit-identical to the pre-shard wiring.  The swap happens BEFORE
        # report_topology below so the genesis install drives spawn_all().
        from accord_tpu_torch import shard as _shard
        self.shard_supervisor = None
        _n_workers = _shard.workers_from_env()
        if _n_workers:
            from accord_tpu_torch.shard.supervisor import (ShardSupervisor,
                                                     WorkerCommandStores)
            self.shard_supervisor = ShardSupervisor(self, self.node,
                                                    _n_workers)
            self.node.command_stores = WorkerCommandStores(
                self.node, self.shard_supervisor)
            # HLC striping: parent mints stripe 0, worker k stripe k+1,
            # all mod n+1 — timestamps stay unique across the processes
            # sharing this node id without coordination
            self.node.set_hlc_stripe(0, _n_workers + 1)
        # topology flows through a real ConfigurationService (the admin
        # plane's epoch ledger): installs gossip peer-to-peer, gaps heal
        # via TOPOLOGY_FETCH, and `peers` specs riding an install teach
        # this transport new nodes' addresses (scale-out)
        from accord_tpu_torch.impl.config_service import LedgerConfigService
        from accord_tpu_torch.messages.admin import EpochInstall
        self.config_service = LedgerConfigService(
            my_id, peers_hook=self._merge_peers,
            geo_hook=self._install_geo_wire)
        self.config_service.attach_node(self.node)
        self.config_service.remember_spec(EpochInstall.from_topology(topology))
        self.config_service.report_topology(topology)

        # ACCORD_GEO=<json spec>: geo placement profile (topology/geo.py)
        # — DC labels on this node's obs and a tc-free egress delay shim
        # injecting the nominal one-way latency per peer lane.  A profile
        # riding a later EpochInstall frame replaces it cluster-wide.
        self.geo = None
        from accord_tpu_torch.topology.geo import GeoProfile
        geo_env = GeoProfile.from_env(os.environ.get("ACCORD_GEO"))
        if geo_env is not None:
            self.install_geo_profile(geo_env)

        # ACCORD_JOURNAL=<dir>: durable write-ahead journal under
        # <dir>/node-<id> — existing state replays into the node BEFORE any
        # peer traffic is accepted, every side-effecting request is
        # journaled before its ack, and (group-commit mode) acks are gated
        # on the covering fsync by DurableAckSink (whose flush thread
        # re-enters emit(): cross-thread sends marshal onto the loop).
        from accord_tpu_torch.journal import attach_journal_from_env
        self.wal = attach_journal_from_env(self.node)

        # ACCORD_QOS=1: per-tenant QoS admission tier (qos/) — pressure-
        # adaptive shed before any journal/coordination state is spent,
        # fed by the loop-health lag signal (the lag observer chains: both
        # callbacks run on the loop thread) and the WAL's group-commit
        # backlog.  Default off: with the gate unset the lag observer and
        # submit path are byte-for-byte the pre-QoS wiring.
        from accord_tpu_torch.qos import qos_tier_from_env
        self.qos = qos_tier_from_env(
            self.node.obs.registry, self.flight,
            clock_us=lambda: time.time_ns() // 1000,
            loop_health=self.loop_health, wal=self.wal,
            n_shards=_n_workers)
        if self.qos is not None:
            lh_hook, qos_hook = self.loop_health.timer_lag, self.qos.observe_lag

            def _lag_chain(lag_s, _lh=lh_hook, _qos=qos_hook):
                _lh(lag_s)
                _qos(lag_s)
            self.scheduler.lag_observer = _lag_chain

        # ACCORD_PIPELINE=1: continuous micro-batching ingest — client
        # submissions coalesce into deadline-bounded batches whose fan-out
        # leaves as one MultiPreAccept envelope per replica (and whose
        # self-addressed slice the device store resolves as one fused
        # probe window).  Default off.
        from accord_tpu_torch.pipeline import (Pipeline, PipelineConfig,
                                         pipeline_enabled)
        self.pipeline = Pipeline(self.node, self.scheduler,
                                 PipelineConfig.from_env(), qos=self.qos) \
            if pipeline_enabled() else None

        # ACCORD_METRICS_PORT=<base>: Prometheus text + JSON snapshot on
        # base + node_id - 1 (per-process port offset); 0 = ephemeral
        from accord_tpu_torch.obs.httpd import maybe_start_from_env
        self.metrics_server = maybe_start_from_env(lambda: self.node.obs,
                                                   node_id=my_id)

        # ACCORD_AUDIT_S=<s>: periodic replica-state audit + lifecycle
        # census (local/audit.py) — cross-replica range digests over the
        # AUDIT_* verbs every <s> seconds, divergences and census served
        # at the "audit" frame and the metrics endpoint's /audit route.
        # Default on at 5 s; 0 disables.
        from accord_tpu_torch.local.audit import auditor_from_env
        self.auditor = auditor_from_env(self.node)

        self.loop_thread = threading.Thread(target=self._run, daemon=True)
        self.loop_thread.start()

    # ------------------------------------------------------ selector glue --
    def register(self, sock: socket.socket, events: int,
                 lane: "_PeerLane") -> None:
        """Register-or-modify a lane socket (loop thread only)."""
        try:
            key = self.selector.get_key(sock)
        except KeyError:
            self.selector.register(sock, events, ("peer", lane))
            return
        if key.events != events:
            self.selector.modify(sock, events, ("peer", lane))

    def unregister(self, sock: socket.socket) -> None:
        try:
            self.selector.unregister(sock)
        except (KeyError, ValueError):
            pass

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\x01")
        except (BlockingIOError, OSError):
            pass  # a wakeup is already pending (or we are shutting down)

    def call_soon(self, fn) -> None:
        """Run `fn` on the event loop thread (any thread may call)."""
        self._calls.append(fn)
        self._wakeup()

    # ------------------------------------------------------------- egress --
    def emit(self, to: int, body: dict) -> None:
        """Queue one message body for `to`.  On the loop thread this lands
        directly in the peer's coalescing buffer (self-addressed bodies
        skip the loopback round trip entirely); other threads (the WAL's
        group-commit flush thread releasing durability-gated replies)
        marshal onto the loop first — sockets and lanes have exactly one
        owning thread."""
        if threading.get_ident() != self._loop_tid:
            self.call_soon(lambda: self.emit(to, body))
            return
        if to == self.my_id:
            self._local_q.append(
                lambda: self._dispatch(self.my_id, body))
            return
        lane = self._out.get(to)
        if lane is None:
            lane = self._out[to] = _PeerLane(self, to)
        lane.enqueue(body)

    # MaelstromSink's transport hook (shared sink implementation)
    def emit_node(self, to: int, body: dict) -> None:
        self.emit(to, body)

    # object-identity loopback (TcpSink): self-addressed protocol traffic
    # is delivered as the ORIGINAL message object on the next loop pass —
    # deferred, never reentrant into whatever is currently dispatching
    def deliver_local(self, request, msg_id) -> None:
        if threading.get_ident() != self._loop_tid:
            self.call_soon(lambda: self.deliver_local(request, msg_id))
            return
        self._local_q.append(
            lambda: self.node.receive(request, self.my_id, msg_id))

    def deliver_local_reply(self, reply_context, reply) -> None:
        if threading.get_ident() != self._loop_tid:
            self.call_soon(
                lambda: self.deliver_local_reply(reply_context, reply))
            return
        self._local_q.append(
            lambda: self.sink.deliver_reply(reply_context, self.my_id,
                                            reply))

    # ---------------------------------------------------------------- loop --
    def _run(self) -> None:
        prof_path = os.environ.get("ACCORD_TCP_PROFILE")
        if not prof_path:
            return self._run_loop()
        # profile the node's single dispatch thread (where all protocol
        # work happens) — the BASELINE host-tier binding-constraint
        # analysis reads these dumps
        import cProfile
        pr = cProfile.Profile()
        try:
            pr.runcall(self._run_loop)
        finally:
            pr.dump_stats(f"{prof_path}.{self.my_id}")

    def _run_loop(self) -> None:
        self._loop_tid = threading.get_ident()
        try:
            while self.running:
                self._tick()
        finally:
            self._shutdown_sockets()

    def mark_dirty(self, lane: _PeerLane) -> None:
        self._dirty.append(lane)

    def _flush_due(self, now: Optional[float] = None) -> None:
        """Flush every lane whose coalescing tick has elapsed.  Called
        after EVERY dispatched body (not just at pass end): a long burst
        must not stretch the egress hold beyond the configured tick — the
        buffer's latency contribution is bounded by the knob, period."""
        dirty = self._dirty
        if not dirty:
            return
        if not self.flush_tick_us:
            self._dirty = []
            for lane in dirty:
                lane.flush()
            return
        if now is None:
            now = time.monotonic()
        keep = []
        for lane in dirty:
            if lane.flush_at is None:
                continue
            if lane.flush_at <= now:
                lane.flush()
            else:
                keep.append(lane)
        self._dirty = keep

    def _tick(self) -> None:
        t_start = time.perf_counter()
        # 1. due timers run BEFORE blocking: a due-now deadline must never
        #    be floored into a sleep (the old loop's `or 0.01` cost 10ms
        #    of timer latency exactly when a deadline was already due).
        #    Timers emit too (RPC timeouts, pipeline batch dispatch):
        #    flush what they produced.
        ran_timers = self.scheduler.run_due()
        if ran_timers:
            self._flush_due()

        # 2. cross-thread calls (submits, WAL-released replies)
        work = False
        while self._calls:
            work = True
            self._safe(self._calls.popleft())
        if work:
            self._flush_due()

        # 3. poll: the nearest timer deadline is the timeout; pending
        #    local work polls without blocking.  About to go IDLE with
        #    frames still held open? Nothing else is coming that could
        #    join them — flush now, so the coalescing tick only ever
        #    delays frames while a burst is actually in progress.
        timeout = self._poll_timeout(work)
        if timeout > 0.0 and self._dirty:
            self._flush_all()
        busy_pre = time.perf_counter() - t_start
        try:
            events = self.selector.select(timeout)
        except OSError:
            return  # selector torn down under us during shutdown
        t_resume = time.perf_counter()

        # 4. IO: collect every complete inbound frame this pass produced
        #    (plus deferred loopback deliveries), then dispatch the burst
        #    under one sink coalescing window (pipeline mode) so
        #    same-destination fan-out amortises
        items: List = []
        # QoS priority lane: within one select pass's burst, bulk-tier
        # client submits are dispatched AFTER everything else — protocol
        # messages (they advance already-admitted txns, including the
        # high class's rounds) and high-class submits must not queue
        # behind an overload flood's decode+nack work.  Order within
        # each lane is preserved; with QoS off the single FIFO is
        # untouched.
        bulk: List = []

        def _enqueue(src: int, body: dict) -> None:
            if (self.qos is not None and body.get("type") == "submit"
                    and body.get("priority") != "high"):
                bulk.append(lambda s=src, b=body: self._dispatch(s, b))
            else:
                items.append(lambda s=src, b=body: self._dispatch(s, b))

        for key, mask in events:
            kind, payload = key.data
            if kind == "wake":
                try:
                    self._wake_r.recv(4096)
                except (BlockingIOError, OSError):
                    pass
            elif kind == "accept":
                self._accept()
            elif kind == "peer":
                payload.on_io(mask)
            elif kind == "conn":
                frames = payload.read_frames()
                if frames is None:
                    self._drop_conn(payload)
                else:
                    for frame in frames:
                        src = frame.get("src", 0)
                        if "m" in frame:
                            for body in frame["m"]:
                                _enqueue(src, body)
                        else:
                            _enqueue(src, frame.get("body", {}))
        while self._local_q:
            items.append(self._local_q.popleft())
        # bounded bulk drain: at most _BULK_PER_PASS bulk submits join
        # this pass; the rest wait in the loop-owned backlog.  Keeps
        # every pass short under an overload flood so the selector (and
        # with it protocol messages, high submits, timers) is serviced
        # every few milliseconds — a deferred bulk submit is simply
        # admitted-or-nacked a pass or two later, which its retry_after
        # already accounts for.  The backlog feeds loop-health's
        # saturation signal below, so deferral itself raises pressure.
        if bulk:
            self._bulk_backlog.extend(bulk)
        if self._bulk_backlog:
            take = min(len(self._bulk_backlog), _BULK_PER_PASS)
            for _ in range(take):
                items.append(self._bulk_backlog.popleft())

        coalesce = self.pipeline is not None and len(items) > 1
        if coalesce:
            self.sink.batch_begin()
        try:
            for item in items:
                self._safe(item)
                # bounded egress hold: a reply produced by item #1 of a
                # 50-item burst leaves now, not after item #50
                self._flush_due()
        finally:
            if coalesce:
                self.sink.batch_flush()
        self._flush_due()
        if items or ran_timers or work:
            # loop health: busy time (blocking poll excluded), burst
            # length, and the backlog this pass left undrained — the
            # saturation signal (obs/cpuprof.LoopHealth); idle passes
            # record nothing
            self.loop_health.tick(
                busy_pre + (time.perf_counter() - t_resume), len(items),
                len(self._calls) + len(self._local_q)
                + len(self._bulk_backlog))

    def _flush_all(self) -> None:
        dirty, self._dirty = self._dirty, []
        for lane in dirty:
            lane.flush()

    def _poll_timeout(self, have_work: bool) -> float:
        if have_work or self._local_q or self._calls or self._bulk_backlog:
            return 0.0
        deadline = self.scheduler.next_deadline()
        return 0.2 if deadline is None \
            else min(max(0.0, deadline - time.monotonic()), 0.2)

    def _safe(self, fn) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — one bad frame/callback
            # must never kill the node's only loop thread.  stderr: the
            # parent reads stdout exactly once (the ready line) — a full
            # stdout pipe would block this, the node's ONLY thread
            import sys as _sys
            print(f"tcp host n{self.my_id} dispatch error: {e!r}",
                  file=_sys.stderr, flush=True)

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self.server.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            conn = _InConn(sock)
            try:
                self.selector.register(sock, selectors.EVENT_READ,
                                       ("conn", conn))
            except (KeyError, ValueError):
                pass

    def _drop_conn(self, conn: _InConn) -> None:
        self.unregister(conn.sock)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _shutdown_sockets(self) -> None:
        for key in list(self.selector.get_map().values()):
            kind, payload = key.data
            if kind == "conn":
                self._drop_conn(payload)
        for lane in self._out.values():
            lane.close()
        self._out.clear()
        try:
            self.selector.close()
        except OSError:
            pass

    # ----------------------------------------------------------- dispatch --
    def _dispatch(self, from_id: int, body: dict) -> None:
        kind = body.get("type")
        if kind == "submit":
            # client txn over the wire (multi-process bench/harness path)
            self._client_submit(from_id, body)
            return
        if kind == "metrics":
            # harness/client JSON snapshot fetch (bench.py records these
            # alongside its BENCH_HISTORY rows); client-endpoint src only
            if from_id <= 0:
                snapshot = self.node.obs.snapshot()
                snapshot["process"] = process_evidence(self.node)
                sup = self.shard_supervisor
                if sup is not None:
                    # each worker's last stats frame (the supervisor polls
                    # every 2 s): its stores live in its own process
                    snapshot["workers"] = {
                        str(shard): rsp.metrics
                        for shard, rsp in sorted(sup.stats_cache.items())}
                self.emit(from_id, {"type": "metrics_reply",
                                    "req": body.get("req"),
                                    "snapshot": snapshot})
            return
        if kind == "flight":
            # live forensics view over the frame transport: the node's
            # flight-recorder tail, or one trace id's events (the same
            # data the metrics endpoint serves at /flight?txn=)
            if from_id <= 0:
                flight = self.node.obs.flight
                txn = body.get("txn")
                events = (flight.for_trace(txn) if txn
                          else flight.tail(int(body.get("limit", 200))))
                self.emit(from_id, {
                    "type": "flight_reply", "req": body.get("req"),
                    "node": self.my_id,
                    "recorded_total": flight.recorded_total,
                    "events": [list(e) for e in events]})
            return
        if kind == "audit":
            # live replica-state audit view over the frame transport:
            # divergences, the last digest-round report, and the census
            # (same data the metrics endpoint serves at /audit)
            if from_id <= 0:
                view = (self.auditor.view() if self.auditor is not None
                        else {})
                self.emit(from_id, {"type": "audit_reply",
                                    "req": body.get("req"),
                                    "node": self.my_id, "audit": view})
            return
        if kind == "top":
            # live protocol-CPU waterfall + loop health over the frame
            # transport (obs/cpuprof.py; the same data the metrics
            # endpoint serves at /top); client-endpoint src only
            if from_id <= 0:
                self.emit(from_id, {"type": "top_reply",
                                    "req": body.get("req"),
                                    "node": self.my_id,
                                    "top": self.node.obs.cpu_view()})
            return
        if kind == "stop":
            # accept stop only from harness/client frames (non-positive
            # declared src).  NOTE: src is self-declared — this guards
            # against misdirected frames from well-behaved nodes, not
            # against a hostile peer (which could claim src 0).  This
            # transport is a localhost bench harness; real deployments
            # need authenticated connections before trusting any frame.
            if from_id <= 0:
                self.running = False
            return
        if kind == "epoch":
            # admin plane: propose a topology epoch (journaled before the
            # ack; gossips to every member, so ONE admin contact suffices)
            if from_id <= 0:
                self._admin_epoch(from_id, body)
            return
        if kind == "topology":
            # routing refresh for clients: the current topology spec
            if from_id <= 0:
                self.emit(from_id, {"type": "topology_reply",
                                    "req": body.get("req"),
                                    "node": self.my_id,
                                    "topology": self._topology_spec()})
            return
        if kind == "shards":
            # shard-worker runtime view: per-worker pid/generation/live
            # rows from the supervisor (empty when in-loop); the crash
            # nemesis uses the pids to aim its SIGKILL
            if from_id <= 0:
                sup = self.shard_supervisor
                self.emit(from_id, {"type": "shards_reply",
                                    "req": body.get("req"),
                                    "node": self.my_id,
                                    "shards": (sup.admin_view()
                                               if sup is not None else [])})
            return
        if kind == "drain":
            # admin plane: scale-in — fence, hand off, wait durability,
            # retire without losing an ack
            if from_id <= 0:
                self._admin_drain(from_id, body)
            return
        payload = body["payload"]
        if type(payload) is dict:
            # tree payload (JSON frame or Python-tier unpack): decode here;
            # the native ingress already delivered the message object.
            # Under ACCORD_CPU_PROFILE the decode lap is parked on the
            # profiler so the next dispatch attributes it (the native
            # tier's frame-level unpack shows in the loop tick gauge)
            prof = self.node.obs.cpuprof
            if prof.enabled:
                t0 = time.perf_counter()
                payload = decode_message(payload)
                prof.note_decode(time.perf_counter() - t0)
            else:
                payload = decode_message(payload)
        if "in_reply_to" in body:
            self.sink.deliver_reply(body["in_reply_to"], from_id, payload)
        else:
            self.node.receive(payload, from_id, body.get("msg_id"))

    # -------------------------------------------------------- admin plane --
    def _merge_peers(self, peers) -> None:
        """An epoch install's `peers` spec taught us addresses (a node
        joining in that epoch): merge them so lazily-created lanes can
        connect.  Specs may carry a 4th element (the peer's DC under a geo
        profile) — placement itself comes from the profile, so the tag is
        informational here.  Loop thread (installs arrive via dispatch)."""
        for spec in peers:
            nid, host, port = int(spec[0]), spec[1], int(spec[2])
            if nid != self.my_id:
                self.peers[nid] = (host, port)

    def _install_geo_wire(self, geo) -> None:
        """Config-service hook: a geo profile arrived on an EpochInstall
        frame (GeoProfile.to_wire form)."""
        from accord_tpu_torch.topology.geo import GeoProfile
        self.install_geo_profile(GeoProfile.from_wire(geo))

    def install_geo_profile(self, profile) -> None:
        """Install/replace the geo placement profile: per-peer egress
        delay shim (see _PeerLane.flush — frames wait out the nominal
        one-way delay on the loop's own timer heap, no `tc`, no root) and
        dc= labels on this node's coordination obs."""
        self.geo = profile
        dc = profile.dc_of(self.my_id)
        self.node.obs.set_dc(dc)
        self.flight.record("geo_install", None, (profile.name, dc))

    def _topology_spec(self) -> dict:
        topo = self.node.topology.current()
        return {"epoch": topo.epoch,
                "shards": [[s.range.start, s.range.end,
                            list(s.sorted_nodes)] for s in topo.shards]}

    def _admin_epoch(self, from_id: int, body: dict) -> None:
        """`{"type":"epoch","topology":{...}}`: build the EpochInstall and
        feed it through normal dispatch — journaled (has_side_effects)
        BEFORE the ack below, applied via the config service's immutable
        topology swap, then gossiped to every member."""
        from accord_tpu_torch.messages.admin import EpochInstall
        spec = body.get("topology", {})
        peers = spec.get("peers")
        geo = spec.get("geo")
        if geo:
            # JSON spec dict -> canonical wire tuples
            from accord_tpu_torch.topology.geo import GeoProfile
            geo = GeoProfile.from_spec(geo)
        install = EpochInstall(
            int(spec["epoch"]),
            [(s[0], s[1], tuple(s[2])) for s in spec["shards"]],
            peers=[tuple(p) for p in peers] if peers else None,
            geo=geo or None)
        self.node.receive(install, 0, None)

        def ack():
            # emit marshals back to the loop, so firing from the WAL
            # flush thread is safe
            self.emit(from_id, {"type": "epoch_ok", "req": body.get("req"),
                                "node": self.my_id,
                                "epoch": self.node.epoch})

        if self.wal is not None:
            # persist-before-ack: the install survives us.  sync_soon
            # keeps the loop thread free while the flush thread works —
            # a blocking wal.sync() here stalls every peer connection.
            self.wal.sync_soon(ack)
        else:
            ack()

    def _admin_drain(self, from_id: int, body: dict) -> None:
        """`{"type":"drain"}`: scale-in this node.  DrainBegin fences new
        client coordination (journaled: a crashed drainer comes back
        fenced) and tells peers to deprioritize us as a fetch source; then
        we wait for in-flight coordinations to settle, raise a GLOBAL_SYNC
        durability barrier over our ranges, and only then ack + DrainDone."""
        from accord_tpu_torch.messages.admin import DrainBegin, DrainDone
        node = self.node
        req = body.get("req")
        topology = node.topology.current()
        members = sorted(n for n in topology.nodes() if n != self.my_id)
        node.receive(DrainBegin(self.my_id), 0, None)
        for to in members:
            node.send(to, DrainBegin(self.my_id))
        deadline = time.monotonic() + float(body.get("timeout_s", 60.0))

        def finish(_v=None, failure=None):
            node.receive(DrainDone(self.my_id), 0, None)
            for to in members:
                node.send(to, DrainDone(self.my_id))

            def ack():
                # every acked write is on disk before we go; emit
                # marshals to the loop so the flush thread may fire this
                self.emit(from_id, {"type": "drain_ok", "req": req,
                                    "node": self.my_id,
                                    "durable": failure is None})

            if self.wal is not None:
                self.wal.sync_soon(ack)
            else:
                ack()

        def durability_barrier():
            owned = topology.ranges_for_node(self.my_id)
            if owned.is_empty:
                # the current epoch already moved everything away; older
                # in-flight work still needs the watermark — barrier all
                from accord_tpu_torch.primitives.keys import Ranges
                owned = Ranges([s.range for s in topology.shards])
            from accord_tpu_torch.coordinate.syncpoint import BarrierType, barrier
            barrier(node, owned, BarrierType.GLOBAL_SYNC) \
                .add_callback(finish)

        self._drain_wait_idle(durability_barrier, deadline)

    def _drain_wait_idle(self, then, deadline: float) -> None:
        """Hand off in-flight work: poll until nothing this node is
        coordinating remains (new client work is already fenced)."""
        if not self.node.coordinating or time.monotonic() >= deadline:
            then()
            return
        self.scheduler.once(0.05,
                            lambda: self._drain_wait_idle(then, deadline))

    def _client_submit(self, from_id: int, body: dict) -> None:
        req = body.get("req")
        if self.node.draining:
            # drain fence: never coordinated, safe for the client to remap
            # to another coordinator (openloop counts these as shed)
            self.emit(from_id, {"type": "submit_reply", "req": req,
                                "ok": False, "error": "draining",
                                "shed": True, "drained": True})
            return
        if self.qos is not None:
            # QoS outer ring: admission BEFORE journal append/coordination
            # state is spent — the nack is retriable by construction and
            # carries the backoff hint the client honors.  Under the
            # worker runtime the submit is also charged against its home
            # shard's (tenant, shard) sub-bucket — the shard the router
            # would dispatch it to, derived from the same key set
            shard = None
            if self.qos.n_shards:
                toks = (set(body.get("reads", []))
                        | {int(t) for t in body.get("appends", {})})
                if toks:
                    shard = self.node.command_stores.shard_of(Keys.of(*toks))
            nack = self.qos.admit(str(body.get("tenant") or ""),
                                  str(body.get("priority") or "normal"),
                                  shard=shard)
            if nack is not None:
                self.emit(from_id, {"type": "submit_reply", "req": req,
                                    "ok": False, "error": repr(nack),
                                    "shed": True, "qos": True,
                                    "reason": nack.reason,
                                    "retry_after_us": nack.retry_after_us})
                return
        want_phases = bool(body.get("phases"))

        def done(value, failure):
            from accord_tpu_torch.pipeline.backpressure import Rejected
            if self.qos is not None:
                # admitted op settled (either way): shrink the tier's
                # inflight backlog signal
                self.qos.op_done()
            reads = {}
            if failure is None and value is not None:
                reads = {k.token: list(v)
                         for k, v in value.read_values.items()}
            reply = {"type": "submit_reply", "req": req,
                     "ok": failure is None,
                     "error": repr(failure) if failure else None,
                     "reads": reads}
            if isinstance(failure, Rejected):
                # typed load-shed: never coordinated, safe to retry
                reply["shed"] = True
            if want_phases and failure is None and value is not None \
                    and getattr(value, "txn_id", None) is not None:
                # per-phase SLO attribution for the open-loop harness
                # (workload/openloop.py): the coordinator's span milestone
                # firsts ride back on the reply — timestamps are this
                # node's clock (time.time()-us, same machine as the
                # harness), so the client can join them against its
                # intended-start ledger without a second round trip
                from accord_tpu_torch.obs.spans import phase_firsts, trace_key
                span = self.node.obs.spans.get(trace_key(value.txn_id))
                reply["phases"] = [[ph, at]
                                   for ph, at in phase_firsts(span)]
            self.emit(from_id, reply)

        try:
            read_tokens = body.get("reads", [])
            appends = {int(t): v for t, v in body.get("appends", {}).items()}
            txn = _build_list_txn(read_tokens, appends,
                                  ephemeral=body.get("kind") == "ephemeral")
            self._coordinate(txn).add_callback(done)
        except BaseException as e:  # noqa: BLE001
            done(None, e)

    def _coordinate(self, txn: Txn):
        """Client txn entry: through the ingest pipeline when enabled."""
        if self.pipeline is not None:
            return self.pipeline.submit(txn)
        return self.node.coordinate(txn)

    # -------------------------------------------------------------- client --
    def submit(self, read_tokens, appends: Dict[int, int]) -> SubmitResult:
        """Client entry from ANY thread: list-register read/append txn."""
        result = SubmitResult()

        def run():
            try:
                txn = _build_list_txn(read_tokens, appends)
                self._coordinate(txn).add_callback(result._complete)
            except BaseException as e:  # noqa: BLE001 — the client must see
                result._complete(None, e)  # the real error, not a timeout

        self.call_soon(run)
        return result

    def close(self) -> None:
        self.running = False
        self._wakeup()
        if self.auditor is not None:
            self.auditor.stop()
        if self.shard_supervisor is not None:
            try:
                self.shard_supervisor.close()  # retire workers: final
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass           # fsync per band rides ShardRetire
        if self.wal is not None:
            try:
                self.wal.close()  # final fsync: nothing acked is lost
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        if self.metrics_server is not None:
            try:
                self.metrics_server.shutdown()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        try:
            self.server.close()
        except OSError:
            pass
        self.loop_thread.join(timeout=5.0)


# --------------------------------------------------- multi-process cluster --

def _free_ports(n: int):
    """Pre-select n distinct free localhost ports (bind-then-close; the
    tiny reuse race is acceptable for local harnesses)."""
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class TcpClusterClient:
    """Client endpoint (pseudo-node 0) for a cluster of OS-process TcpHost
    nodes: spawns the workers, speaks the same length-prefixed frame codec,
    and collects submit replies — SURVEY §5.8's comm backend driven
    end-to-end over real sockets with one GIL per node.

    `pin_cpus` maps node id -> cpu index: each worker process pins itself
    with sched_setaffinity before serving (the multicore bench lane's
    one-core-per-node discipline)."""

    def __init__(self, n_nodes: int = 3, n_shards: int = 4,
                 pin_cpus: Optional[Dict[int, int]] = None):
        import json as _json
        import queue
        import subprocess
        import sys as _sys
        ports = _free_ports(n_nodes + 1)
        self.peers = {i: ("127.0.0.1", ports[i]) for i in range(n_nodes + 1)}
        self.n_shards = n_shards
        # the founding membership: nodes added later (add_node) must build
        # the founders' epoch-1 topology, not one that includes themselves
        self._seed_ids = list(range(1, n_nodes + 1))
        # routing spec cache for owner_of (refresh_topology updates it)
        self.topology_spec: Optional[dict] = None
        self.server = socket.create_server(self.peers[0], reuse_port=False)
        self.inbox: "queue.Queue" = queue.Queue()
        self.running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()
        self.procs = []
        spec_peers = {str(i): list(p) for i, p in self.peers.items()}
        try:
            for i in range(1, n_nodes + 1):
                spec = {"id": i, "peers": spec_peers, "n_shards": n_shards}
                if pin_cpus and i in pin_cpus:
                    spec["cpu"] = pin_cpus[i]
                self.procs.append(subprocess.Popen(
                    [_sys.executable, "-m", "accord_tpu_torch.host.tcp",
                     _json.dumps(spec)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    text=True))
            # ready markers: {"id", "port", "native"} of each node
            self.ready = []
            for p in self.procs:
                line = p.stdout.readline()  # ready marker
                assert line.strip(), "tcp worker failed to start"
                self.ready.append(_json.loads(line))
        except BaseException:
            for p in self.procs:  # a failed spawn must not orphan the rest
                p.kill()
            raise
        self._out: Dict[int, socket.socket] = {}
        # one client endpoint may be driven from two threads (the open-loop
        # pacer and the reshard admin driver): serialize socket writes so
        # frames never interleave mid-write
        self._send_lock = threading.Lock()

    def _accept_loop(self) -> None:
        while self.running:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket) -> None:
        try:
            while self.running:
                frame = _recv_frame(conn)
                if frame is None:
                    return
                if "m" in frame:
                    # the node coalesces replies to this client endpoint
                    # exactly as it does to peers: unwrap per body
                    for body in frame["m"]:
                        self.inbox.put({"src": frame.get("src"),
                                        "body": body})
                else:
                    self.inbox.put(frame)
        except (OSError, ValueError):
            return

    def _send(self, to: int, body: dict) -> None:
        with self._send_lock:
            sock = self._out.get(to)
            if sock is None:
                sock = self._out[to] = socket.create_connection(
                    self.peers[to], timeout=10.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_frame(sock, {"src": 0, "body": body})

    def submit(self, to: int, reads, appends: Dict[int, int], req,
               ephemeral: bool = False, want_phases: bool = False,
               tenant: str = "", priority: str = "") -> None:
        body = {"type": "submit", "req": req, "reads": list(reads),
                "appends": {str(k): v for k, v in appends.items()}}
        if ephemeral:
            body["kind"] = "ephemeral"
        if want_phases:
            body["phases"] = True
        if tenant:
            body["tenant"] = tenant
        if priority:
            body["priority"] = priority
        self._send(to, body)

    def qos_backoff_us(self, reply_body: dict, attempt: int = 1,
                       rng=None) -> int:
        """Honor a QoS nack's `retry_after_us` hint with decorrelating
        jitter: hint * 2^(attempt-1), plus 0..50% extra so a shed burst of
        clients does not reconverge on the same instant."""
        base = int(reply_body.get("retry_after_us") or 10_000)
        base = min(2_000_000, base * (2 ** max(0, attempt - 1)))
        if rng is None:
            import random as _random
            rng = _random
        return base + int(rng.random() * 0.5 * base)

    def recv(self, timeout_s: float = 30.0) -> Optional[dict]:
        import queue
        try:
            return self.inbox.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def fetch_metrics(self, to: int, timeout_s: float = 15.0
                      ) -> Optional[dict]:
        """Pull node `to`'s obs snapshot over the frame transport (use only
        when no submit replies are outstanding — stray frames between the
        request and its reply are consumed and dropped)."""
        req = f"metrics-{to}"
        try:
            self._send(to, {"type": "metrics", "req": req})
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            frame = self.recv(min(1.0, timeout_s))
            if frame is None:
                continue
            body = frame.get("body", {})
            if body.get("type") == "metrics_reply" and body.get("req") == req:
                return body.get("snapshot")
        return None

    def fetch_flight(self, to: int, txn=None, limit: int = 200,
                     timeout_s: float = 15.0) -> Optional[dict]:
        """Pull node `to`'s flight-recorder view over the frame transport
        (same quiet-channel caveat as fetch_metrics)."""
        req = f"flight-{to}"
        frame = {"type": "flight", "req": req, "limit": limit}
        if txn is not None:
            frame["txn"] = txn
        try:
            self._send(to, frame)
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "flight_reply" and body.get("req") == req:
                return body
        return None

    def fetch_audit(self, to: int, timeout_s: float = 15.0
                    ) -> Optional[dict]:
        """Pull node `to`'s replica-state audit view over the frame
        transport (same quiet-channel caveat as fetch_metrics)."""
        req = f"audit-{to}"
        try:
            self._send(to, {"type": "audit", "req": req})
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "audit_reply" and body.get("req") == req:
                return body.get("audit")
        return None

    def fetch_top(self, to: int, timeout_s: float = 15.0) -> Optional[dict]:
        """Pull node `to`'s protocol-CPU top-verbs waterfall + loop-health
        view over the frame transport (same quiet-channel caveat as
        fetch_metrics)."""
        req = f"top-{to}"
        try:
            self._send(to, {"type": "top", "req": req})
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "top_reply" and body.get("req") == req:
                return body.get("top")
        return None

    # ------------------------------------------------------ live elasticity --
    def fetch_topology(self, to: int, timeout_s: float = 15.0
                       ) -> Optional[dict]:
        """Pull node `to`'s current topology spec over the frame transport
        (same quiet-channel caveat as fetch_metrics)."""
        req = f"topology-{to}-{time.monotonic_ns()}"
        try:
            self._send(to, {"type": "topology", "req": req})
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "topology_reply" \
                    and body.get("req") == req:
                return body.get("topology")
        return None

    def refresh_topology(self, contact: int = 1,
                         timeout_s: float = 15.0) -> Optional[dict]:
        """Re-learn routing after a reshard: without this the client keeps
        submitting against the pre-reshard ownership map forever (the
        static-topology caching bug the elasticity lane pins)."""
        spec = self.fetch_topology(contact, timeout_s=timeout_s)
        if spec is not None:
            self.topology_spec = spec
        return spec

    def owner_of(self, token: int) -> int:
        """First replica of the shard owning `token` under the freshest
        topology spec this client fetched (node 1 before any refresh)."""
        spec = self.topology_spec
        if spec:
            for start, end, nodes in spec["shards"]:
                if start <= token < end and nodes:
                    return nodes[0]
        return 1

    def install_epoch(self, epoch: int, shards, peers=None, contact: int = 1,
                      timeout_s: float = 30.0, geo=None) -> Optional[dict]:
        """Admin-plane epoch proposal: `shards` is [[start, end, [nodes]],
        ...], `peers` optionally [[id, host, port], ...] (a 4th element
        tags the peer's DC) for members joining in this epoch; `geo`
        optionally ships a whole GeoProfile (or its to_spec dict) so one
        contact installs the latency matrix cluster-wide.  The install is
        journaled there before the ack and gossips to every member."""
        req = f"epoch-{epoch}-{contact}"
        topo = {"epoch": int(epoch),
                "shards": [[int(s), int(e), [int(n) for n in nodes]]
                           for s, e, nodes in shards]}
        if peers:
            topo["peers"] = [[int(p[0]), str(p[1]), int(p[2])]
                             + ([str(p[3])] if len(p) > 3 else [])
                             for p in peers]
        if geo is not None:
            topo["geo"] = geo.to_spec() if hasattr(geo, "to_spec") else geo
        self._send(contact, {"type": "epoch", "req": req, "topology": topo})
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "epoch_ok" and body.get("req") == req:
                return body
        return None

    def wait_epoch(self, epoch: int, nodes=None,
                   timeout_s: float = 30.0) -> bool:
        """Poll topology frames until every node in `nodes` (default: all)
        reports `epoch` (installed via gossip/fetch, one admin contact)."""
        remaining = set(nodes if nodes is not None
                        else range(1, len(self.procs) + 1))
        deadline = time.monotonic() + timeout_s
        while remaining and time.monotonic() < deadline:
            for n in sorted(remaining):
                spec = self.fetch_topology(n, timeout_s=5.0)
                if spec is not None and spec.get("epoch", 0) >= epoch:
                    remaining.discard(n)
            if remaining:
                time.sleep(0.1)
        return not remaining

    def add_node(self, cpu: Optional[int] = None) -> int:
        """Spawn a fresh journal-backed worker joining the live cluster.
        It builds the founders' epoch-1 topology (owning nothing) and only
        acquires ranges once an installed epoch assigns them — at which
        point it bootstraps over this same transport.  Returns its id."""
        import json as _json
        import subprocess
        import sys as _sys
        node_id = len(self.procs) + 1  # ids stay contiguous for close()
        (port,) = _free_ports(1)
        self.peers[node_id] = ("127.0.0.1", port)
        spec_peers = {str(i): list(p) for i, p in self.peers.items()}
        spec = {"id": node_id, "peers": spec_peers,
                "n_shards": self.n_shards,
                "topology_ids": list(self._seed_ids)}
        if cpu is not None:
            spec["cpu"] = cpu
        proc = subprocess.Popen(
            [_sys.executable, "-m", "accord_tpu_torch.host.tcp",
             _json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.procs.append(proc)
        line = proc.stdout.readline()  # ready marker
        assert line.strip(), "tcp worker failed to start"
        return node_id

    def peer_specs(self, ids=None):
        """[[id, host, port], ...] for an install_epoch peers field."""
        return [[i, self.peers[i][0], self.peers[i][1]]
                for i in (ids if ids is not None else sorted(
                    n for n in self.peers if n > 0))]

    def drain_node(self, node_id: int,
                   timeout_s: float = 60.0) -> Optional[dict]:
        """Retire `node_id`: fence new coordination there, let in-flight
        work hand off, wait the durability watermark, then ack."""
        req = f"drain-{node_id}"
        try:
            self._send(node_id, {"type": "drain", "req": req,
                                 "timeout_s": timeout_s})
        except OSError:
            return None
        deadline = time.monotonic() + timeout_s + 10.0
        while time.monotonic() < deadline:
            got = self.recv(min(1.0, timeout_s))
            if got is None:
                continue
            body = got.get("body", {})
            if body.get("type") == "drain_ok" and body.get("req") == req:
                return body
        return None

    def kill_node(self, node_id: int) -> None:
        """Process-death nemesis arm: SIGKILL the worker (its journal
        survives; restart_node brings it back from the WAL)."""
        self.procs[node_id - 1].kill()
        self.procs[node_id - 1].wait(timeout=10.0)
        # _out is shared with pacer/reshard-driver threads calling _send:
        # drop the lane under the same lock or a concurrent submit can
        # resurrect the dead socket mid-close
        with self._send_lock:
            sock = self._out.pop(node_id, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def restart_node(self, node_id: int,
                     topology_ids=None) -> None:
        """Respawn a killed worker on its original port: it replays its
        journal (epoch installs + bootstrap checkpoints included) before
        serving, resuming any interrupted bootstrap from the checkpointed
        coverage."""
        import json as _json
        import subprocess
        import sys as _sys
        spec_peers = {str(i): list(p) for i, p in self.peers.items()}
        spec = {"id": node_id, "peers": spec_peers,
                "n_shards": self.n_shards,
                "topology_ids": list(topology_ids if topology_ids is not None
                                     else self._seed_ids)}
        proc = subprocess.Popen(
            [_sys.executable, "-m", "accord_tpu_torch.host.tcp",
             _json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.procs[node_id - 1] = proc
        line = proc.stdout.readline()
        assert line.strip(), "tcp worker failed to restart"

    def close(self) -> None:
        for i in range(1, len(self.procs) + 1):
            try:
                self._send(i, {"type": "stop"})
            except OSError:
                pass
        self.running = False
        try:
            self.server.close()
        except OSError:
            pass
        with self._send_lock:
            socks = list(self._out.values())
            self._out.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=5.0)
            except Exception:
                p.kill()


def main() -> None:
    """Worker-process entry: python -m accord_tpu_torch.host.tcp '<spec json>'
    with spec = {"id": N, "peers": {"0": [host, port], ...}, "n_shards": S,
    "cpu": optional core to pin to}.  Prints one ready line (its realised
    port), serves until a stop frame."""
    import json as _json
    import sys as _sys
    spec = _json.loads(_sys.argv[1])
    cpu = spec.get("cpu")
    if cpu is not None and hasattr(os, "sched_setaffinity"):
        try:
            os.sched_setaffinity(0, {int(cpu)})
        except OSError:
            pass  # fewer cores than nodes: scheduling still works
    peers = {int(k): tuple(v) for k, v in spec["peers"].items()}
    host = TcpHost(spec["id"], peers, rf=spec.get("rf"),
                   n_shards=spec.get("n_shards", 4),
                   topology_ids=spec.get("topology_ids"))
    hold_off_full_collections()
    print(_json.dumps({"id": spec["id"],
                       "port": host.peers[spec["id"]][1],
                       "native": native_tiers()}), flush=True)

    def parent_watch():
        # the spawner holds our stdin pipe: EOF means it is gone — exit
        # rather than serve forever as an orphan
        _sys.stdin.read()
        host.running = False
        host._wakeup()

    threading.Thread(target=parent_watch, daemon=True).start()
    try:
        while host.running:
            time.sleep(0.05)
    finally:
        host.close()


if __name__ == "__main__":
    main()
