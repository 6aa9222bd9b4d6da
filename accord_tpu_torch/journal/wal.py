"""Per-node write-ahead log with group commit.

Every `has_side_effects` request is appended (Node._process journals before
processing, so the append precedes the ack by construction); durability is
certified by fsync.  Two modes:

  * group commit (fsync_window_us > 0, hosts): `append` enqueues and
    returns immediately; a flush thread coalesces everything that arrives
    within a deadline/batch-bounded window — the same micro-batch
    discipline as the ingest pipeline (pipeline/ingest.py, whose default
    window this one mirrors) — into ONE segment write + ONE fsync.  Acks
    are released by DurableAckSink once the covering fsync lands, so a
    window's worth of transactions shares one fsync instead of paying one
    each.
  * synchronous (fsync_window_us == 0): `append` writes and syncs inline —
    the fsync-per-append baseline the bench lane compares against, and the
    deterministic mode the sim's crash-restart nemesis runs (no threads;
    the sim only simulates PROCESS death, so `fsync=False` there skips the
    physical disk barrier while keeping write-before-ack ordering exact).

Observability: `accord_journal_*` registry metrics (appends, bytes, fsyncs,
group-commit batch-size histogram, rotations, snapshots) and flight-ring
events (journal_append / journal_rotate / journal_snapshot) ride the node's
obs facade; burn `--metrics` and bench rows surface them via
obs/report.summarize.
"""

from __future__ import annotations

import heapq
import json
import os
import threading
import time
from typing import Dict, List, Optional

from accord_tpu_torch.journal.segment import (SegmentWriter, fsync_dir,
                                        list_segments, read_segment,
                                        segment_name)

SNAPSHOT_NAME = "snapshot.snap"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class JournalConfig:
    """Knobs (env-overridable on hosts; README "Durability & crash-restart").

    fsync_window_us defaults to the ingest pipeline's micro-batch window
    (ACCORD_PIPELINE_MAX_WAIT_US default 2000): a batch admitted together is
    then typically made durable by one shared fsync."""

    def __init__(self, directory: str, segment_bytes: int = 4 << 20,
                 fsync_window_us: int = 2000, max_batch: int = 256,
                 snapshot_segments: int = 4, fsync: bool = True,
                 verify_compaction: bool = True, stall_us: int = 0,
                 stall_after: int = 0):
        self.directory = directory
        self.segment_bytes = max(4096, segment_bytes)
        self.fsync_window_us = max(0, fsync_window_us)
        self.max_batch = max(1, max_batch)
        # compact once this many CLOSED segments accumulate behind the
        # active one (0 disables snapshotting)
        self.snapshot_segments = snapshot_segments
        self.fsync = fsync
        self.verify_compaction = verify_compaction
        # fsync-stall injection (the SLO harness's durability-tier arm):
        # once `stall_after` appends have landed, the FLUSH THREAD sleeps
        # `stall_us` exactly once before its next fsync — a stuck disk as
        # the ack path observes it (durability-gated replies back up behind
        # the stalled group commit; open-loop latency charges the stall)
        self.stall_us = max(0, stall_us)
        self.stall_after = max(0, stall_after)

    @property
    def group_commit(self) -> bool:
        return self.fsync_window_us > 0

    @classmethod
    def from_env(cls, directory: str) -> "JournalConfig":
        return cls(
            directory,
            segment_bytes=_env_int("ACCORD_JOURNAL_SEGMENT_BYTES", 4 << 20),
            fsync_window_us=_env_int("ACCORD_JOURNAL_FSYNC_US", 2000),
            max_batch=_env_int("ACCORD_JOURNAL_MAX_BATCH", 256),
            snapshot_segments=_env_int("ACCORD_JOURNAL_SNAPSHOT_SEGMENTS",
                                       4),
            stall_us=_env_int("ACCORD_JOURNAL_STALL_US", 0),
            stall_after=_env_int("ACCORD_JOURNAL_STALL_AFTER", 0))

    def __repr__(self):
        return (f"JournalConfig({self.directory!r} "
                f"segment_bytes={self.segment_bytes} "
                f"fsync_window_us={self.fsync_window_us} "
                f"max_batch={self.max_batch})")


def encode_record(request) -> bytes:
    from accord_tpu_torch.host.wire import encode_message
    return json.dumps(encode_message(request),
                      separators=(",", ":")).encode()


def decode_record(payload: bytes):
    from accord_tpu_torch.host.wire import decode_message
    return decode_message(json.loads(payload.decode()))


class WriteAheadLog:
    """One node's durable journal over a directory of segments + snapshot.

    Drop-in for the sim journal's record/for_node surface (Node._process
    calls `journal.record(node_id, request)`), plus the durability plumbing
    DurableAckSink and the bench lane use (`append`/`wait_durable`/
    `on_durable`)."""

    def __init__(self, directory: str, node_id: int = 0,
                 config: Optional[JournalConfig] = None, registry=None,
                 flight=None, retain: bool = True):
        self.directory = directory
        self.node_id = node_id
        self.config = config if config is not None else JournalConfig(directory)
        os.makedirs(directory, exist_ok=True)
        self.flight = flight
        if registry is None:
            from accord_tpu_torch.obs.registry import Registry
            registry = Registry()
        self.registry = registry
        self._c_appends = registry.counter("accord_journal_appends_total")
        self._c_bytes = registry.counter("accord_journal_append_bytes_total")
        self._c_fsync = registry.counter("accord_journal_fsync_total")
        self._c_rotate = registry.counter("accord_journal_rotations_total")
        self._c_snapshots = registry.counter("accord_journal_snapshots_total")
        self._c_stalls = registry.counter("accord_journal_stall_total")
        self._h_batch = registry.histogram("accord_journal_group_commit_batch")
        # one-shot fsync-stall injection armed by config (SLO stall arm)
        self._stall_pending = self.config.stall_us > 0
        # retain=True keeps every appended request in memory so the sim's
        # journal validator can fold for_node() without re-reading disk;
        # hosts pass retain=False (they never fold, and must not grow
        # without bound)
        self._retain = retain
        self._retained: List[object] = []
        self._lock = threading.Lock()
        # two conditions on one lock: appends wake only the flusher
        # (notify(1) on _work), the flusher's fsync wakes only durability
        # waiters (notify_all on _durable_cv) — one shared condition would
        # thundering-herd every blocked appender on every append
        self._work = threading.Condition(self._lock)
        self._durable_cv = threading.Condition(self._lock)
        self._seq = 0
        self.durable_seq = 0
        self._buffer: List[tuple] = []       # (seq, payload, enqueued_mono)
        self._on_durable: List[tuple] = []   # heap of (seq, tie, fn)
        self._tie = 0
        self._closing = False
        segs = list_segments(directory)
        self._index = segs[-1][0] if segs else 0
        # the writer opens lazily on the first write: load_records must be
        # able to truncate a torn tail (and drop snapshot-covered segments)
        # before an appender holds the file open
        self._writer: Optional[SegmentWriter] = None
        self._flusher = None
        if self.config.group_commit:
            self._flusher = threading.Thread(target=self._flush_loop,
                                             daemon=True)
            self._flusher.start()

    # ---------------------------------------------------------------- load --
    def load_records(self) -> List[object]:
        """Decode snapshot + surviving segment records (torn tails truncated
        in place), ready for replay.  Segments wholly covered by the
        snapshot (a crash between snapshot rename and segment unlink can
        leave some) are deleted, not double-replayed."""
        from accord_tpu_torch.journal.snapshot import read_snapshot
        out: List[object] = []
        covers = -1
        snap_path = os.path.join(self.directory, SNAPSHOT_NAME)
        if os.path.exists(snap_path):
            covers, msgs = read_snapshot(snap_path)
            out.extend(msgs)
        for idx, path in list_segments(self.directory):
            if idx <= covers:
                os.unlink(path)
                continue
            for payload in read_segment(path, truncate=True):
                out.append(decode_record(payload))
        if covers >= self._index:
            # every segment was covered: the next one must NOT reuse a
            # covered index, or a later open would skip its records
            self._index = covers + 1
        if self._retain:
            self._retained.extend(out)
        return out

    # -------------------------------------------------------------- append --
    @property
    def last_seq(self) -> int:
        return self._seq

    def queue_depth(self) -> int:
        """Group-commit backlog: records appended but not yet handed to the
        flush batch.  Read lock-free from the QoS pressure controller (loop
        thread) — `len` of a list is atomic under the GIL and an off-by-a-
        few stale read only nudges a normalized pressure contribution, so
        the flush thread's mutations need no coordination here."""
        return len(self._buffer)

    def append(self, request) -> int:
        """Journal one side-effecting request; returns its sequence number.
        Durable once `durable_seq` reaches it (immediately in sync mode)."""
        payload = encode_record(request)
        with self._lock:
            self._seq += 1
            seq = self._seq
            if self._retain:
                self._retained.append(request)
            if self.config.group_commit:
                self._buffer.append((seq, payload, time.monotonic()))
                self._work.notify()
                return seq
            self._write_batch([(seq, payload)])
            self._mark_durable(seq)
        self._fire_due_callbacks()
        return seq

    # sim/journal.Journal surface (Node._process, validate_node)
    def record(self, node_id: int, request) -> None:
        self.append(request)

    def for_node(self, node_id: int) -> List[object]:
        return list(self._retained)

    # ---------------------------------------------------------- durability --
    def wait_durable(self, seq: int, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._durable_cv:
            while self.durable_seq < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._durable_cv.wait(remaining)
        return True

    def on_durable(self, seq: int, fn) -> None:
        """Run `fn` once `seq` is durable (inline when it already is).
        Fired from the flush thread in group-commit mode."""
        with self._lock:
            if self.durable_seq < seq:
                self._tie += 1
                heapq.heappush(self._on_durable, (seq, self._tie, fn))
                return
        fn()

    def _mark_durable(self, seq: int) -> None:
        # lock held
        self.durable_seq = seq
        self._durable_cv.notify_all()

    def _pop_due_callbacks(self) -> List:
        # lock held
        due = []
        while self._on_durable and self._on_durable[0][0] <= self.durable_seq:
            due.append(heapq.heappop(self._on_durable)[2])
        return due

    def _fire_due_callbacks(self) -> None:
        with self._lock:
            due = self._pop_due_callbacks()
        for fn in due:
            fn()

    # --------------------------------------------------------------- write --
    def _write_batch(self, items) -> None:
        """Append `items` frames and certify them with one fsync (rotating
        first when the active segment is full).  Single-writer: the flush
        thread in group-commit mode, the appender (under the lock) in sync
        mode."""
        if self._writer is None:
            self._writer = SegmentWriter(
                os.path.join(self.directory, segment_name(self._index)))
        rotated = False
        nbytes = 0
        for seq, payload in items:
            if self._writer.size >= self.config.segment_bytes:
                self._rotate()
                rotated = True
            nbytes += self._writer.append(payload)
            if self.flight is not None:
                self.flight.record("journal_append", None, (seq, len(payload)))
        if self.config.fsync:
            self._writer.sync()
        else:
            self._writer.flush()
        self._c_fsync.inc()
        self._c_appends.inc(len(items))
        self._c_bytes.inc(nbytes)
        self._h_batch.observe(len(items))
        if rotated:
            self._maybe_compact()

    def _rotate(self) -> None:
        self._writer.close(sync=self.config.fsync)
        self._index += 1
        self._writer = SegmentWriter(
            os.path.join(self.directory, segment_name(self._index)))
        fsync_dir(self.directory)
        self._c_rotate.inc()
        if self.flight is not None:
            self.flight.record("journal_rotate", None, (self._index,))

    def _maybe_compact(self) -> None:
        if not self.config.snapshot_segments:
            return
        closed = [s for s in list_segments(self.directory)
                  if s[0] < self._index]
        if len(closed) < self.config.snapshot_segments:
            return
        from accord_tpu_torch.journal.snapshot import compact
        stats = compact(self.directory, upto_index=self._index - 1,
                        verify=self.config.verify_compaction,
                        fsync=self.config.fsync)
        self._c_snapshots.inc()
        if self.flight is not None:
            self.flight.record("journal_snapshot", None,
                               (stats.records_in, stats.records_out,
                                stats.segments_retired))

    # ----------------------------------------------------------- flush loop --
    def _flush_loop(self) -> None:
        cfg = self.config
        window_s = cfg.fsync_window_us / 1e6
        while True:
            with self._work:
                while not self._buffer and not self._closing:
                    self._work.wait(0.1)
                if not self._buffer and self._closing:
                    return
                # group-commit window: anchored to the OLDEST buffered
                # append, closed early when the batch bound is hit OR when
                # a whole window slice passes with no new arrivals — with
                # durability-gated clients everyone who can append is then
                # blocked on this very fsync, so further waiting only adds
                # latency (the ingest pipeline's adaptive-deadline
                # discipline, pipeline/ingest.py)
                deadline = self._buffer[0][2] + window_s
                idle_slice = window_s / 8
                last_depth = len(self._buffer)
                while (len(self._buffer) < cfg.max_batch
                       and not self._closing):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._work.wait(min(idle_slice, remaining))
                    if len(self._buffer) == last_depth:
                        break  # a full slice brought nothing new
                    last_depth = len(self._buffer)
                batch, self._buffer = self._buffer, []
            if self._stall_pending and batch \
                    and batch[-1][0] >= cfg.stall_after:
                # injected fsync stall (config.stall_us): the flush thread
                # — not the coordinator door — wedges, so everything
                # durability-gated behind this window queues up exactly as
                # it would behind a stuck disk
                self._stall_pending = False
                self._c_stalls.inc()
                time.sleep(cfg.stall_us / 1e6)
            self._write_batch([(seq, payload) for seq, payload, _ in batch])
            with self._lock:
                self._mark_durable(batch[-1][0])
                due = self._pop_due_callbacks()
            for fn in due:
                fn()

    # ----------------------------------------------------------- lifecycle --
    def sync(self, timeout_s: float = 30.0) -> bool:
        """Barrier: everything appended so far is durable on return."""
        with self._lock:
            seq = self._seq
        if not self.config.group_commit:
            return True
        with self._work:
            self._work.notify()
        return self.wait_durable(seq, timeout_s)

    def sync_soon(self, fn) -> None:
        """Non-blocking persist-before-ack: run `fn` once everything
        appended so far is durable.  Unlike `sync()` this never parks the
        calling thread — safe on the event loop.  `fn` runs inline when
        already durable, else from the flush thread; callers that touch
        loop state must marshal back themselves (host `emit` paths do)."""
        with self._lock:
            seq = self._seq
        if self.config.group_commit:
            with self._work:
                self._work.notify()
        self.on_durable(seq, fn)

    def close(self) -> None:
        self.sync()
        with self._lock:
            self._closing = True
            self._work.notify_all()
            self._durable_cv.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        if self._writer is not None:
            self._writer.close(sync=self.config.fsync)

    def __repr__(self):
        return (f"WriteAheadLog(n{self.node_id} {self.directory!r} "
                f"seq={self._seq} durable={self.durable_seq})")


class DurableAckSink:
    """MessageSink wrapper gating outbound REPLIES on the fsync watermark:
    a reply acking work journaled in the current group-commit window leaves
    only once that window's fsync lands (requests pass through — only acks
    certify durable state).  The conservative watermark (the log's last
    appended seq at reply time) can hold a read-only reply for at most one
    fsync window; per-request tracking isn't worth threading through every
    handler."""

    def __init__(self, inner, wal: WriteAheadLog):
        self._inner = inner
        self._wal = wal

    def send(self, to: int, request) -> None:
        self._inner.send(to, request)

    def send_with_callback(self, to: int, request, callback,
                           executor=None) -> None:
        self._inner.send_with_callback(to, request, callback,
                                       executor=executor)

    def reply(self, to: int, reply_context, reply) -> None:
        wal = self._wal
        seq = wal.last_seq
        if seq <= wal.durable_seq:
            self._inner.reply(to, reply_context, reply)
        else:
            wal.on_durable(
                seq, lambda: self._inner.reply(to, reply_context, reply))

    def __getattr__(self, name):
        # deliver_reply / batch_begin / batch_flush / msg-id bookkeeping all
        # belong to the wrapped sink
        return getattr(self._inner, name)


class DurableJournalSet:
    """Per-node WALs under one base directory — the sim cluster's durable
    stand-in for sim/journal.Journal (same record/for_node surface, so
    validate_cluster folds the on-disk journal).  Runs the WALs in
    synchronous mode: deterministic (no flush threads) and exact on
    write-before-ack ordering; `fsync=False` because the sim simulates
    PROCESS death — OS buffers survive the kill, so the physical disk
    barrier would only slow the burn."""

    def __init__(self, base_dir: str, fsync: bool = False):
        self.base_dir = base_dir
        self.fsync = fsync
        self.wals: Dict[int, WriteAheadLog] = {}

    def node_dir(self, node_id: int) -> str:
        return os.path.join(self.base_dir, f"node-{node_id}")

    def open_node(self, node_id: int, registry=None, flight=None,
                  load: bool = False) -> WriteAheadLog:
        cfg = JournalConfig(self.node_dir(node_id), fsync_window_us=0,
                            segment_bytes=256 << 10, fsync=self.fsync)
        wal = WriteAheadLog(self.node_dir(node_id), node_id=node_id,
                            config=cfg, registry=registry, flight=flight,
                            retain=True)
        self.wals[node_id] = wal
        return wal

    def close_node(self, node_id: int) -> None:
        wal = self.wals.pop(node_id, None)
        if wal is not None:
            wal.close()

    def close(self) -> None:
        for node_id in list(self.wals):
            self.close_node(node_id)

    # sim/journal.Journal surface
    def record(self, node_id: int, request) -> None:
        self.wals[node_id].append(request)

    def for_node(self, node_id: int) -> List[object]:
        wal = self.wals.get(node_id)
        return wal.for_node(node_id) if wal is not None else []
