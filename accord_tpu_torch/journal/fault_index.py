"""SpillStore: the paging tier's on-disk frame store + compaction-aware
fault index.

Reference: accord's Journal/CommandStore persistence seam — evicted command
state must be reloadable by identity without scanning history.  The node
WAL (wal.py) stays the crash-durability tier; this store is SCRATCH state
for one node incarnation: `local/paging.py` wipes it on attach and WAL
replay re-derives residency, so nothing here is ever the only copy of a
decided command.

Layout reuses the WAL's segment framing (segment.py): each eviction appends
one `SpillFrame` record and the in-memory fault index maps its TxnId to the
exact (segment, byte offset), so a refault is ONE point-read
(`read_frame_at`) — never a segment scan.  A fault or drop makes the frame
dead; when the dead fraction of the on-disk bytes crosses the compaction
threshold the live frames are rewritten into fresh segments and the index
is repointed (compaction-aware by construction).  `checkpoint()` appends a
`FaultIndexCheckpoint` so a clean-close reopen seeds the index from the
newest checkpoint and replays only the frames appended after it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from accord_tpu_torch.journal.segment import (SegmentWriter, fsync_dir,
                                        list_segments, read_frame_at,
                                        scan_segment, segment_name,
                                        _HEADER)
from accord_tpu_torch.journal.wal import decode_record, encode_record
from accord_tpu_torch.messages.paging import FaultIndexCheckpoint, SpillFrame

# rotate the active spill segment at this size (small enough that a
# compaction rewrite touches bounded I/O per segment)
SPILL_SEGMENT_BYTES = 8 << 20
# rewrite live frames once dead bytes exceed this fraction of the total …
COMPACT_DEAD_FRACTION = 0.5
# … but never bother below this floor (compaction churn on tiny stores)
COMPACT_MIN_BYTES = 1 << 20
# append a FaultIndexCheckpoint every N spills (0 disables)
CHECKPOINT_EVERY = 4096


class SpillStore:
    """On-disk spill frames + in-memory fault index for ONE CommandStore.

    Single-threaded like its owner (command stores are logically
    single-threaded); durability is NOT required — spill segments are
    never fsynced, because the WAL already owns crash durability and a
    torn spill tail only ever loses frames the next incarnation would
    have wiped anyway."""

    def __init__(self, directory: str, fresh: bool = True,
                 flight=None,
                 segment_bytes: int = SPILL_SEGMENT_BYTES,
                 checkpoint_every: int = CHECKPOINT_EVERY):
        self.directory = directory
        self.segment_bytes = segment_bytes
        self.checkpoint_every = checkpoint_every
        self._flight = flight
        # txn_id -> (segment_index, byte_offset) of the LIVE frame
        self.index: Dict = {}
        # segment_index -> total frame bytes present in that segment
        self._seg_bytes: Dict[int, int] = {}
        self._live_bytes = 0
        self._total_bytes = 0
        self._spills_since_checkpoint = 0
        # lifetime counters the pager exports
        self.frames_written = 0
        self.frames_faulted = 0
        self.frames_dropped = 0
        self.compactions = 0
        os.makedirs(directory, exist_ok=True)
        if fresh:
            self._wipe()
            self._active_index = 0
        else:
            self._active_index = self._rebuild()
        self._writer = SegmentWriter(self._path(self._active_index))
        self._seg_bytes.setdefault(self._active_index, self._writer.size)

    # ------------------------------------------------------------ paths --
    def _path(self, index: int) -> str:
        return os.path.join(self.directory, segment_name(index))

    def _wipe(self) -> None:
        for _idx, path in list_segments(self.directory):
            os.unlink(path)
        fsync_dir(self.directory)

    # ------------------------------------------------------------- write --
    def spill(self, command) -> Tuple[int, int]:
        """Append one command's SpillFrame; returns its (segment, offset).
        A txn already spilled is superseded in place: the old frame goes
        dead and the index repoints to the new one."""
        record = SpillFrame.from_command(command)
        payload = encode_record(record)
        txn_id = record.txn_id
        old = self.index.get(txn_id)
        seg, off = self._append(payload)
        self.index[txn_id] = (seg, off)
        self.frames_written += 1
        if old is not None:
            # superseded frame: its bytes are dead but unknown exactly —
            # approximate with the new frame's size (same command, same
            # quiescent payload shape)
            self._live_bytes -= _HEADER.size + len(payload)
        if self._flight is not None:
            self._flight.record("page_spill", str(txn_id),
                                (seg, off, len(payload)))
        self._spills_since_checkpoint += 1
        if self.checkpoint_every and \
                self._spills_since_checkpoint >= self.checkpoint_every:
            self.checkpoint()
        self._maybe_compact()
        return seg, off

    def _append(self, payload: bytes) -> Tuple[int, int]:
        if self._writer.size >= self.segment_bytes:
            self._writer.close(sync=False)
            self._active_index += 1
            self._writer = SegmentWriter(self._path(self._active_index))
            self._seg_bytes[self._active_index] = 0
        off = self._writer.size
        n = self._writer.append(payload)
        self._writer.flush()
        self._seg_bytes[self._active_index] += n
        self._live_bytes += n
        self._total_bytes += n
        return self._active_index, off

    # -------------------------------------------------------------- read --
    def fault(self, txn_id):
        """Point-read one spilled command back; the frame becomes dead and
        the index entry is removed (the resident copy is now the only
        truth — re-eviction re-spills current state)."""
        seg, off = self.index.pop(txn_id)
        payload = read_frame_at(self._sync_path(seg), off)
        record = decode_record(payload)
        if not isinstance(record, SpillFrame) or record.txn_id != txn_id:
            raise ValueError(
                f"fault index corruption: {txn_id} -> {seg}:{off} holds "
                f"{record!r}")
        self.frames_faulted += 1
        self._live_bytes -= _HEADER.size + len(payload)
        self._maybe_compact()
        return record.to_command()

    def _sync_path(self, seg: int) -> str:
        # reading the active segment must see its buffered appends
        if seg == self._active_index:
            self._writer.flush()
        return self._path(seg)

    def drop(self, txn_id) -> bool:
        """Discard a spilled entry without reading it (it went redundant
        while cold).  Returns whether it was present."""
        entry = self.index.pop(txn_id, None)
        if entry is None:
            return False
        self.frames_dropped += 1
        # dead-byte size unknown without a read; fold it into the dead
        # fraction via live-byte average
        n = len(self.index)
        self._live_bytes -= self._live_bytes // (n + 1)
        self._maybe_compact()
        return True

    def __contains__(self, txn_id) -> bool:
        return txn_id in self.index

    def __len__(self) -> int:
        return len(self.index)

    # ------------------------------------------------------- checkpoint --
    def checkpoint(self) -> None:
        """Append a FaultIndexCheckpoint covering the current append
        position, so a clean-close reopen seeds from it."""
        self._spills_since_checkpoint = 0
        entries = tuple(tid.pack() + (seg, off)
                        for tid, (seg, off) in self.index.items())
        record = FaultIndexCheckpoint(entries, self._active_index,
                                      self._writer.size)
        self._append(encode_record(record))

    def _rebuild(self) -> int:
        """Reopen path: seed the index from the newest checkpoint, then
        replay only frames appended after its covered position; falls back
        to a full scan when no checkpoint exists.  Returns the active
        segment index to continue appending into."""
        from accord_tpu_torch.primitives.timestamp import TxnId
        segments = list_segments(self.directory)
        if not segments:
            return 0
        # offset-tracked scan of every segment (spill stores are scratch,
        # so reopen is rare and bounded; the checkpoint trims the DECODE
        # cost, which dominates)
        frames = []  # (seg, off, payload)
        for seg, path in segments:
            off = 0
            records, good, _torn = scan_segment(path)
            for payload in records:
                frames.append((seg, off, payload))
                off += _HEADER.size + len(payload)
            self._seg_bytes[seg] = good
            self._total_bytes += good
        # newest checkpoint wins; tag-sniff the JSON head to avoid
        # decoding every spill frame just to find it
        ckpt = None
        ckpt_at = (-1, -1)
        for seg, off, payload in frames:
            if payload.startswith(b'{"$c":"FaultIndexCheckpoint"'):
                ckpt = decode_record(payload)
                ckpt_at = (ckpt.through_segment, ckpt.through_offset)
        if ckpt is not None:
            for msb, lsb, node, seg, off in ckpt.entries:
                self.index[TxnId.unpack(msb, lsb, node)] = (seg, off)
        for seg, off, payload in frames:
            if (seg, off) < ckpt_at:
                continue
            if payload.startswith(b'{"$c":"FaultIndexCheckpoint"'):
                continue
            record = decode_record(payload)
            if isinstance(record, SpillFrame):
                self.index[record.txn_id] = (seg, off)
        # live-byte estimate: index entries at average frame size
        if frames:
            avg = self._total_bytes // len(frames)
            self._live_bytes = min(self._total_bytes, avg * len(self.index))
        return segments[-1][0]

    # -------------------------------------------------------- compaction --
    def _maybe_compact(self) -> None:
        if self._total_bytes < COMPACT_MIN_BYTES:
            return
        dead = self._total_bytes - max(self._live_bytes, 0)
        if dead / self._total_bytes >= COMPACT_DEAD_FRACTION:
            self.compact()

    def compact(self) -> None:
        """Rewrite live frames into fresh segments and unlink the old
        ones; every index entry is repointed, so in-flight faults after
        compaction still read one frame."""
        self._writer.close(sync=False)
        old_paths = [path for _idx, path in list_segments(self.directory)]
        live = sorted(self.index.items(), key=lambda kv: kv[1])
        start = self._active_index + 1
        self._active_index = start
        self._writer = SegmentWriter(self._path(start))
        self._seg_bytes = {start: 0}
        self._live_bytes = 0
        self._total_bytes = 0
        for txn_id, (seg, off) in live:
            payload = read_frame_at(self._path(seg), off)
            self.index[txn_id] = self._append(payload)
        self._writer.flush()
        for path in old_paths:
            os.unlink(path)
        fsync_dir(self.directory)
        self.compactions += 1
        if self.checkpoint_every:
            self.checkpoint()

    # ------------------------------------------------------------- close --
    @property
    def disk_bytes(self) -> int:
        return self._total_bytes

    def close(self, final_checkpoint: bool = True) -> None:
        if final_checkpoint and self.checkpoint_every:
            self.checkpoint()
        self._writer.close(sync=False)
