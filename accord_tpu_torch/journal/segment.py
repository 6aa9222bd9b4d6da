"""Append-only journal segments: length+CRC32-framed records on disk.

One segment is a sequence of frames:

    [4-byte big-endian payload length][4-byte CRC32 of payload][payload]

The payload is opaque bytes to this layer (wal.py stores wire-codec JSON).
A crashed writer can leave a torn tail — a partial header, a partial
payload, or a payload whose CRC does not match (the write raced the crash).
`read_segment` stops at the first such frame and, when asked, truncates the
file back to the last whole record, so an append-after-recovery never
splices new records onto garbage bytes.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

_HEADER = struct.Struct(">II")  # (payload_len, crc32)

# a frame longer than this is treated as corruption, not a record: a torn
# header can otherwise decode as a multi-GB length and stall recovery on a
# doomed read
MAX_RECORD_BYTES = 64 << 20


def frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def scan_segment(path: str) -> Tuple[List[bytes], int, bool]:
    """Read whole records from `path`.  Returns (records, good_bytes,
    torn): `good_bytes` is the offset just past the last intact record and
    `torn` is True when trailing bytes past it had to be abandoned."""
    records: List[bytes] = []
    good = 0
    torn = False
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return records, 0, False
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if length > MAX_RECORD_BYTES or end > n:
            torn = True
            break
        payload = data[off + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            torn = True
            break
        records.append(payload)
        off = end
        good = off
    if not torn and off != n:
        torn = True  # partial header at the tail
    return records, good, torn


def read_frame_at(path: str, offset: int) -> bytes:
    """Read exactly ONE frame starting at `offset` — the point-read a
    fault-index hit performs, so a refault costs one seek + one frame, not
    a segment scan.  Raises ValueError on a bad offset, torn frame, or CRC
    mismatch: the caller (the pager) treats that as spill-tier corruption,
    never as a missing command."""
    with open(path, "rb") as f:
        f.seek(offset)
        header = f.read(_HEADER.size)
        if len(header) != _HEADER.size:
            raise ValueError(f"truncated frame header at {path}:{offset}")
        length, crc = _HEADER.unpack(header)
        if length > MAX_RECORD_BYTES:
            raise ValueError(f"oversized frame at {path}:{offset}")
        payload = f.read(length)
    if len(payload) != length:
        raise ValueError(f"truncated frame payload at {path}:{offset}")
    if zlib.crc32(payload) != crc:
        raise ValueError(f"frame CRC mismatch at {path}:{offset}")
    return payload


def read_segment(path: str, truncate: bool = True) -> List[bytes]:
    """Records of one segment; with `truncate`, a torn tail is cut back to
    the last intact record on disk (fsynced) so later appends are safe."""
    records, good, torn = scan_segment(path)
    if torn and truncate:
        with open(path, "r+b") as f:
            f.truncate(good)
            f.flush()
            os.fsync(f.fileno())
    return records


def fsync_dir(directory: str) -> None:
    """Durably record directory-level changes (created/renamed/unlinked
    files).  Best-effort: not every filesystem supports opening a dir."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class SegmentWriter:
    """One open segment file being appended to.  `append` buffers into the
    OS (write); `sync` makes everything appended so far durable (flush +
    fsync).  Group commit lives a layer up (wal.py): many appends, one
    sync."""

    def __init__(self, path: str):
        self.path = path
        # append mode: reopening after a torn-tail truncation must continue
        # at the truncated offset, not clobber the surviving records
        self._f = open(path, "ab")
        self.size = self._f.tell()

    def append(self, payload: bytes) -> int:
        """Write one frame; returns the frame's size in bytes (not yet
        durable until `sync`)."""
        buf = frame(payload)
        self._f.write(buf)
        self.size += len(buf)
        return len(buf)

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self, sync: bool = True) -> None:
        if self._f.closed:
            return
        if sync:
            self.sync()
        self._f.close()


def segment_name(index: int) -> str:
    return f"segment-{index:08d}.wal"


def segment_index(name: str) -> Optional[int]:
    if name.startswith("segment-") and name.endswith(".wal"):
        try:
            return int(name[len("segment-"):-len(".wal")])
        except ValueError:
            return None
    return None


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """(index, path) of every segment in `directory`, ascending."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        idx = segment_index(name)
        if idx is not None:
            out.append((idx, os.path.join(directory, name)))
    out.sort()
    return out
