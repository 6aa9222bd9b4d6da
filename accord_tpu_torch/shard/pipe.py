"""Length-prefixed frame I/O over the supervisor<->worker pipes.

Same 4-byte big-endian length prefix as the TCP transport's peer frames,
same structural codec (host/wire.py, native tier when present): a pipe
frame IS a wire frame, which is what lets test_wire_roundtrip.py pin the
shard frames on both codec tiers alongside peer traffic.

Threading contract: each end gives the pipe a dedicated READER thread that
only ever drains, so blocking writes (under `lock`) cannot deadlock — the
classic pipe-pair deadlock needs both ends blocked on write with both
buffers full, and a reader that always drains makes that state unreachable.
"""

from __future__ import annotations

import struct
from typing import Optional

from accord_tpu_torch.host.wire import decode_message, pack_frame, unpack_frame_obj

_LEN = struct.Struct(">I")


def write_frame(fp, lock, obj) -> None:
    """Pack and write one frame under `lock` (any thread)."""
    data = pack_frame(obj)
    with lock:
        fp.write(_LEN.pack(len(data)))
        fp.write(data)
        fp.flush()


def read_frame(fp) -> Optional[object]:
    """Blocking read of one decoded frame object; None on EOF/short read."""
    header = fp.read(_LEN.size)
    if len(header) < _LEN.size:
        return None
    (n,) = _LEN.unpack(header)
    data = fp.read(n)
    if len(data) < n:
        return None
    obj = unpack_frame_obj(data)
    # python-tier codec returns the tree; the native tier already decoded
    return decode_message(obj) if type(obj) is dict else obj
