"""Snapshot compaction: fold retired segments into one compact file.

Compaction rewrites the journal's tail-heavy history into its minimal
equivalent: all records of the snapshot plus every CLOSED segment are folded
per transaction — duplicates (retransmissions, per-store redeliveries)
collapse to one copy, and messages wholly subsumed by a maximal Apply are
dropped — then written to a fresh snapshot file (tmp + fsync + atomic
rename) and the covered segments deleted.

The fold is ORDER-INSENSITIVE and is verified against the validator's own
reconstruction fold (sim/journal.reconstruct): a transaction's folded
message set must yield bit-identical reconstructed knowledge (definition
keys, executeAts, accept evidence, stable dep ids, outcome, invalidation)
or the fold for that transaction reverts to the unfolded set.  Compaction
can therefore never weaken what a crash-restart replay can rebuild.

Replay order within a transaction follows protocol bands (PreAccept <
Accept < Commit < Apply < Propagate), so a restart replays each txn's
messages in the order its handlers expect regardless of arrival order.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from accord_tpu_torch.journal.segment import (frame, fsync_dir, list_segments,
                                        read_segment, scan_segment)

_META_KEY = "__accord_snapshot__"


def _band(msg) -> int:
    """Protocol band of a journaled message (replay + fold ordering)."""
    from accord_tpu_torch.messages.accept import Accept, AcceptInvalidate
    from accord_tpu_torch.messages.apply_msg import Apply
    from accord_tpu_torch.messages.commit import Commit, CommitInvalidate
    from accord_tpu_torch.messages.invalidate_msg import BeginInvalidation
    from accord_tpu_torch.messages.preaccept import PreAccept
    from accord_tpu_torch.messages.propagate import Propagate
    from accord_tpu_torch.messages.recover import BeginRecovery

    # admin-plane records (messages/admin.py) pin their own band: epoch
    # installs / bootstrap checkpoints must replay BEFORE protocol messages
    # gated on the epochs and watermarks they establish
    band = getattr(msg, "replay_band", None)
    if band is not None:
        return band
    if isinstance(msg, PreAccept):
        return 0
    if isinstance(msg, (Accept, AcceptInvalidate, BeginInvalidation,
                        BeginRecovery)):
        return 1
    if isinstance(msg, Commit):
        return 2 if not msg.kind.is_stable else 3
    if isinstance(msg, CommitInvalidate):
        return 3
    if isinstance(msg, Apply):
        return 4
    if isinstance(msg, Propagate):
        return 5
    return 6


def canonical_encoding(msg) -> str:
    """Order-normalized wire encoding: the dedupe identity (and the
    round-trip test's comparison key).  Unordered containers ($s sets, $d
    dict pairs) are sorted by their JSON dump so two structurally equal
    messages canonicalize identically."""
    from accord_tpu_torch.host.wire import encode_message
    return json.dumps(_canon(encode_message(msg)), sort_keys=True)


def _canon(data):
    if isinstance(data, list):
        return [_canon(x) for x in data]
    if isinstance(data, dict):
        if len(data) == 1 and "$s" in data:
            items = [_canon(x) for x in data["$s"]]
            return {"$s": sorted(items, key=lambda x: json.dumps(
                x, sort_keys=True))}
        if len(data) == 1 and "$d" in data:
            pairs = [[_canon(k), _canon(v)] for k, v in data["$d"]]
            return {"$d": sorted(pairs, key=lambda kv: json.dumps(
                kv[0], sort_keys=True))}
        return {k: _canon(v) for k, v in data.items()}
    return data


def _recon_key(r) -> tuple:
    """Comparable digest of one txn's reconstructed knowledge
    (sim/journal.Reconstruction): what the fold must preserve exactly."""
    return (r.witnessed, frozenset(r.definition_keys),
            frozenset(r.execute_ats), r.accept_evidence,
            frozenset(r.stable_dep_ids), frozenset(r.write_keys),
            r.has_outcome, r.invalidated)


def fold_messages(msgs: List[object], verify: bool = True) -> List[object]:
    """Order-insensitive compaction fold over one node's journal records.

    Groups by txn, dedupes by canonical encoding, then attempts the
    aggressive drop (messages subsumed by a maximal Apply) guarded by
    reconstruction equality when `verify` is set."""
    from accord_tpu_torch.sim.journal import reconstruct

    by_txn: Dict[object, List[Tuple[int, str, object]]] = {}
    no_txn: List[object] = []
    for m in msgs:
        txn_id = getattr(m, "txn_id", None)
        if txn_id is None:
            no_txn.append(m)
            continue
        by_txn.setdefault(txn_id, []).append(
            (_band(m), canonical_encoding(m), m))
    out: List[object] = list(no_txn)
    for txn_id in sorted(by_txn, key=repr):
        entries = sorted(by_txn[txn_id], key=lambda e: (e[0], e[1]))
        deduped, seen = [], set()
        for band, canon, m in entries:
            if canon not in seen:
                seen.add(canon)
                deduped.append((band, m))
        candidate = _drop_subsumed(deduped)
        if len(candidate) < len(deduped) and verify:
            want = reconstruct([m for _b, m in deduped]).get(txn_id)
            got = reconstruct([m for _b, m in candidate]).get(txn_id)
            if want is None or got is None \
                    or _recon_key(want) != _recon_key(got):
                candidate = deduped  # the drop would lose knowledge
        out.extend(m for _b, m in candidate)
    return out


def _drop_subsumed(entries: List[Tuple[int, object]]
                   ) -> List[Tuple[int, object]]:
    """Drop pre-decision rounds once a MAXIMAL Apply (definition + deps +
    writes) is journaled for the txn: replaying the Apply alone rebuilds at
    least as much knowledge.  Callers verify with the reconstruction fold
    and revert on any mismatch, so this only needs to be usually-right."""
    from accord_tpu_torch.messages.apply_msg import Apply

    maximal = [m for _b, m in entries
               if isinstance(m, Apply) and m.partial_txn is not None
               and m.deps is not None and m.writes is not None]
    if not maximal:
        return entries
    return [(b, m) for b, m in entries if b >= 3 or isinstance(m, Apply)]


# ------------------------------------------------------------- file format --

def write_snapshot(path: str, covers: int, msgs: List[object],
                   fsync: bool = True) -> None:
    """Atomically (tmp + rename) write a snapshot covering segment indexes
    <= `covers`.  First frame is the meta record; the rest are ordinary
    wire-encoded records."""
    from accord_tpu_torch.journal.wal import encode_record
    meta = json.dumps({_META_KEY: 1, "covers": covers,
                       "count": len(msgs)}).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(frame(meta))
        for m in msgs:
            f.write(frame(encode_record(m)))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def read_snapshot(path: str) -> Tuple[int, List[object]]:
    """(covers, messages) of a snapshot file.  The rename is atomic, so a
    snapshot is either whole or absent; a torn one (should not happen) is
    read up to the tear."""
    from accord_tpu_torch.journal.wal import decode_record
    payloads, _good, _torn = scan_segment(path)
    if not payloads:
        return -1, []
    meta = json.loads(payloads[0].decode())
    assert meta.get(_META_KEY), f"not a snapshot file: {path}"
    return meta["covers"], [decode_record(p) for p in payloads[1:]]


class CompactionStats:
    __slots__ = ("records_in", "records_out", "segments_retired")

    def __init__(self, records_in: int, records_out: int,
                 segments_retired: int):
        self.records_in = records_in
        self.records_out = records_out
        self.segments_retired = segments_retired

    def __repr__(self):
        return (f"CompactionStats(in={self.records_in} "
                f"out={self.records_out} "
                f"segments_retired={self.segments_retired})")


def compact(directory: str, upto_index: int, verify: bool = True,
            fsync: bool = True) -> CompactionStats:
    """Fold the existing snapshot plus every segment with index <=
    `upto_index` into a fresh snapshot, then delete the covered segments.
    Crash-safe: snapshot replaced before segments are unlinked — a crash
    between the two leaves duplicates, which replay (idempotent message
    redelivery) and the next compaction's dedupe both absorb."""
    from accord_tpu_torch.journal.wal import SNAPSHOT_NAME, decode_record
    snap_path = os.path.join(directory, SNAPSHOT_NAME)
    msgs: List[object] = []
    if os.path.exists(snap_path):
        _covers, prev = read_snapshot(snap_path)
        msgs.extend(prev)
    covered = [(idx, path) for idx, path in list_segments(directory)
               if idx <= upto_index]
    for _idx, path in covered:
        for payload in read_segment(path, truncate=True):
            msgs.append(decode_record(payload))
    folded = fold_messages(msgs, verify=verify)
    write_snapshot(snap_path, upto_index, folded, fsync=fsync)
    for _idx, path in covered:
        os.unlink(path)
    if fsync:
        fsync_dir(directory)
    return CompactionStats(len(msgs), len(folded), len(covered))
