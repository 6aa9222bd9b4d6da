"""Message journal + replay reconstruction: the crash-durability contract.

Reference: accord/local/SerializerSupport.java:60-557 — any Command record is
reconstructible from its SaveStatus plus the node's retained side-effecting
messages — exercised by the burn-test Journal
(accord-core test impl/basic/Journal.java:82-303), which records every
`hasSideEffects` message per node and validates reconstruction round-trips.

Our validator folds each node's journaled messages per txn (order-insensitive:
unions and agreement-checked decided values, which is what makes it robust to
delivery reordering) and asserts that everything the live command state knows
is derivable from the journal:

  * definition     — the journal yields the partial txn's key set
  * executeAt      — every decided-band message agrees on one executeAt,
                     equal to the live command's
  * stable deps    — the live stable deps ids are covered by the journal
                     (live state is a per-store slice of journaled messages)
  * outcome        — PreApplied+ commands have journaled writes covering the
                     live write set
  * invalidation   — INVALIDATED commands have journaled invalidation
                     evidence

A node that could not pass this check could not recover from a crash by
message replay — the durability story the reference's journal certifies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class Journal:
    """Per-node ordered record of side-effecting requests."""

    def __init__(self):
        self.records: Dict[int, List[object]] = {}

    def record(self, node_id: int, request) -> None:
        self.records.setdefault(node_id, []).append(request)

    def for_node(self, node_id: int) -> List[object]:
        return self.records.get(node_id, [])


class Reconstruction:
    """Folded knowledge about one txn from one node's journal."""

    __slots__ = ("txn_id", "witnessed", "definition_keys", "execute_ats",
                 "accept_evidence", "stable_dep_ids", "write_keys",
                 "has_outcome", "invalidated")

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id
        self.witnessed = False
        self.definition_keys: Set = set()
        self.execute_ats: Set[Timestamp] = set()   # decided-band only
        self.accept_evidence = False
        self.stable_dep_ids: Set[TxnId] = set()
        self.write_keys: Set = set()
        self.has_outcome = False
        self.invalidated = False


def _keys_of(keys_or_ranges) -> Set:
    try:
        return set(keys_or_ranges)
    except TypeError:
        return set()


def _uncovered(needed: Set, have: Set) -> Set:
    """Elements of `needed` not COVERED by `have`. Exact membership is not
    enough for the range domain: a command's stored body is its message
    body sliced to the store's ranges (e.g. Propagate slices before
    installing), so under topology splits the live body can hold a FRAGMENT
    [0,250) of a journaled definition [0,500) — covered, not missing."""
    from accord_tpu_torch.primitives.keys import Range, Ranges

    missing = needed - have
    if not missing:
        return missing
    have_ranges = Ranges([h for h in have if isinstance(h, Range)])
    if have_ranges.is_empty:
        return missing
    out = set()
    for n in missing:
        if isinstance(n, Range):
            if not Ranges([n]).subtract(have_ranges).is_empty:
                out.add(n)
        elif not have_ranges.contains(n):
            out.add(n)
    return out


def reconstruct(records: List[object]) -> Dict[TxnId, Reconstruction]:
    """Fold a node's journal into per-txn reconstructed knowledge
    (SerializerSupport.reconstruct's message-picking, as one pass)."""
    from accord_tpu_torch.messages.accept import Accept, AcceptInvalidate
    from accord_tpu_torch.messages.apply_msg import Apply
    from accord_tpu_torch.messages.commit import Commit, CommitInvalidate
    from accord_tpu_torch.messages.invalidate_msg import BeginInvalidation
    from accord_tpu_torch.messages.preaccept import PreAccept
    from accord_tpu_torch.messages.propagate import Propagate
    from accord_tpu_torch.messages.recover import BeginRecovery

    out: Dict[TxnId, Reconstruction] = {}

    def rec(txn_id: TxnId) -> Reconstruction:
        r = out.get(txn_id)
        if r is None:
            r = out[txn_id] = Reconstruction(txn_id)
        return r

    for msg in records:
        txn_id = getattr(msg, "txn_id", None)
        if txn_id is None:
            continue
        r = rec(txn_id)
        r.witnessed = True
        if isinstance(msg, PreAccept):
            if msg.partial_txn is not None:
                r.definition_keys |= _keys_of(msg.partial_txn.keys)
        elif isinstance(msg, Accept):
            r.accept_evidence = True
        elif isinstance(msg, (AcceptInvalidate, BeginInvalidation)):
            r.accept_evidence = True
        elif isinstance(msg, Commit):
            r.execute_ats.add(msg.execute_at)
            if msg.partial_txn is not None:
                r.definition_keys |= _keys_of(msg.partial_txn.keys)
            if msg.kind.is_stable:
                r.stable_dep_ids |= msg.deps.txn_id_set()
        elif isinstance(msg, CommitInvalidate):
            r.invalidated = True
        elif isinstance(msg, Apply):
            r.execute_ats.add(msg.execute_at)
            if msg.partial_txn is not None:
                r.definition_keys |= _keys_of(msg.partial_txn.keys)
            if msg.deps is not None:
                r.stable_dep_ids |= msg.deps.txn_id_set()
            if msg.writes is not None:
                r.has_outcome = True
                r.write_keys |= _keys_of(msg.writes.keys)
        elif isinstance(msg, BeginRecovery):
            r.accept_evidence = True
            if msg.partial_txn is not None:
                r.definition_keys |= _keys_of(msg.partial_txn.keys)
        elif isinstance(msg, Propagate):
            k = msg.known
            if k.save_status == SaveStatus.INVALIDATED:
                r.invalidated = True
                continue
            if k.partial_txn is not None:
                r.definition_keys |= _keys_of(k.partial_txn.keys)
            if k.execute_at is not None \
                    and k.save_status >= SaveStatus.PRE_COMMITTED:
                r.execute_ats.add(k.execute_at)
            if k.stable_deps is not None:
                r.stable_dep_ids |= k.stable_deps.txn_id_set()
            if k.writes is not None:
                r.has_outcome = True
                r.write_keys |= _keys_of(k.writes.keys)
    return out


def reconstruct_durable_bounds(records: List[object]):
    """Fold the journaled durability-watermark messages into a DurableBefore
    — the knowledge a crash-replay re-derives the safe-to-clean inference
    from (local/cleanup.py INVALIDATE_THEN_ERASE: an undecided straggler
    below the replayed universal bound is re-inferred invalid by the sweep,
    with no per-txn invalidation record ever journaled)."""
    from accord_tpu_torch.local.watermarks import DurableBefore
    from accord_tpu_torch.messages.durability import (SetGloballyDurable,
                                                SetShardDurable)
    from accord_tpu_torch.primitives.timestamp import TXNID_NONE

    db = DurableBefore()
    for msg in records:
        if isinstance(msg, SetShardDurable):
            db.update(msg.ranges, msg.txn_id,
                      msg.txn_id if msg.universal else TXNID_NONE)
        elif isinstance(msg, SetGloballyDurable):
            db.update(msg.ranges, msg.majority, msg.universal)
    return db


def _universal_bound_covers(db, store, cmd) -> bool:
    """Would the replayed universal bound re-infer this command invalid?
    Mirrors cleanup.should_cleanup's INVALIDATE_THEN_ERASE predicate
    against the journal-reconstructed DurableBefore."""
    from accord_tpu_torch.local import cleanup
    participants = cleanup._participants(store, cmd)
    if participants is None:
        return False
    from accord_tpu_torch.primitives.keys import Ranges
    if isinstance(participants, Ranges):
        _maj, uni = db.min_bounds(participants)
        return cmd.txn_id < uni
    return len(participants) > 0 and all(
        db.is_universally_durable(cmd.txn_id, k) for k in participants)


def validate_node(node) -> Tuple[int, int]:
    """Assert every live command on `node` is reconstructible from its
    journal. Returns (commands_checked, commands_skipped)."""
    records = node.journal.for_node(node.id)
    recons = reconstruct(records)
    durable_bounds = None  # folded lazily: most runs never need it
    checked = skipped = 0
    for store in node.command_stores.all():
        for txn_id, cmd in store.commands.items():
            st = cmd.save_status
            if st == SaveStatus.NOT_DEFINED or st.is_truncated \
                    or txn_id.kind.name == "LOCAL_ONLY":
                skipped += 1  # nothing durable to reconstruct / local marker
                continue
            r = recons.get(txn_id)
            ctx = f"node {node.id} store {store.id} {txn_id!r} {st.name}"
            if st == SaveStatus.INVALIDATED:
                ok = r is not None and (r.invalidated or r.accept_evidence)
                if not ok:
                    # safe-to-clean inference (coordinate/infer.py): no
                    # per-txn record exists, but replaying the journaled
                    # SetShardDurable/SetGloballyDurable bounds re-infers
                    # the invalidation deterministically
                    if durable_bounds is None:
                        durable_bounds = reconstruct_durable_bounds(records)
                    ok = _universal_bound_covers(durable_bounds, store, cmd)
                assert ok, f"{ctx}: invalidation not journaled"
                checked += 1
                continue
            assert r is not None and r.witnessed, f"{ctx}: never journaled"
            if cmd.partial_txn is not None:
                missing = _uncovered(_keys_of(cmd.partial_txn.keys),
                                     r.definition_keys)
                assert not missing, \
                    f"{ctx}: definition keys {missing} not journaled"
            if st >= SaveStatus.PRE_COMMITTED and cmd.execute_at is not None:
                assert len(r.execute_ats) <= 1, \
                    f"{ctx}: divergent journaled executeAts {r.execute_ats}"
                assert r.execute_ats == {cmd.execute_at}, \
                    (f"{ctx}: live executeAt {cmd.execute_at!r} vs journal "
                     f"{r.execute_ats}")
            elif st in (SaveStatus.ACCEPTED, SaveStatus.ACCEPTED_INVALIDATE):
                assert r.accept_evidence, f"{ctx}: accept not journaled"
            if st >= SaveStatus.STABLE and cmd.stable_deps is not None:
                live_ids = cmd.stable_deps.txn_id_set()
                missing = live_ids - r.stable_dep_ids
                assert not missing, \
                    f"{ctx}: stable dep ids {missing} not journaled"
            if st >= SaveStatus.PRE_APPLIED and cmd.writes is not None:
                assert r.has_outcome, f"{ctx}: outcome not journaled"
                missing = _keys_of(cmd.writes.keys) - r.write_keys
                assert not missing, \
                    f"{ctx}: write keys {missing} not journaled"
            checked += 1
    return checked, skipped


def validate_cluster(cluster) -> Tuple[int, int]:
    checked = skipped = 0
    for node in cluster.nodes.values():
        c, s = validate_node(node)
        checked += c
        skipped += s
    return checked, skipped
