"""Infer: durability-derived invalidation evidence and the no-round ladder.

Reference: accord/coordinate/Infer.java — replicas attach an `InvalidIf`
condition per owned range, derived from their durability watermarks, to
CheckStatus/BeginRecovery replies; the fetcher joins them across the reply
quorum and, when the merged evidence suffices (`inferInvalidWithQuorum`),
commits invalidation directly with ZERO extra WAN rounds.

The ladder (local/status.InvalidIf, lattice join = max):

    NOT_KNOWN_TO_BE_INVALID < IF_UNDECIDED < IF_UNCOMMITTED < IS_INVALID

* IF_UNDECIDED — the txn sits below the replica's majority-durable fence
  (DurableBefore.majority_before).  The fence only advances after a
  durability round certified every witnessed txn beneath it as
  majority-applied-or-invalidated, so a DECIDED txn below the fence is
  applied at a majority — any reply quorum would intersect that majority
  and see the decision.  A quorum of undecided+IF_UNDECIDED replies
  therefore proves the txn was never decided; the fence-refusal rule
  (local/commands.is_durably_fenced: replicas refuse to freshly witness,
  accept, or recovery-witness below the fence) proves it never CAN be —
  any future decision quorum must intersect the evidence quorum in a
  replica that now refuses.  Together these make the no-round
  commit-invalidate provably safe, closing the narrowing this module
  documented through r5 (the old behavior — route the evidence through a
  full ballot-protected Invalidate round — remains as the
  ACCORD_INFER_FULL=0 escape hatch and the sub-quorum-evidence fallback).
* IF_UNCOMMITTED — additionally below the shard-applied fence (every
  replica applied the exclusive sync point; RedundantBefore): an
  uncommitted straggler can never newly commit.
* IS_INVALID — locally known invalidated.

Safe-to-clean (local/cleanup.py): a locally-undecided txn below the
UNIVERSAL durable bound cannot have applied at this replica, yet the bound
says everything beneath it applied at EVERY replica or was invalidated —
so it is invalidated, and may be erased immediately instead of lingering
truncated-but-witnessable.
"""

from __future__ import annotations

import os

from accord_tpu_torch.local.status import InvalidIf
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import TxnId


def full_infer_enabled() -> bool:
    """ACCORD_INFER_FULL: default-on full Infer ladder (quorum no-round
    invalidation + fence refusal + safe-to-clean); =0 restores the r5
    narrowing that routed all evidence through the Invalidate round."""
    return os.environ.get("ACCORD_INFER_FULL", "1") != "0"


def invalid_if_undecided(safe_store, txn_id: TxnId, participants) -> bool:
    """Is txn_id below the majority-durability bound of some owned
    participant span? (Infer.invalidIfNot's DurableBefore conditions —
    the legacy boolean projection of the lattice, kept for the
    ACCORD_INFER_FULL=0 route and reply-level summaries)"""
    db = safe_store.store.durable_before
    if isinstance(participants, Ranges):
        return db.is_any_majority_durable(txn_id, participants)
    return any(db.is_majority_durable(txn_id, k) for k in participants)


def invalid_if_for_span(safe_store, txn_id: TxnId, start: int,
                        end: int) -> InvalidIf:
    """The strongest invalidation condition this store's watermarks justify
    for txn_id over the token span [start, end) — the per-range value the
    replying replica folds into its CheckStatusOk KnownMap.  The caller is
    responsible for only attaching this when the txn is locally UNDECIDED
    (a decided txn below the fence is simply durably decided)."""
    span = Ranges.of((start, end))
    rb = safe_store.store.redundant_before
    if rb.is_any_shard_redundant(txn_id, span):
        return InvalidIf.IF_UNCOMMITTED
    db = safe_store.store.durable_before
    if db.is_any_majority_durable(txn_id, span):
        return InvalidIf.IF_UNDECIDED
    return InvalidIf.NOT_KNOWN_TO_BE_INVALID


def invalid_if_local(safe_store, txn_id: TxnId, participants) -> InvalidIf:
    """Span-fold of invalid_if_for_span over a Keys/Ranges selection — the
    reply-level summary BeginRecovery attaches (RecoverOk carries no
    per-range map; recovery quorums are per-shard already)."""
    best = InvalidIf.NOT_KNOWN_TO_BE_INVALID
    if isinstance(participants, Ranges):
        spans = [(r.start, r.end) for r in participants]
    else:
        spans = [(k.token, k.token + 1) for k in participants]
    for s, e in spans:
        best = max(best, invalid_if_for_span(safe_store, txn_id, s, e))
        if best == InvalidIf.IF_UNCOMMITTED:
            break
    return best


def infer_invalid_with_quorum(node, txn_id: TxnId, route,
                              merged) -> bool:
    """`Infer.inferInvalidWithQuorum`: commit invalidation with NO extra
    round when the merged CheckStatus replies prove it safe — a full
    per-shard quorum attached IF_UNDECIDED-or-stronger evidence (stamped
    on `merged` by the fetch round as `quorum_invalid_evidence`), the
    merged state is still undecided, and nothing Accepted-or-later was
    witnessed anywhere (an accept must be settled by ballots —
    coordinate/invalidate.py stays the fallback for that).  Returns True
    when the invalidation was committed."""
    from accord_tpu_torch.local.status import SaveStatus

    if not full_infer_enabled() or merged is None:
        return False
    if not getattr(merged, "quorum_invalid_evidence", False):
        return False
    if merged.save_status >= SaveStatus.ACCEPTED:
        return False
    from accord_tpu_torch.coordinate.invalidate import commit_invalidate
    best = route
    if merged.route is not None:
        best = route.with_(merged.route)
    obs = getattr(node, "obs", None)
    if obs is not None:
        obs.flight.record("infer_invalidate", repr(txn_id),
                          ("quorum_evidence", merged.save_status.name))
    node.infer_stats["no_round_commits"] += 1
    commit_invalidate(node, txn_id, best)
    node.events.on_invalidated(txn_id)
    return True
