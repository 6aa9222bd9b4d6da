"""Cleanup: the GC decision ladder and the store truncation sweep.

Reference: accord/local/Cleanup.java:37-44 — NO / TRUNCATE_WITH_OUTCOME /
TRUNCATE / ERASE computed from durability class + redundancy; applied by
Commands.purge (Commands.java:879-967). A command may only be truncated once
its outcome is durable at a majority of every participating shard (it can
then be reconstructed from peers), and only erased once universally durable
(no peer will ever ask for it again).
"""

from __future__ import annotations

import enum
from typing import List

from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.primitives.keys import Keys, Ranges
from accord_tpu_torch.primitives.timestamp import TxnId


class Cleanup(enum.Enum):
    NO = "NO"
    # metadata (deps/txn/waiting) dropped, outcome (writes/result) kept: a
    # lagging replica of this or another shard can still fetch the outcome
    TRUNCATE_WITH_OUTCOME = "TRUNCATE_WITH_OUTCOME"
    ERASE = "ERASE"
    # safe-to-clean inference (coordinate/infer.py, reference
    # Infer.safeToCleanup): an UNDECIDED local straggler below the
    # universal durable bound is provably invalidated — had it been
    # decided, it would have applied at EVERY replica including this one —
    # so the sweep commits the invalidation locally and erases in one step
    # instead of leaving it truncated-but-witnessable
    INVALIDATE_THEN_ERASE = "INVALIDATE_THEN_ERASE"


def should_cleanup(store, cmd) -> Cleanup:
    """GC decision for one command (Cleanup.shouldCleanup)."""
    from accord_tpu_torch.coordinate.infer import full_infer_enabled
    if cmd.is_truncated:
        return Cleanup.NO
    if cmd.is_invalidated:
        participants = _participants(store, cmd)
        if participants is None:
            return Cleanup.NO
        # invalidated txns are safe to erase once universally durable
        # bounds pass them (nobody can resurrect a lower ballot); the full
        # Infer ladder erases already at the MAJORITY bound — resurrection
        # would need a fresh witness quorum, which the fence-refusal rule
        # (local/commands.is_durably_fenced) denies below that bound
        if _fully(store, "universal", cmd.txn_id, participants):
            return Cleanup.ERASE
        if full_infer_enabled() and _fully(store, "majority", cmd.txn_id,
                                           participants):
            return Cleanup.ERASE
        return Cleanup.NO
    if not cmd.has_been(SaveStatus.APPLIED):
        if not full_infer_enabled() or cmd.save_status.is_decided:
            return Cleanup.NO
        participants = _participants(store, cmd)
        if participants is None:
            return Cleanup.NO
        if _fully(store, "universal", cmd.txn_id, participants) \
                and _post_bootstrap(store, cmd.txn_id, participants):
            # undecided below the universal bound (and the range is not a
            # gap in OUR history — post-bootstrap, not stale): every
            # replica applied everything decided beneath the bound, we
            # did not apply this, hence it was invalidated
            return Cleanup.INVALIDATE_THEN_ERASE
        return Cleanup.NO
    participants = _participants(store, cmd)
    if participants is None:
        return Cleanup.NO
    if _fully(store, "universal", cmd.txn_id, participants):
        # every replica of this shard applied it; peers of other shards ask
        # their own shard for the outcome — nothing can need ours again
        return Cleanup.ERASE
    if _fully(store, "majority", cmd.txn_id, participants):
        return Cleanup.TRUNCATE_WITH_OUTCOME
    return Cleanup.NO


def _post_bootstrap(store, txn_id: TxnId, participants) -> bool:
    """The local-inference gate: a pre-bootstrap or stale span is a hole in
    OUR apply history, not evidence the txn never applied anywhere."""
    from accord_tpu_torch.local.watermarks import PreBootstrapOrStale
    return store.redundant_before.pre_bootstrap_or_stale(
        txn_id, participants) == PreBootstrapOrStale.POST_BOOTSTRAP


def _participants(store, cmd):
    """Local slice of the command's participants: the durable bounds in this
    store's map only ever cover its own ranges."""
    parts = None
    if cmd.partial_txn is not None:
        parts = cmd.partial_txn.keys
    elif cmd.route is not None:
        parts = cmd.route.participants()
    if parts is None or store.ranges.is_empty:
        return parts
    sliced = parts.slice(store.ranges)
    if isinstance(sliced, Ranges):
        return sliced if not sliced.is_empty else None
    return sliced if len(sliced) > 0 else None


def _fully(store, which: str, txn_id: TxnId, participants) -> bool:
    """Is txn_id durable at `which` tier across ALL of `participants`?

    For Ranges this folds the piecewise DurableBefore map over every span
    intersecting each range (DurableBefore.min: uncovered spans floor the
    bound to NONE), so an interior span with a lower/no durable bound blocks
    cleanup — endpoint probing missed those (ADVICE r1, high)."""
    db = store.durable_before
    if isinstance(participants, Ranges):
        if participants.is_empty:
            return False
        majority, universal = db.min_bounds(participants)
        bound = universal if which == "universal" else majority
        return txn_id < bound
    if len(participants) == 0:
        return False
    pred = (db.is_universally_durable if which == "universal"
            else db.is_majority_durable)
    return all(pred(txn_id, k) for k in participants)


def sweep(store) -> int:
    """Truncate/erase everything the durable bounds allow; prune the per-key
    conflict indexes below the majority bound. Returns commands purged
    (the restoreInvalidated/purge sweep driven by SetShardDurable /
    SetGloballyDurable in the reference)."""
    from accord_tpu_torch.local import commands as C
    from accord_tpu_torch.local.store import SafeCommandStore, PreLoadContext

    safe = SafeCommandStore(store, PreLoadContext.empty())
    purged = 0
    for txn_id in list(store.commands):
        cmd = store.commands[txn_id]
        decision = should_cleanup(store, cmd)
        if decision == Cleanup.NO:
            continue
        if decision == Cleanup.INVALIDATE_THEN_ERASE:
            # safe-to-clean inference: settle the straggler as INVALIDATED
            # first (terminal, listeners notified, progress log cleared),
            # then erase — purge alone would stamp TRUNCATED_APPLY, whose
            # Known projection falsely claims an applied outcome
            obs = getattr(store.node, "obs", None)
            if obs is not None:
                obs.flight.record("infer_invalidate", repr(txn_id),
                                  ("safe_to_clean", cmd.save_status.name))
            store.node.infer_stats["safe_to_clean"] += 1
            C.commit_invalidate(safe, txn_id)
            decision = Cleanup.ERASE  # falls through to the common purge
        C.purge(safe, txn_id, erase=decision == Cleanup.ERASE,
                keep_outcome=decision == Cleanup.TRUNCATE_WITH_OUTCOME)
        purged += 1
        # the range-conflict index entry may only be dropped once the shard
        # fence guarantees no lower-id straggler can newly commit and rely on
        # witnessing this txn (universal tier installs the fence); at the
        # majority tier the command truncates but stays witnessable
        if decision == Cleanup.ERASE and txn_id in store.range_commands:
            store.range_version += 1
            del store.range_commands[txn_id]
    # prune conflict indexes below each key's shard-applied fence: the fence
    # ESP witnessed everything below it on every replica AND preaccept refuses
    # lower-id stragglers, so nothing pruned can be needed by a new deps calc.
    # (Majority durability alone is NOT enough: a low-id straggler the fence
    # never saw could still commit and miss the pruned entries — ADVICE r1.)
    for key, cfk in store.cfks.items():
        bound = store.redundant_before.shard_applied_before(key)
        if bound.hlc > 0:
            for u in cfk.prune_redundant(bound):
                u.callback(safe)
    return purged
