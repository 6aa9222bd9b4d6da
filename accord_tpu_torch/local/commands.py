"""All command state transitions, as static functions over a SafeCommandStore.

Reference: accord/local/Commands.java — preaccept (:131), accept (:219),
acceptInvalidate (:267), commit (:306), precommit (:371), commitInvalidate
(:463), apply (:491), maybeExecute (:656), initialiseWaitingOn (:735),
updateWaitingOn (:776), updateDependencyAndMaybeExecute (:832), truncation
(:879-967), setDurability (:978).

The WaitingOn graph walk these functions drive is north-star kernel #2: the
batched device equivalent (topological wavefront over the conflict graph) lives
in accord_tpu_torch.ops.wavefront with this scalar path as its oracle.
"""

from __future__ import annotations

import enum
import os
from collections import deque
from typing import Callable, List, Optional, Tuple

from accord_tpu_torch.local.cfk import InternalStatus
from accord_tpu_torch.local.command import (Command, WaitingOn,
                                      note_status_transition)
from accord_tpu_torch.local.status import Durability, SaveStatus
from accord_tpu_torch.local.store import SafeCommandStore
from accord_tpu_torch.primitives.deps import Deps, KeyDeps
from accord_tpu_torch.primitives.keys import Key, Keys, Ranges, Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes
from accord_tpu_torch.utils import invariants

# Scalar-walk work counters (the Commands.java:656,1011 walk the device
# wavefront planner aims to displace): incremented process-wide, reset by
# measurement harnesses per run (measure_device.py A/B evidence).
WORK = {"maybe_execute": 0, "notify": 0}


def reset_work_counters() -> None:
    WORK["maybe_execute"] = 0
    WORK["notify"] = 0


class AcceptOutcome(enum.Enum):
    SUCCESS = "SUCCESS"
    REDUNDANT = "REDUNDANT"          # already progressed past this phase
    REJECTED_BALLOT = "REJECTED_BALLOT"
    INSUFFICIENT = "INSUFFICIENT"
    TRUNCATED = "TRUNCATED"


class ApplyOutcome(enum.Enum):
    SUCCESS = "SUCCESS"
    REDUNDANT = "REDUNDANT"
    INSUFFICIENT = "INSUFFICIENT"


# ---------------------------------------------------------------- deps calc --

def calculate_deps(safe_store: SafeCommandStore, txn_id: TxnId, participants,
                   before: Timestamp) -> Deps:
    """Dependency set for txn_id over `participants` (Keys or Ranges, owned
    slice): every active conflicting txn with id < `before`
    (PreAccept.calculatePartialDeps -> CommandsForKey.mapReduceActive).
    Key-domain conflicts land in KeyDeps; range-domain conflicts in RangeDeps
    keyed by the overlap (reference Deps.Builder domain split)."""
    from accord_tpu_torch.primitives.deps import RangeDeps
    builder = KeyDeps.builder()
    rbuilder = RangeDeps.builder()
    kinds = txn_id.kind.witnesses()

    def visit(key: Key, dep: TxnId):
        if dep != txn_id:
            builder.add(key, dep)

    def visit_range(overlap: Ranges, dep: TxnId):
        if dep != txn_id:
            for r in overlap:
                rbuilder.add(r, dep)

    # cfk stage fence (obs/cpuprof.py): the active-conflict scan is the
    # per-key conflict-index walk PAPER.md singles out as the hot kernel —
    # attribute it separately from the rest of the apply
    prof = safe_store.store.cpuprof
    t = prof.stage_begin() if prof is not None and prof.active else None
    safe_store.map_reduce_active(participants, before, kinds, visit,
                                 on_range_dep=visit_range, exclude=txn_id)
    if t is not None:
        prof.stage_end(t, "cfk")
    return Deps(builder.build(), rbuilder.build())


def propose_execute_at(safe_store: SafeCommandStore, txn_id: TxnId,
                       participants, permit_fast_path: bool,
                       permit_expiry: bool = True) -> Timestamp:
    """executeAt proposal (CommandStore.preaccept :320-345): txn_id itself when
    no conflict is newer AND the fast path is permitted (ballot zero — recovery
    must not mint fast-path votes — and txn_id's epoch is current), else a
    fresh HLC strictly after every known conflict."""
    node = safe_store.node
    # preaccept expiry: stale-clocked coordinators get a REJECTED proposal the
    # coordinator turns into invalidation (CommandStore.preaccept isExpired);
    # never applied to recovery witnesses — the txn may be long since decided
    if permit_expiry and not txn_id.kind.is_sync_point:
        elapsed_us = node.now_us() - txn_id.hlc
        if elapsed_us >= safe_store.agent.pre_accept_timeout() * 1e6:
            return node.unique_now_at_least(txn_id).as_rejected()
    max_conflict = safe_store.max_conflict(participants)
    if (max_conflict is None or max_conflict < txn_id) and permit_fast_path \
            and txn_id.epoch >= node.epoch:
        return txn_id
    floor = max_conflict if max_conflict is not None and max_conflict > txn_id \
        else txn_id
    return node.unique_now_at_least(floor)


def is_shard_fenced(safe_store: SafeCommandStore, txn_id: TxnId,
                    participants) -> bool:
    """TxnIds below the shard-applied fence can never newly commit: every
    replica of the shard applied an exclusive sync point that witnessed
    everything before it, and refuses to witness stragglers
    (RedundantBefore.shardAppliedOrInvalidatedBefore gating)."""
    rb = safe_store.store.redundant_before
    if isinstance(participants, Ranges):
        # fold every intersecting fence span — an interior fenced sub-range
        # must refuse the straggler even when the endpoints are unfenced
        return rb.is_any_shard_redundant(txn_id, participants)
    return any(rb.is_shard_redundant(txn_id, k) for k in participants)


def full_infer_enabled() -> bool:
    """ACCORD_INFER_FULL: default-on full Infer ladder (quorum no-round
    invalidation + fence refusal + safe-to-clean); =0 restores the r5
    narrowing that routed all evidence through the Invalidate round.  A copy
    of ``accord_tpu/coordinate/infer.py::full_infer_enabled``, beside its
    one caller until the coordination layer is ported."""
    return os.environ.get("ACCORD_INFER_FULL", "1") != "0"


def is_durably_fenced(safe_store: SafeCommandStore, txn_id: TxnId,
                      participants) -> bool:
    """The full Infer ladder's refusal rule (coordinate/infer.py): a replica
    must not FRESHLY witness, slow-path accept, or recovery-witness a txn
    below its majority-durable fence — everything beneath the fence is
    certified majority-applied-or-invalidated, so an unwitnessed straggler
    there can only be headed for invalidation, and refusing makes the
    quorum no-round invalidation provably safe (any future decision quorum
    must intersect an evidence quorum of refusing replicas).  Only applies
    to commands with NO local knowledge — a pre-fence witness stays live
    (a fence cannot advance past a genuinely in-flight accept, whose
    application the durability round awaits).  Off under
    ACCORD_INFER_FULL=0, restoring the r5 executeAt-above-fence behavior."""
    if not full_infer_enabled():
        return False
    db = safe_store.store.durable_before
    if isinstance(participants, Ranges):
        fenced = db.is_any_majority_durable(txn_id, participants)
    else:
        fenced = any(db.is_majority_durable(txn_id, k) for k in participants)
    if fenced:
        safe_store.node.infer_stats["fence_refusals"] += 1
    return fenced


# ---------------------------------------------------------------- preaccept --

def preaccept(safe_store: SafeCommandStore, txn_id: TxnId,
              partial_txn: Optional[PartialTxn], route: Route,
              ballot: Ballot = Ballot.ZERO
              ) -> Tuple[AcceptOutcome, Optional[Timestamp]]:
    """Witness the txn; propose executeAt (Commands.preaccept :131)."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated or cmd.is_invalidated:
        return AcceptOutcome.TRUNCATED, None
    if not cmd.may_accept(ballot):
        return AcceptOutcome.REJECTED_BALLOT, None
    if cmd.has_been(SaveStatus.PRE_ACCEPTED):
        # competing recovery (ballot>0) still records its promise; a zero
        # ballot here is a replay (Commands.preacceptOrRecover :160-168)
        cmd.set_promised(ballot)
        return AcceptOutcome.REDUNDANT, cmd.execute_at_or_txn_id()

    cmd.update_route(route)
    cmd.set_promised(ballot)
    if partial_txn is not None:
        cmd.partial_txn = partial_txn
    participants = (partial_txn.keys if partial_txn is not None
                    else route.participants())
    if is_shard_fenced(safe_store, txn_id, participants) \
            or is_durably_fenced(safe_store, txn_id, participants):
        return AcceptOutcome.TRUNCATED, None
    witnessed_at = propose_execute_at(safe_store, txn_id, participants,
                                      permit_fast_path=ballot == Ballot.ZERO)
    cmd.execute_at = witnessed_at
    cmd.set_status(SaveStatus.PRE_ACCEPTED)
    # fence later proposals with the witnessed executeAt, not the txn id
    # (CommandStore.updateMaxConflicts :280-289 records executeAt)
    safe_store.update_max_conflicts(participants, witnessed_at)
    safe_store.register(cmd, InternalStatus.PREACCEPTED)
    if txn_id.is_range_domain and partial_txn is not None:
        safe_store.register_range_txn(cmd, partial_txn.keys)
    safe_store.progress_log.update(safe_store.store, txn_id, cmd)
    return AcceptOutcome.SUCCESS, witnessed_at


# ------------------------------------------------------------------ recover --

def recover(safe_store: SafeCommandStore, txn_id: TxnId,
            partial_txn: Optional[PartialTxn], route: Route, ballot: Ballot
            ) -> Tuple[AcceptOutcome, Command]:
    """Ballot-gated witness for BeginRecovery (Commands.preacceptOrRecover,
    Commands.java:160-217): promise `ballot`, witnessing the txn if this
    replica never saw it. Recovery proposals never mint fast-path votes
    (permit_fast_path=False), so a replica that first witnesses the txn here
    reports executeAt > txnId — a vote that the fast path did not happen.

    Returns the (possibly just-created) command so the caller can snapshot its
    pre-existing knowledge into the RecoverOk reply."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated or cmd.is_invalidated:
        return AcceptOutcome.TRUNCATED, cmd
    if not cmd.may_accept(ballot):
        return AcceptOutcome.REJECTED_BALLOT, cmd
    cmd.set_promised(ballot)
    if cmd.has_been(SaveStatus.PRE_ACCEPTED):
        return AcceptOutcome.SUCCESS, cmd

    cmd.update_route(route)
    if partial_txn is not None:
        cmd.partial_txn = partial_txn
    participants = (partial_txn.keys if partial_txn is not None
                    else route.participants())
    # NB: no SHARD-fence gate here, unlike preaccept: a fresh recovery
    # witness votes slow-path with executeAt above the fence (safe), whereas
    # refusing could fabricate evidence against a decided-elsewhere txn.
    # The DURABLE fence is different (full Infer ladder): a decided txn
    # below it is majority-APPLIED, so a fresh local witness here proves
    # nothing was decided through us — refusal fabricates no evidence, and
    # is what makes the quorum no-round invalidation sound (the promise
    # above still stands, so the refusing reply keeps its ballot guard)
    if is_durably_fenced(safe_store, txn_id, participants):
        return AcceptOutcome.TRUNCATED, cmd
    witnessed_at = propose_execute_at(safe_store, txn_id, participants,
                                      permit_fast_path=False,
                                      permit_expiry=False)
    cmd.execute_at = witnessed_at
    cmd.set_status(SaveStatus.PRE_ACCEPTED)
    safe_store.update_max_conflicts(participants, witnessed_at)
    safe_store.register(cmd, InternalStatus.PREACCEPTED)
    if txn_id.is_range_domain and partial_txn is not None:
        safe_store.register_range_txn(cmd, partial_txn.keys)
    safe_store.progress_log.update(safe_store.store, txn_id, cmd)
    return AcceptOutcome.SUCCESS, cmd


# ------------------------------------------------------------------- accept --

def accept(safe_store: SafeCommandStore, txn_id: TxnId, ballot: Ballot,
           route: Route, participating_keys, execute_at: Timestamp,
           partial_deps: Deps) -> AcceptOutcome:
    """Slow-path acceptance of (executeAt, deps) at `ballot`
    (Commands.accept :219)."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated or cmd.is_invalidated:
        return AcceptOutcome.TRUNCATED
    if not cmd.may_accept(ballot):
        return AcceptOutcome.REJECTED_BALLOT
    if cmd.has_been(SaveStatus.PRE_COMMITTED):
        return AcceptOutcome.REDUNDANT
    if not cmd.has_been(SaveStatus.PRE_ACCEPTED) \
            and is_durably_fenced(safe_store, txn_id, participating_keys):
        # full Infer ladder: an accept may not FRESHLY witness below the
        # durable fence either, or a recovery's Propose could complete a
        # decision quorum behind a quorum-established invalidation
        # inference (coordinate/infer.py safety argument)
        return AcceptOutcome.TRUNCATED

    cmd.update_route(route)
    cmd.set_promised(ballot)
    cmd.accepted_ballot = ballot
    cmd.execute_at = execute_at
    cmd.partial_deps = partial_deps
    cmd.set_status(SaveStatus.ACCEPTED)
    safe_store.update_max_conflicts(participating_keys, execute_at)
    safe_store.register(cmd, InternalStatus.ACCEPTED)
    safe_store.progress_log.update(safe_store.store, txn_id, cmd)
    return AcceptOutcome.SUCCESS


def preaccept_invalidate(safe_store: SafeCommandStore, txn_id: TxnId,
                         ballot: Ballot) -> bool:
    """Promise `ballot` toward invalidation without proposing anything:
    raises the command's promised ballot so neither the original coordinator
    nor a stale recovery can make progress beneath us
    (Commands.preacceptInvalidate :198-217). Returns False — promise
    refused — once a decision is durable (Committed+/truncated) or a higher
    ballot holds the promise."""
    cmd = safe_store.get(txn_id)
    if cmd.has_been(SaveStatus.COMMITTED) or cmd.is_truncated:
        return False
    if not cmd.may_accept(ballot):
        return False
    cmd.set_promised(ballot)
    return True


def accept_invalidate(safe_store: SafeCommandStore, txn_id: TxnId,
                      ballot: Ballot) -> AcceptOutcome:
    """Promise to invalidate (Commands.acceptInvalidate :267)."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated:
        return AcceptOutcome.TRUNCATED
    if not cmd.may_accept(ballot):
        return AcceptOutcome.REJECTED_BALLOT
    if cmd.has_been(SaveStatus.PRE_COMMITTED):
        return AcceptOutcome.REDUNDANT
    cmd.set_promised(ballot)
    cmd.accepted_ballot = ballot
    # UNCONDITIONALLY supersede any prior accepted value with the
    # invalidate acceptance (reference Command.acceptInvalidated:1698 sets
    # Status.AcceptedInvalidate regardless of a prior Accepted — their
    # accepted register now holds "invalidate" at this ballot, executeAt /
    # definition retained).  The old `if save_status <
    # ACCEPTED_INVALIDATE` guard kept an ACCEPTED status while bumping
    # accepted_ballot, fabricating "original value accepted at this
    # ballot": a later recovery then preferred the stale value over the
    # invalidate accepted at the same ballot and re-proposed a txn an
    # invalidation had already decided against — a committed-vs-invalidated
    # divergence (soak seed 57012, triage_57012.py).  Direct assignment:
    # this is the one legal non-cleanup status "regression" (set_status
    # guards it), mirroring the reference's modelling of AcceptedInvalidate
    # as a fresh acceptance rather than a phase advance.
    note_status_transition(cmd.txn_id, cmd.save_status,
                           SaveStatus.ACCEPTED_INVALIDATE)
    cmd.save_status = SaveStatus.ACCEPTED_INVALIDATE
    return AcceptOutcome.SUCCESS


# ------------------------------------------------------------------- commit --

def commit(safe_store: SafeCommandStore, txn_id: TxnId, route: Route,
           partial_txn: Optional[PartialTxn], execute_at: Timestamp,
           deps: Deps, stable: bool, ballot: Ballot = Ballot.ZERO
           ) -> AcceptOutcome:
    """Commit (executeAt, deps); `stable=True` also freezes deps and starts
    execution tracking (Commands.commit :306)."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated:
        return AcceptOutcome.TRUNCATED
    if cmd.is_invalidated:
        safe_store.agent.on_inconsistent_timestamp(cmd, None, execute_at)
        return AcceptOutcome.TRUNCATED
    target = SaveStatus.STABLE if stable else SaveStatus.COMMITTED
    if cmd.has_been(target):
        if cmd.execute_at is not None and cmd.execute_at != execute_at \
                and cmd.save_status.is_committed_to_execute:
            safe_store.agent.on_inconsistent_timestamp(cmd, cmd.execute_at,
                                                       execute_at)
        return AcceptOutcome.REDUNDANT

    cmd.update_route(route)
    if partial_txn is not None and cmd.partial_txn is None:
        cmd.partial_txn = partial_txn
    if stable and cmd.partial_txn is None and _needs_definition(cmd):
        return AcceptOutcome.INSUFFICIENT
    cmd.execute_at = execute_at
    if not stable:
        cmd.partial_deps = deps
        cmd.set_status(SaveStatus.COMMITTED)
        safe_store.register(cmd, InternalStatus.COMMITTED)
        safe_store.progress_log.update(safe_store.store, txn_id, cmd)
        return AcceptOutcome.SUCCESS

    cmd.stable_deps = deps
    cmd.set_status(SaveStatus.STABLE)
    # stable deps in hand: any staleness-escalation counter is moot
    safe_store.store.insufficient_catchups.pop(txn_id, None)
    safe_store.update_max_conflicts(
        cmd.partial_txn.keys if cmd.partial_txn is not None
        else route.participants(), execute_at)
    safe_store.register(cmd, InternalStatus.STABLE)
    _maybe_register_range_txn(safe_store, cmd)
    initialise_waiting_on(safe_store, cmd)
    safe_store.progress_log.update(safe_store.store, txn_id, cmd)
    maybe_execute(safe_store, cmd, always_notify=True)
    return AcceptOutcome.SUCCESS


def _maybe_register_range_txn(safe_store: SafeCommandStore, cmd: Command
                              ) -> None:
    """A range txn first learned of at commit/apply (Maximal paths) must still
    enter the range-conflict index."""
    if cmd.txn_id.is_range_domain and cmd.partial_txn is not None \
            and cmd.txn_id not in safe_store.store.range_commands:
        safe_store.register_range_txn(cmd, cmd.partial_txn.keys)


def _needs_definition(cmd: Command) -> bool:
    """Sync points and data txns need their definition to execute; reads of
    the definition come with the Stable/Apply message if missing."""
    return cmd.txn_id.kind.is_globally_visible


def precommit(safe_store: SafeCommandStore, txn_id: TxnId,
              execute_at: Timestamp) -> AcceptOutcome:
    """Record executeAt decision without deps (Commands.precommit :371)."""
    cmd = safe_store.get(txn_id)
    if cmd.is_truncated or cmd.is_invalidated:
        return AcceptOutcome.TRUNCATED
    if cmd.has_been(SaveStatus.PRE_COMMITTED):
        return AcceptOutcome.REDUNDANT
    cmd.execute_at = execute_at
    cmd.set_status(SaveStatus.PRE_COMMITTED)
    return AcceptOutcome.SUCCESS


def commit_invalidate(safe_store: SafeCommandStore, txn_id: TxnId) -> None:
    """Finalize invalidation (Commands.commitInvalidate :463)."""
    cmd = safe_store.get(txn_id)
    if cmd.has_been(SaveStatus.COMMITTED) and not cmd.is_invalidated:
        if cmd.save_status.is_committed_to_execute:
            safe_store.agent.on_inconsistent_timestamp(cmd, cmd.execute_at, None)
            return
    if cmd.is_invalidated:
        return
    note_status_transition(txn_id, cmd.save_status, SaveStatus.INVALIDATED)
    cmd.save_status = SaveStatus.INVALIDATED
    safe_store.store.insufficient_catchups.pop(txn_id, None)
    safe_store.register(cmd, InternalStatus.INVALID_OR_TRUNCATED)
    safe_store.progress_log.clear(txn_id)
    _notify_listeners(safe_store, cmd)


# -------------------------------------------------------------------- apply --

def apply(safe_store: SafeCommandStore, txn_id: TxnId, route: Route,
          execute_at: Timestamp, deps: Optional[Deps], writes: Optional[Writes],
          result, partial_txn: Optional[PartialTxn] = None) -> ApplyOutcome:
    """Record the outcome; execute once deps clear (Commands.apply :491)."""
    cmd = safe_store.get(txn_id)
    if cmd.has_been(SaveStatus.PRE_APPLIED) or cmd.is_truncated \
            or cmd.is_invalidated:
        return ApplyOutcome.REDUNDANT
    if cmd.execute_at is not None and cmd.has_been(SaveStatus.PRE_COMMITTED) \
            and cmd.execute_at != execute_at:
        safe_store.agent.on_inconsistent_timestamp(cmd, cmd.execute_at, execute_at)

    cmd.update_route(route)
    if partial_txn is not None and cmd.partial_txn is None:
        cmd.partial_txn = partial_txn
    if not cmd.has_been(SaveStatus.STABLE):
        if deps is None:
            return ApplyOutcome.INSUFFICIENT
        cmd.execute_at = execute_at
        cmd.stable_deps = deps
        cmd.set_status(SaveStatus.STABLE)
        safe_store.register(cmd, InternalStatus.STABLE)
        _maybe_register_range_txn(safe_store, cmd)
        initialise_waiting_on(safe_store, cmd)
    cmd.writes = writes
    cmd.result = result
    cmd.set_status(SaveStatus.PRE_APPLIED)
    safe_store.store.insufficient_catchups.pop(txn_id, None)
    safe_store.progress_log.update(safe_store.store, txn_id, cmd)
    maybe_execute(safe_store, cmd, always_notify=True)
    return ApplyOutcome.SUCCESS


# -------------------------------------------------- execution ordering core --

def initialise_waiting_on(safe_store: SafeCommandStore, cmd: Command) -> None:
    """Build the WaitingOn bitsets — over stable deps owned by this store AND
    over the command's own keys — and register as listener on each
    still-blocking dep (Commands.initialiseWaitingOn :735 + updateWaitingOn
    :776; the key dimension is the reference's txnIds ∪ keys bitset,
    Command.java:1425-1436, cleared per key by CommandsForKey)."""
    deps = cmd.stable_deps if cmd.stable_deps is not None else Deps.NONE
    local = deps.slice(safe_store.ranges) if not safe_store.ranges.is_empty else deps
    gate_keys = ()
    if cmd.txn_id.is_key_domain and cmd.txn_id.kind.is_globally_visible \
            and cmd.execute_at is not None:
        gate_keys = tuple(safe_store.owned_keys_of(cmd))
    waiting_on = WaitingOn.from_deps(local, keys=gate_keys)
    cmd.waiting_on = waiting_on
    for dep_id in list(waiting_on.txn_ids):
        _update_waiting_on_dep(safe_store, cmd, dep_id)
    for key in gate_keys:
        _initialise_key_wait(safe_store, cmd, key)


def _initialise_key_wait(safe_store: SafeCommandStore, cmd: Command,
                         key) -> None:
    """Arm the per-key execution gate: the key bit holds until the CFK
    certifies every earlier-executing entry applied.  Even a conflict the
    stable deps omit (e.g. under the unmerged-deps fault, or a commit that
    raced the accept round) cannot be overtaken: it lives in the CFK of some
    common replica and blocks there (the reference clears these bits via
    CommandsForKey.update -> removeWaitingOnKeyAndMaybeExecute,
    Commands.java:859)."""
    from accord_tpu_torch.local.cfk import Unmanaged
    cfk = safe_store.cfk(key)
    blockers = _key_gate_blockers(safe_store, cfk, cmd, key)
    if not blockers:
        cmd.waiting_on.remove_waiting_on_key(key)
        return
    txn_id = cmd.txn_id

    def fired(ss, _key=key, _txn_id=txn_id):
        _enqueue_notify(ss, ("key_unblock", _txn_id, _key))

    cfk.register_unmanaged(
        Unmanaged(txn_id, Unmanaged.APPLY, cmd.execute_at, fired))
    safe_store.store.gated.setdefault(txn_id, set()).add(key)
    _chase_key_blocker(safe_store, cmd, blockers)


def _chase_key_blocker(safe_store: SafeCommandStore, cmd: Command,
                       blockers) -> None:
    """Chase the gate's CURRENT first blocker (the progress log drives it to
    Committed/Applied).  The chase is renewed each progress-log sweep
    (sweep_key_gates) so a multi-blocker gate keeps being driven after its
    first blocker resolves — a per-transition hand-over would fan out to
    every waiter of a hot key and go quadratic."""
    blocking_id, decided = blockers[0]
    safe_store.progress_log.waiting(
        blocking_id, safe_store.store,
        "Applied" if decided else "Committed", None,
        cmd.route.participants() if cmd.route else None)


def sweep_key_gates(safe_store: SafeCommandStore) -> None:
    """Periodic liveness pass over armed key gates (called from the progress
    log's recurring run): re-chase each gate's current first blocker, clear
    gates whose blockers are all gone (e.g. covered by an advanced
    redundancy watermark with no CFK transition to fire the heap)."""
    store = safe_store.store
    for txn_id in list(store.gated):
        cmd = store.commands.get(txn_id)
        waiting_on = cmd.waiting_on if cmd is not None else None
        if waiting_on is None or not waiting_on.is_waiting_on_key:
            # purged/truncated/executed with no live key bits: drop the
            # index entry, or the per-tick sweep runs forever
            store.gated.pop(txn_id, None)
            continue
        # snapshot: the drain triggered by _enqueue_notify below removes
        # cleared keys from the live store.gated set
        keys = list(store.gated.get(txn_id, ()))
        live = set()
        for key in keys:
            if not waiting_on.is_waiting_on_key_at(key):
                continue
            blockers = _key_gate_blockers(safe_store, safe_store.cfk(key),
                                          cmd, key)
            if blockers:
                live.add(key)
                _chase_key_blocker(safe_store, cmd, blockers)
            else:
                _enqueue_notify(safe_store, ("key_unblock", txn_id, key))
        if live:
            store.gated[txn_id] = live
        elif not store.gated.get(txn_id):
            store.gated.pop(txn_id, None)


def _key_gate_blockers(safe_store: SafeCommandStore, cfk, cmd: Command,
                       key):
    """The CFK's APPLY-rule blockers minus entries the redundancy watermark
    already covers (pre-bootstrap / GC'd — mirrors _is_redundant_dep)."""
    from accord_tpu_torch.local.cfk import Unmanaged
    # Fast path: the CFK's min block point (lazy heap, O(log) amortised)
    # proves the gate clear without walking entries — our own entry cannot
    # be the sub-threshold min (its block point IS our executeAt).  The
    # exact walk runs only when genuinely blocked, to name a blocker to
    # chase and to apply per-store redundancy the CFK can't see.
    mbp = cfk._min_block_point()
    if mbp is None or mbp >= cmd.execute_at:
        return []
    rb = safe_store.store.redundant_before
    return cfk.blocking_ids(
        Unmanaged.APPLY, cmd.execute_at, cmd.txn_id, first_only=True,
        skip_pred=lambda t: rb.is_redundant(t, key))


def _recheck_key_gate(safe_store: SafeCommandStore, txn_id: TxnId,
                      key) -> None:
    """CFK notification: the key's wait rule may have cleared."""
    cmd = safe_store.if_present(txn_id)
    if cmd is None or cmd.waiting_on is None \
            or not cmd.waiting_on.is_waiting_on_key_at(key):
        return
    cfk = safe_store.cfk(key)
    blockers = _key_gate_blockers(safe_store, cfk, cmd, key)
    if blockers:
        # still blocked (e.g. a redundancy-aware recheck or a blocker
        # hand-over): re-arm the CFK registration if a fire consumed it,
        # and move the chase onto the current first blocker
        if not cfk.has_unmanaged(cmd.txn_id):
            _initialise_key_wait(safe_store, cmd, key)
        else:
            _chase_key_blocker(safe_store, cmd, blockers)
        return
    if cmd.waiting_on.remove_waiting_on_key(key):
        gated = safe_store.store.gated
        keys = gated.get(txn_id)
        if keys is not None:
            keys.discard(key)
            if not keys:
                gated.pop(txn_id, None)
        maybe_execute(safe_store, cmd, always_notify=False)


def _update_waiting_on_dep(safe_store: SafeCommandStore, cmd: Command,
                           dep_id: TxnId) -> None:
    """Evaluate one dep: clear it if terminal or ordered after us; otherwise
    listen for its transitions (Commands.shouldWaitOn semantics)."""
    waiting_on = cmd.waiting_on
    if waiting_on is None or not waiting_on.is_waiting_on(dep_id):
        return
    dep = safe_store.get(dep_id)
    if dep.is_applied_or_gone or dep.is_truncated:
        waiting_on.set_applied_or_invalidated(dep_id)
        return
    # redundant (GC'd / pre-bootstrap) deps need not be waited for
    if _is_redundant_dep(safe_store, cmd, dep_id):
        waiting_on.set_applied_or_invalidated(dep_id)
        return
    # sync points carry no writes: a dependency on one is satisfied once its
    # executeAt is decided — there is nothing of its to order reads/writes
    # against (the reference waits deps-only txns via WaitingOn.Commit)
    if dep_id.kind.is_sync_point and dep.has_been(SaveStatus.COMMITTED):
        waiting_on.remove_waiting_on(dep_id)
        dep.remove_listener(cmd.txn_id)
        return
    if dep.save_status.is_committed_to_execute and cmd.execute_at is not None \
            and dep.execute_at is not None and dep.execute_at > cmd.execute_at:
        # ordered after us; not our problem
        waiting_on.remove_waiting_on(dep_id)
        dep.remove_listener(cmd.txn_id)
        return
    dep.add_listener(cmd.txn_id)
    if not dep.has_been(SaveStatus.COMMITTED):
        safe_store.progress_log.waiting(
            dep_id, safe_store.store, "Committed", dep.route,
            cmd.route.participants() if cmd.route else None)
    elif not dep.has_been(SaveStatus.PRE_APPLIED):
        # committed here but the outcome never arrived (Apply lost): chase it
        # (the reference BlockedState with blockedUntil=HasOutcome)
        safe_store.progress_log.waiting(
            dep_id, safe_store.store, "Applied", dep.route,
            cmd.route.participants() if cmd.route else None)


def _is_redundant_dep(safe_store: SafeCommandStore, cmd: Command,
                      dep_id: TxnId) -> bool:
    """A dep below the local-applied or bootstrap watermark for EVERY
    participant through which we recorded it is already reflected in local
    state (applied, or frozen into the bootstrap snapshot) — don't wait on
    it (RedundantBefore dep pruning)."""
    rb = safe_store.store.redundant_before
    key_parts = None
    range_parts = None
    if cmd.stable_deps is not None:
        key_parts, range_parts = cmd.stable_deps.participants(dep_id)
        if not safe_store.ranges.is_empty:
            # only the locally-recorded participants matter: WaitingOn was
            # built from the store-sliced deps
            key_parts = key_parts.slice(safe_store.ranges)
            range_parts = range_parts.slice(safe_store.ranges)
    if (key_parts is None or len(key_parts) == 0) \
            and (range_parts is None or range_parts.is_empty):
        dep = safe_store.store.commands.get(dep_id)
        if dep is not None and dep.route is not None \
                and dep.route.is_key_domain:
            key_parts = dep.route.participants()
        else:
            return False
    if key_parts is not None:
        for k in key_parts:
            if not rb.is_redundant(dep_id, k):
                return False
    if range_parts is not None and not range_parts.is_empty:
        # every span intersecting the dep ranges must be covered AND
        # redundant — an interior never-bootstrapped sub-range keeps the
        # dependency live there (ADVICE r1: endpoint probes missed it)
        if not rb.is_all_redundant(dep_id, range_parts):
            return False
    return True


def update_dependency_and_maybe_execute(safe_store: SafeCommandStore,
                                        waiter: Command, dep: Command) -> None:
    """A dep transitioned; re-evaluate and maybe unblock the waiter
    (Commands.updateDependencyAndMaybeExecute :832)."""
    if waiter.has_been(SaveStatus.APPLIED) or waiter.waiting_on is None:
        return
    if dep.is_applied_or_gone or dep.is_truncated:
        if waiter.waiting_on.set_applied_or_invalidated(dep.txn_id):
            dep.remove_listener(waiter.txn_id)
            maybe_execute(safe_store, waiter, always_notify=False)
    else:
        _update_waiting_on_dep(safe_store, waiter, dep.txn_id)
        if not waiter.waiting_on.is_waiting:
            maybe_execute(safe_store, waiter, always_notify=False)


def re_evaluate_waiting(safe_store: SafeCommandStore) -> None:
    """Re-test every blocked dependency against the (advanced) redundancy
    watermarks — run after bootstrap completes, when deps below the fence
    became satisfiable-by-snapshot (Bootstrap.java markBootstrapComplete ->
    the reference's RedundantBefore-driven WaitingOn updates)."""
    for cmd in list(safe_store.store.commands.values()):
        waiting_on = cmd.waiting_on
        if waiting_on is not None and waiting_on.is_waiting:
            for dep_id in waiting_on.waiting_ids():
                _update_waiting_on_dep(safe_store, cmd, dep_id)
            for key in waiting_on.waiting_key_list():
                # advanced watermarks can satisfy a key gate without any CFK
                # transition (snapshot covers the blockers) — recheck
                _enqueue_notify(safe_store, ("key_unblock", cmd.txn_id, key))
        if cmd.save_status in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED) \
                and (waiting_on is None or not waiting_on.is_waiting):
            # includes applies that were deferred on un-bootstrapped ranges
            maybe_execute(safe_store, cmd, always_notify=False)


def maybe_execute(safe_store: SafeCommandStore, cmd: Command,
                  always_notify: bool) -> bool:
    """Advance Stable->ReadyToExecute->apply when the WaitingOn set clears
    (Commands.maybeExecute :656)."""
    WORK["maybe_execute"] += 1
    if cmd.save_status not in (SaveStatus.STABLE, SaveStatus.PRE_APPLIED):
        if always_notify:
            _notify_listeners(safe_store, cmd)
        return False
    if cmd.waiting_on is not None and cmd.waiting_on.is_waiting:
        if always_notify:
            _notify_listeners(safe_store, cmd)
        return False

    if cmd.save_status == SaveStatus.STABLE:
        cmd.set_status(SaveStatus.READY_TO_EXECUTE)
        safe_store.progress_log.update(safe_store.store, cmd.txn_id, cmd)
        _notify_listeners(safe_store, cmd)
        return True

    # PRE_APPLIED with no outstanding deps: run the writes — but never onto
    # a range whose bootstrap hasn't installed its snapshot yet (applying
    # out-of-band would interleave with the snapshot and diverge the
    # replica; the reference defers via safeToRead/unavailableToExecute)
    if not _safe_to_apply(safe_store, cmd):
        return False  # re-driven by re_evaluate_waiting after bootstrap
    cmd.set_status(SaveStatus.APPLYING)
    _apply_writes(safe_store, cmd)
    return True


def _safe_to_apply(safe_store: SafeCommandStore, cmd: Command) -> bool:
    if safe_store.ranges.is_empty:
        return True
    sel = None
    if cmd.partial_txn is not None:
        if isinstance(cmd.partial_txn.keys, Keys):
            # key-domain: share the identity-memoized owned slice that
            # register computes per transition
            sel = safe_store.owned_keys_of(cmd)
        else:
            sel = cmd.partial_txn.keys.slice(safe_store.ranges)
    elif cmd.route is not None:
        sel = cmd.route.slice(safe_store.ranges).participants()
    if sel is None:
        return True
    return safe_store.is_safe_to_read(sel)


def _apply_writes(safe_store: SafeCommandStore, cmd: Command) -> None:
    """Writes.apply against the DataStore, then postApply (Commands.applyChain
    :565-654)."""
    store = safe_store.store

    def post_apply(_v=None, failure=None):
        if failure is not None:
            safe_store.agent.on_uncaught_exception(failure)
            return
        # record execution timestamps per owned key
        for key in safe_store.owned_keys_of(cmd):
            tfk = safe_store.tfk(key)
            tfk.on_executed(cmd.execute_at, cmd.txn_id.kind.is_write)
        # NB: a locally-applied ESP must NOT advance the locally-applied
        # watermark: the bound is by TxnId, but a lower-id txn that the
        # ESP never witnessed (preaccept in flight during its deps calc)
        # can commit with executeAt AFTER the ESP — an id-based "all
        # applied" claim would wrongly clear it from waiters and reorder
        # writes. Only the durability fence (SetShardDurable universal,
        # whose witness gate stops new lower-id commits) and bootstrap
        # snapshots may advance redundancy watermarks.
        cmd.set_status(SaveStatus.APPLIED)
        safe_store.register(cmd, InternalStatus.APPLIED)
        safe_store.progress_log.update(store, cmd.txn_id, cmd)
        store.node.events.on_applied(cmd)
        _notify_listeners(safe_store, cmd)

    if cmd.writes is None or cmd.writes.is_empty:
        post_apply()
    else:
        within = safe_store.ranges if not safe_store.ranges.is_empty else None
        cmd.writes.apply(store.data_store, within).add_callback(post_apply)


def _notify_listeners(safe_store: SafeCommandStore, cmd: Command) -> None:
    """Notify durable (dependent commands) and transient listeners of a
    transition (see _enqueue_notify for the constant-stack drain)."""
    _enqueue_notify(safe_store, cmd.txn_id)


def _enqueue_notify(safe_store: SafeCommandStore, item) -> None:
    """Enqueue a notification and drain unless already draining. Items are
    either a TxnId (notify its listeners) or ("key_unblock", txn_id, key)
    (re-check a key gate).  Re-entrant calls enqueue onto the store-level
    drain queue so arbitrarily deep apply cascades use constant stack (the
    reference's NotifyWaitingOn walker, Commands.java:1011, achieves the
    same by running each step as a separate executor task)."""
    WORK["notify"] += 1
    store = safe_store.store
    store.notify_queue.append(item)
    if store.notifying:
        return
    store.notifying = True
    try:
        while store.notify_queue:
            entry = store.notify_queue.popleft()
            if isinstance(entry, tuple) and entry[0] == "key_unblock":
                _recheck_key_gate(safe_store, entry[1], entry[2])
                continue
            c = store.commands.get(entry)
            if c is None:
                continue
            for listener in list(c.transient_listeners):
                listener.on_change(safe_store, c)
            for waiter_id in sorted(c.listeners):
                waiter = store.commands.get(waiter_id)
                if waiter is None:
                    c.listeners.discard(waiter_id)
                    continue
                update_dependency_and_maybe_execute(safe_store, waiter, c)
    finally:
        store.notifying = False


# --------------------------------------------------------------- durability --

def set_durability(safe_store: SafeCommandStore, txn_id: TxnId,
                   durability: Durability) -> None:
    """(Commands.setDurability :978)"""
    cmd = safe_store.get(txn_id)
    if durability > cmd.durability:
        cmd.durability = durability
        safe_store.progress_log.durable(cmd)


# --------------------------------------------------------------- truncation --

def set_truncated_remotely(safe_store: SafeCommandStore, txn_id: TxnId,
                           execute_at: Optional[Timestamp] = None) -> bool:
    """Install a truncation learned from peers (full Infer ladder,
    reference Propagate's Infer.safeToCleanup arm): the interrogated
    quorum showed the txn durably decided+applied and SHED, with no
    outcome left to fetch — the local undecided copy can never decide
    (fence refusal) and the txn will never execute here, so local waiters
    must stop chasing it.  Mirrors purge()'s TRUNCATED_APPLY terminal
    without its already-durable invariant (the durability here is the
    REMOTE quorum's, witnessed through CheckStatus).  Returns True when
    the truncation was installed."""
    cmd = safe_store.get(txn_id)
    if cmd.save_status.is_decided or cmd.is_truncated:
        return False
    if execute_at is not None and cmd.execute_at is None:
        cmd.execute_at = execute_at
    cmd.partial_txn = None
    cmd.partial_deps = None
    cmd.stable_deps = None
    cmd.waiting_on = None
    safe_store.store.gated.pop(txn_id, None)
    note_status_transition(txn_id, cmd.save_status,
                           SaveStatus.TRUNCATED_APPLY)
    cmd.save_status = SaveStatus.TRUNCATED_APPLY
    safe_store.store.insufficient_catchups.pop(txn_id, None)
    safe_store.register(cmd, InternalStatus.INVALID_OR_TRUNCATED)
    safe_store.progress_log.clear(txn_id)
    _notify_listeners(safe_store, cmd)
    return True


def purge(safe_store: SafeCommandStore, txn_id: TxnId,
          erase: bool = False, keep_outcome: bool = False) -> None:
    """Truncate a durably-applied (or invalidated) command's local state
    (Commands.purge :879-967). `keep_outcome` retains writes/result (the
    reference's TRUNCATE_WITH_OUTCOME) so lagging replicas can still fetch
    the outcome through CheckStatus."""
    cmd = safe_store.get(txn_id)
    invariants.check_state(
        cmd.is_applied_or_gone or cmd.durability.is_durable,
        "cannot purge %s in state %s", txn_id, cmd.save_status.name)
    cmd.partial_txn = None
    cmd.partial_deps = None
    cmd.stable_deps = None
    cmd.waiting_on = None
    safe_store.store.gated.pop(txn_id, None)
    if not keep_outcome:
        cmd.writes = None
        cmd.result = None
    if cmd.is_invalidated:
        pass  # keep INVALIDATED as terminal state
    else:
        target = SaveStatus.ERASED if erase else SaveStatus.TRUNCATED_APPLY
        note_status_transition(txn_id, cmd.save_status, target)
        cmd.save_status = target
    _notify_listeners(safe_store, cmd)
