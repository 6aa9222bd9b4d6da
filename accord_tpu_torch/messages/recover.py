"""BeginRecovery: the recovery voting round.

Reference: accord/messages/BeginRecovery.java:55 — per-shard Commands.recover
(ballot gate) then the fast-path-decipher predicates via mapReduceFull
(:104-190); RecoverOk carries {status, accepted ballot, executeAt, deps,
earlierCommittedWitness, earlierAcceptedNoWitness, rejectsFastPath, writes,
result}; RecoverNack carries the superseding promise.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands as C
from accord_tpu_torch.local.status import InvalidIf, KnownDeps, SaveStatus
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Key, Keys, Route
from accord_tpu_torch.primitives.latest_deps import LatestDeps
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes


class RecoverOk(Reply):
    type = MessageType.BEGIN_RECOVER_RSP

    def __init__(self, txn_id: TxnId, status: SaveStatus,
                 accepted_ballot: Ballot, execute_at: Optional[Timestamp],
                 latest_deps: LatestDeps, partial_txn: Optional[PartialTxn],
                 writes: Optional[Writes], result,
                 rejects_fast_path: bool,
                 earlier_committed_witness: Deps,
                 earlier_no_witness: Deps,
                 unresolved_covers: Deps = Deps.NONE,
                 invalid_if: InvalidIf = InvalidIf.NOT_KNOWN_TO_BE_INVALID):
        self.txn_id = txn_id
        self.status = status
        self.accepted_ballot = accepted_ballot
        self.execute_at = execute_at
        # per-range KnownDeps-aware deps knowledge: local PreAccept-style
        # calculations, Accept-round proposals with their ballots, and
        # committed deps, merged range-wise across the quorum
        self.latest_deps = latest_deps
        self.partial_txn = partial_txn
        self.writes = writes
        self.result = result
        self.rejects_fast_path = rejects_fast_path
        self.earlier_committed_witness = earlier_committed_witness
        self.earlier_no_witness = earlier_no_witness
        # write deps whose undecided commit status makes this replica's
        # omission evidence inconclusive (CommandsForKey.omission_covers):
        # the coordinator must await their commit and retry before reading
        # the fast-path decipher either way
        self.unresolved_covers = unresolved_covers
        # durability-derived invalidation evidence (coordinate/infer.py):
        # the strongest InvalidIf condition this replica's watermarks
        # justify over the queried participants, attached only when the
        # txn is locally undecided.  A per-shard quorum of these lets the
        # recovering coordinator commit invalidation off its own promise
        # round, skipping the ProposeInvalidate round entirely
        self.invalid_if = invalid_if

    @property
    def witnessed_at_original(self) -> bool:
        """Could this replica have cast a fast-path vote in the PreAccept
        round? True iff it had witnessed the txn at its original timestamp."""
        return self.execute_at is not None \
            and self.execute_at == self.txn_id.as_timestamp()

    def _rank(self):
        """Cross-reply ranking key (reference Status.max over phase +
        acceptedOrCommitted ballot): ACCEPTED and ACCEPTED_INVALIDATE are
        the SAME phase and compete by BALLOT — a higher-ballot promise to
        invalidate supersedes a lower-ballot accepted proposal and vice
        versa. Ranking them by status first let a recovery re-propose a
        stale ballot-zero Accept over a decided higher-ballot invalidation,
        splitting replicas between STABLE and INVALIDATED (burn seed 6000).
        Decided statuses (PreCommitted+) still dominate every accept."""
        phase = (SaveStatus.ACCEPTED
                 if self.status in (SaveStatus.ACCEPTED,
                                    SaveStatus.ACCEPTED_INVALIDATE)
                 else self.status)
        return (phase, self.accepted_ballot, self.status)

    def merge(self, other: "RecoverOk") -> "RecoverOk":
        """Cross-shard / cross-node knowledge union (BeginRecovery.reduce;
        `hi` per _rank — for the accept phase the highest-ballot proposal
        is the one recovery must adopt)."""
        hi, lo = ((self, other) if self._rank() >= other._rank()
                  else (other, self))
        accepted_ballot = max(self.accepted_ballot, other.accepted_ballot)
        partial_txn = (self.partial_txn.with_(other.partial_txn)
                       if self.partial_txn is not None
                       and other.partial_txn is not None
                       else self.partial_txn or other.partial_txn)
        writes = (hi.writes.merge(lo.writes) if hi.writes is not None
                  else lo.writes)
        witness = self.earlier_committed_witness.with_(
            other.earlier_committed_witness)
        no_witness = self.earlier_no_witness.with_(
            other.earlier_no_witness).without(witness.contains)
        return RecoverOk(
            self.txn_id, hi.status, accepted_ballot, hi.execute_at,
            self.latest_deps.merge(other.latest_deps), partial_txn,
            writes,
            hi.result if hi.result is not None else lo.result,
            self.rejects_fast_path or other.rejects_fast_path,
            witness, no_witness,
            self.unresolved_covers.with_(other.unresolved_covers),
            invalid_if=max(self.invalid_if, other.invalid_if))

    def __repr__(self):
        return (f"RecoverOk({self.txn_id!r}, {self.status.name}, "
                f"rejectsFP={self.rejects_fast_path})")


class RecoverNack(Reply):
    type = MessageType.BEGIN_RECOVER_RSP

    def __init__(self, superseded_by: Ballot):
        self.superseded_by = superseded_by

    def __repr__(self):
        return f"RecoverNack({self.superseded_by!r})"


class BeginRecovery(TxnRequest):
    type = MessageType.BEGIN_RECOVER_REQ

    def __init__(self, txn_id: TxnId, scope: Route, ballot: Ballot,
                 partial_txn: Optional[PartialTxn] = None,
                 full_route: Route = None):
        super().__init__(txn_id, scope, full_route=full_route)
        self.ballot = ballot
        # definition is optional: the recovering coordinator sends its local
        # slice if it has one; replicas that witnessed keep their own
        self.partial_txn = partial_txn

    def apply(self, safe_store) -> Reply:
        from accord_tpu_torch.coordinate.infer import invalid_if_local
        outcome, cmd = C.recover(safe_store, self.txn_id, self.partial_txn,
                                 self.route, self.ballot)
        if outcome == C.AcceptOutcome.REJECTED_BALLOT:
            return RecoverNack(cmd.promised)
        if outcome == C.AcceptOutcome.TRUNCATED:
            # genuinely invalidated, locally shed, or a fence REFUSAL
            # (Commands.recover's durable-fence gate): report what we know,
            # attaching the InvalidIf evidence when undecided so the
            # coordinator can fold a quorum of refusals into a no-round
            # commit-invalidate (coordinate/infer.py)
            evidence = InvalidIf.NOT_KNOWN_TO_BE_INVALID
            if cmd.save_status == SaveStatus.INVALIDATED:
                evidence = InvalidIf.IS_INVALID
            elif not cmd.save_status.is_decided:
                evidence = invalid_if_local(
                    safe_store, self.txn_id,
                    self._local_keys(safe_store, cmd))
            return RecoverOk(self.txn_id, cmd.save_status, cmd.accepted_ballot,
                             cmd.execute_at, LatestDeps.EMPTY, None,
                             None, None, False, Deps.NONE, Deps.NONE,
                             invalid_if=evidence)

        keys = self._local_keys(safe_store, cmd)
        local_deps = None
        rejects = False
        earlier_witness = Deps.NONE
        earlier_no_witness = Deps.NONE
        unresolved_covers = Deps.NONE
        known_deps = cmd.known().deps
        if known_deps < KnownDeps.COMMITTED:
            # no committed/decided deps held here: contribute a fresh local
            # calculation — including for PRE_COMMITTED replicas, whose
            # executeAt arrived by Propagate without deps
            # (BeginRecovery.java:115-119 hasCommittedOrDecidedDeps gate)
            local_deps = C.calculate_deps(safe_store, self.txn_id, keys,
                                          before=self.txn_id)
        if not cmd.has_been(SaveStatus.PRE_COMMITTED):
            # fast-path decipher predicates only matter pre-decision
            rejects, unresolved_covers = safe_store.decipher_fast_path(
                self.txn_id, keys)
            earlier_witness = safe_store.earlier_committed_witness(
                self.txn_id, keys)
            earlier_no_witness = safe_store.earlier_accepted_no_witness(
                self.txn_id, keys)
        # coordinated = whatever a coordinator durably handed us: the Accept
        # proposal (PROPOSED) or the commit's deps (COMMITTED/STABLE)
        coordinated = (cmd.stable_deps if cmd.stable_deps is not None
                       else cmd.partial_deps)
        latest = LatestDeps.create(safe_store.ranges, known_deps,
                                   cmd.accepted_ballot, coordinated,
                                   local_deps)
        evidence = (invalid_if_local(safe_store, self.txn_id, keys)
                    if not cmd.save_status.is_decided
                    else InvalidIf.NOT_KNOWN_TO_BE_INVALID)
        return RecoverOk(
            self.txn_id, cmd.save_status, cmd.accepted_ballot, cmd.execute_at,
            latest, cmd.partial_txn, cmd.writes, cmd.result,
            rejects, earlier_witness, earlier_no_witness, unresolved_covers,
            invalid_if=evidence)

    def _local_keys(self, safe_store, cmd):
        """Participants (Keys or Ranges) for deps calc + decipher predicates."""
        if cmd.partial_txn is not None:
            return cmd.partial_txn.keys
        if self.partial_txn is not None:
            return self.partial_txn.keys
        if not self.scope.is_key_domain:
            return self.scope.ranges
        return self.scope.participant_keys()

    def recovery_probe(self):
        # Keys OR Ranges: the device store materializes a Ranges probe into
        # the CFK keys inside the ranges at snapshot time (the per-key
        # predicate tier a range-domain recovery walks), with serve-time
        # cover/version gates guarding any divergence
        if self.partial_txn is not None:
            return (self.txn_id, self.partial_txn.keys)
        if self.scope.is_key_domain:
            return (self.txn_id, self.scope.participant_keys())
        return (self.txn_id, self.scope.ranges)

    def deps_probe(self):
        # apply() also contributes a fresh local deps calculation when no
        # committed deps are held (calculate_deps at before=txn_id); declare
        # it so the device window precomputes it alongside the recovery
        # predicates.  The serve-time key set (_local_keys, state-dependent)
        # must be covered by this declaration or the scan falls back to the
        # scalar walk — which the cover/version gates enforce.
        keys = (self.partial_txn.keys if self.partial_txn is not None
                else (self.scope.participant_keys()
                      if self.scope.is_key_domain else self.scope.ranges))
        return (self.txn_id, self.txn_id.kind.witnesses(), keys)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        if isinstance(a, RecoverNack):
            return a
        if isinstance(b, RecoverNack):
            return b
        assert isinstance(a, RecoverOk) and isinstance(b, RecoverOk)
        return a.merge(b)

    def __repr__(self):
        return f"BeginRecovery({self.txn_id!r}, b={self.ballot!r})"
