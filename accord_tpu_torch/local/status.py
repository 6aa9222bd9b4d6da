"""The command status lattice.

Reference: accord/local/Status.java:47-86 (Phase x Known vector),
SaveStatus.java:52-116 (local-knowledge refinements), Command.java state docs.

SaveStatus is the totally-ordered local progression
    NotDefined -> PreAccepted -> AcceptedInvalidate -> Accepted -> PreCommitted
    -> Committed -> Stable -> ReadyToExecute -> PreApplied -> Applying -> Applied
    -> TruncatedApply -> Erased | Invalidated
and Known is the partial-order knowledge vector {route, definition, executeAt,
deps, outcome} used by status interrogation / propagation (CheckStatus,
FetchData) to describe *what is known* independently of local progress.
"""

from __future__ import annotations

import enum
from typing import Optional


class Phase(enum.IntEnum):
    NONE = 0
    PRE_ACCEPT = 1
    ACCEPT = 2
    COMMIT = 3
    EXECUTE = 4
    PERSIST = 5
    CLEANUP = 6


class SaveStatus(enum.IntEnum):
    NOT_DEFINED = 0
    PRE_ACCEPTED = 10
    ACCEPTED_INVALIDATE = 20     # promised to invalidate; no executeAt proposed
    ACCEPTED = 30                # slow-path (executeAt, deps) accepted at ballot
    PRE_COMMITTED = 40           # executeAt known, definition maybe not
    COMMITTED = 50               # executeAt + deps known (not yet stable)
    STABLE = 60                  # deps stable; WaitingOn initialised
    READY_TO_EXECUTE = 65        # all waiting deps cleared
    PRE_APPLIED = 70             # outcome (writes/result) known, not yet applied
    APPLYING = 75
    APPLIED = 80
    TRUNCATED_APPLY = 90         # outcome durable elsewhere; local state shed
    ERASED = 95
    INVALIDATED = 100

    @property
    def phase(self) -> Phase:
        if self <= SaveStatus.NOT_DEFINED:
            return Phase.NONE
        if self <= SaveStatus.PRE_ACCEPTED:
            return Phase.PRE_ACCEPT
        if self <= SaveStatus.ACCEPTED:
            return Phase.ACCEPT
        if self <= SaveStatus.COMMITTED:
            return Phase.COMMIT
        if self <= SaveStatus.READY_TO_EXECUTE:
            return Phase.EXECUTE
        if self <= SaveStatus.APPLIED:
            return Phase.PERSIST
        return Phase.CLEANUP

    # -- knowledge predicates (Status.java hasBeen idiom) --
    def has_been(self, other: "SaveStatus") -> bool:
        return self >= other

    @property
    def is_defined(self) -> bool:
        """Definition (PartialTxn) is locally known (between PreAccepted and
        truncation)."""
        return (SaveStatus.PRE_ACCEPTED <= self < SaveStatus.TRUNCATED_APPLY
                and self != SaveStatus.ACCEPTED_INVALIDATE)

    @property
    def is_at_least_committed(self) -> bool:
        return self >= SaveStatus.COMMITTED and self != SaveStatus.INVALIDATED

    @property
    def is_at_least_stable(self) -> bool:
        return (SaveStatus.STABLE <= self <= SaveStatus.TRUNCATED_APPLY)

    @property
    def is_decided(self) -> bool:
        """Outcome decided: executeAt fixed (PreCommitted+) or invalidated."""
        return self >= SaveStatus.PRE_COMMITTED

    @property
    def is_truncated(self) -> bool:
        return self in (SaveStatus.TRUNCATED_APPLY, SaveStatus.ERASED)

    @property
    def is_invalidated(self) -> bool:
        return self == SaveStatus.INVALIDATED

    @property
    def is_applied_or_gone(self) -> bool:
        """Terminal for execution ordering: dependents need not wait."""
        return self >= SaveStatus.APPLIED

    @property
    def is_committed_to_execute(self) -> bool:
        """Committed with a real executeAt (not invalidated)."""
        return (self >= SaveStatus.COMMITTED and self <= SaveStatus.TRUNCATED_APPLY)

    def known(self) -> "Known":
        """Project local progress onto the Known knowledge vector."""
        if self == SaveStatus.NOT_DEFINED:
            return Known.NOTHING
        if self == SaveStatus.INVALIDATED:
            return Known.INVALIDATED
        if self.is_truncated:
            # decision reached but deps cleaned up: ERASED, not NO — so a
            # per-range knowledge reduce over a truncated source degrades
            # below STABLE instead of masquerading as decided deps
            return Known(KnownRoute.MAYBE, KnownDefinition.NO,
                         KnownExecuteAt.YES, KnownDeps.ERASED,
                         KnownOutcome.APPLY)
        route = KnownRoute.FULL
        definition = (KnownDefinition.YES if self.is_defined else KnownDefinition.NO)
        if self >= SaveStatus.PRE_APPLIED:
            return Known(route, definition, KnownExecuteAt.YES,
                         KnownDeps.STABLE, KnownOutcome.APPLY)
        if self >= SaveStatus.STABLE:
            return Known(route, definition, KnownExecuteAt.YES,
                         KnownDeps.STABLE, KnownOutcome.UNKNOWN)
        if self >= SaveStatus.COMMITTED:
            return Known(route, definition, KnownExecuteAt.YES,
                         KnownDeps.COMMITTED, KnownOutcome.UNKNOWN)
        if self >= SaveStatus.PRE_COMMITTED:
            return Known(route, definition, KnownExecuteAt.YES,
                         KnownDeps.UNKNOWN, KnownOutcome.UNKNOWN)
        if self >= SaveStatus.ACCEPTED:
            return Known(route, definition, KnownExecuteAt.PROPOSED,
                         KnownDeps.PROPOSED, KnownOutcome.UNKNOWN)
        # PRE_ACCEPTED / ACCEPTED_INVALIDATE: no coordinator proposal held —
        # deps are unknown here (reference Status.java:51: only Accepted
        # carries DepsProposed)
        if self >= SaveStatus.PRE_ACCEPTED:
            return Known(route, definition, KnownExecuteAt.PROPOSED,
                         KnownDeps.UNKNOWN, KnownOutcome.UNKNOWN)
        return Known.NOTHING


class Durability(enum.IntEnum):
    """Global durability classification (reference Status.Durability:
    NotDurable / Local / ShardUniversal / MajorityOrInvalidated /
    UniversalOrInvalidated — the top two absorb invalidation)."""

    NOT_DURABLE = 0
    LOCAL = 1                    # applied locally
    SHARD_UNIVERSAL = 2          # applied at every live replica of home shard
    MAJORITY = 3                 # applied at a majority of every shard (or invalidated)
    UNIVERSAL = 4                # applied at every replica of every shard (or invalidated)

    @property
    def is_durable(self) -> bool:
        return self >= Durability.MAJORITY


class ProgressToken:
    """Comparable progress summary (primitives/ProgressToken.java): ordered
    by durability, then status, then promised ballot, then whether the
    promise was accepted — so a liveness monitor can tell 'someone is
    moving this txn' even when only durability or a ballot advanced."""

    __slots__ = ("durability", "status", "promised", "is_accepted")

    NONE: "ProgressToken"

    def __init__(self, durability: "Durability", status: "SaveStatus",
                 promised, is_accepted: bool):
        self.durability = durability
        self.status = status
        self.promised = promised
        self.is_accepted = is_accepted

    @classmethod
    def of(cls, durability: "Durability", status: "SaveStatus", promised,
           accepted) -> "ProgressToken":
        """The one place the is-accepted rule lives: the promise counts as
        accepted once the Accept phase ratified that very ballot."""
        return cls(durability, status, promised,
                   status.phase >= Phase.ACCEPT and accepted == promised)

    @property
    def phase(self) -> Phase:
        return self.status.phase

    def _key(self):
        return (self.durability, self.status, self.promised,
                self.is_accepted)

    def __lt__(self, other):
        return self._key() < other._key()

    def __le__(self, other):
        return self._key() <= other._key()

    def __gt__(self, other):
        return self._key() > other._key()

    def __ge__(self, other):
        return self._key() >= other._key()

    def __eq__(self, other):
        return isinstance(other, ProgressToken) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"ProgressToken({self.durability.name}, {self.status.name}, "
                f"{self.promised!r}{', accepted' if self.is_accepted else ''})")


def _progress_token_none() -> ProgressToken:
    from accord_tpu_torch.primitives.timestamp import Ballot
    return ProgressToken.of(Durability.NOT_DURABLE, SaveStatus.NOT_DEFINED,
                            Ballot.ZERO, Ballot.ZERO)


class KnownRoute(enum.IntEnum):
    MAYBE = 0
    COVERING = 1
    FULL = 2


class KnownDefinition(enum.IntEnum):
    NO = 0
    YES = 1


class KnownExecuteAt(enum.IntEnum):
    UNKNOWN = 0
    PROPOSED = 1
    YES = 2
    NO = 3          # invalidated


class KnownDeps(enum.IntEnum):
    """Reference Status.KnownDeps:539 order: ERASED (deps cleaned up by
    truncation) sorts BELOW STABLE so min-style reduces degrade a
    stable∧erased mix to not-stable, while NO (invalidated — deps never
    needed) sorts above everything."""
    UNKNOWN = 0
    PROPOSED = 1
    COMMITTED = 2
    ERASED = 3      # decision reached, deps cleaned up (DepsErased)
    STABLE = 4
    NO = 5          # invalidated (NoDeps)


class KnownOutcome(enum.IntEnum):
    UNKNOWN = 0
    APPLY = 1       # writes/result known
    INVALIDATED = 2
    ERASED = 3


class InvalidIf(enum.IntEnum):
    """Invalidation-evidence lattice carried per range on CheckStatus
    replies (reference coordinate/Infer.InvalidIf): each point names the
    CONDITION under which the replying replica's durability state proves
    the transaction invalid.  Totally ordered by evidence strength —
    lattice join is max — so merging replies keeps the strongest proof.

    IF_UNDECIDED: the txn sits below the replica's majority-durable fence
    (DurableBefore), which certifies everything beneath it as
    majority-applied-or-invalidated; a quorum of such replies that all
    find the txn undecided therefore proves it was never decided — and,
    with the fence-refusal rule (local/commands.py is_durably_fenced),
    never can be.  IF_UNCOMMITTED: additionally below the shard-applied
    fence (every replica applied the exclusive sync point and refuses new
    witnesses).  IS_INVALID: locally known invalidated."""

    NOT_KNOWN_TO_BE_INVALID = 0
    IF_UNDECIDED = 1
    IF_UNCOMMITTED = 2
    IS_INVALID = 3


class Known:
    """The knowledge vector lattice (Status.java:124+): per-field max-merge."""

    __slots__ = ("route", "definition", "execute_at", "deps", "outcome",
                 "invalid_if")

    NOTHING: "Known"
    INVALIDATED: "Known"

    def __init__(self, route: KnownRoute, definition: KnownDefinition,
                 execute_at: KnownExecuteAt, deps: KnownDeps,
                 outcome: KnownOutcome,
                 invalid_if: InvalidIf = InvalidIf.NOT_KNOWN_TO_BE_INVALID):
        self.route = route
        self.definition = definition
        self.execute_at = execute_at
        self.deps = deps
        self.outcome = outcome
        self.invalid_if = invalid_if

    def with_invalid_if(self, invalid_if: InvalidIf) -> "Known":
        return Known(self.route, self.definition, self.execute_at,
                     self.deps, self.outcome, invalid_if)

    def at_least(self, other: "Known") -> "Known":
        return Known(max(self.route, other.route),
                     max(self.definition, other.definition),
                     max(self.execute_at, other.execute_at),
                     max(self.deps, other.deps),
                     max(self.outcome, other.outcome),
                     max(self.invalid_if, other.invalid_if))

    merge = at_least

    def reduce(self, other: "Known") -> "Known":
        """The knowledge valid across BOTH sources' ranges (reference
        Status.Known.reduce:171): per-range facts — the definition body and
        the dependency set — take the minimum, because each range only knows
        what its own replica reported; global facts — executeAt and the
        outcome — take the maximum, because deciding either anywhere decides
        it everywhere; and the route is FULL only if some source held the
        full route (a COVERING route covers only its own ranges)."""
        if self.route == other.route:
            route = self.route
        elif KnownRoute.FULL in (self.route, other.route):
            route = KnownRoute.FULL
        else:
            route = KnownRoute.MAYBE
        return Known(route,
                     min(self.definition, other.definition),
                     max(self.execute_at, other.execute_at),
                     min(self.deps, other.deps),
                     max(self.outcome, other.outcome),
                     # invalidation evidence is GLOBAL (a txn commits
                     # everywhere or nowhere): one range's durability fence
                     # condemns the whole txn, so the reduce joins like
                     # executeAt/outcome rather than taking the minimum
                     max(self.invalid_if, other.invalid_if))

    def satisfies(self, required: "Known") -> bool:
        return (self.route >= required.route
                and self.definition >= required.definition
                and self.execute_at >= required.execute_at
                and self.deps >= required.deps
                and self.outcome >= required.outcome
                and self.invalid_if >= required.invalid_if)

    @property
    def is_invalidated(self) -> bool:
        return self.outcome == KnownOutcome.INVALIDATED

    def __eq__(self, other):
        return (isinstance(other, Known)
                and self.route == other.route
                and self.definition == other.definition
                and self.execute_at == other.execute_at
                and self.deps == other.deps
                and self.outcome == other.outcome
                and self.invalid_if == other.invalid_if)

    def __hash__(self):
        return hash((self.route, self.definition, self.execute_at, self.deps,
                     self.outcome, self.invalid_if))

    def __repr__(self):
        return (f"Known(route={self.route.name}, def={self.definition.name}, "
                f"at={self.execute_at.name}, deps={self.deps.name}, "
                f"out={self.outcome.name}"
                + (f", inv={self.invalid_if.name}"
                   if self.invalid_if != InvalidIf.NOT_KNOWN_TO_BE_INVALID
                   else "") + ")")


Known.NOTHING = Known(KnownRoute.MAYBE, KnownDefinition.NO,
                      KnownExecuteAt.UNKNOWN, KnownDeps.UNKNOWN,
                      KnownOutcome.UNKNOWN)
Known.INVALIDATED = Known(KnownRoute.MAYBE, KnownDefinition.NO,
                          KnownExecuteAt.NO, KnownDeps.NO,
                          KnownOutcome.INVALIDATED, InvalidIf.IS_INVALID)

# Common knowledge targets used by FetchData/CheckStatus (reference Known statics)
KNOWN_COMMITTED = Known(KnownRoute.COVERING, KnownDefinition.NO,
                        KnownExecuteAt.YES, KnownDeps.UNKNOWN,
                        KnownOutcome.UNKNOWN)
KNOWN_STABLE = Known(KnownRoute.COVERING, KnownDefinition.YES,
                     KnownExecuteAt.YES, KnownDeps.STABLE,
                     KnownOutcome.UNKNOWN)
KNOWN_APPLY = Known(KnownRoute.COVERING, KnownDefinition.YES,
                    KnownExecuteAt.YES, KnownDeps.STABLE, KnownOutcome.APPLY)

ProgressToken.NONE = _progress_token_none()
