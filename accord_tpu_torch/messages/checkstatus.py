"""CheckStatus: interrogate peers about a transaction, merging knowledge.

Reference: accord/messages/CheckStatus.java:78 — IncludeInfo levels (No/
Route/All), CheckStatusOk / CheckStatusOkFull replies whose `merge` keeps the
maximum knowledge per field. Used by FindRoute (route discovery), MaybeRecover
(has anyone progressed?), and FetchData (pull definition/deps/outcome).
"""

from __future__ import annotations

import enum
from typing import Optional

from accord_tpu_torch.local.status import (Durability, InvalidIf, Known,
                                     ProgressToken, SaveStatus)
from accord_tpu_torch.messages.base import MessageType, Reply, TxnRequest
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Range, Ranges, Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes
from accord_tpu_torch.utils.interval_map import ReducingRangeMap


class IncludeInfo(enum.Enum):
    NO = "No"
    ROUTE = "Route"
    ALL = "All"


def _token_spans(participants):
    """[(start, end)) token spans of a Keys/RoutingKeys or Ranges selection."""
    if isinstance(participants, Range):
        return [(participants.start, participants.end)]
    if not isinstance(participants, Ranges):
        participants = participants.to_ranges()
    return [(r.start, r.end) for r in participants]


class KnownMap:
    """Per-range knowledge provenance (reference CheckStatus.FoundKnownMap:
    298): which Known vector is justified over which token spans. Each
    replying replica builds one over the participants its store actually
    covers; merging replies takes the range-wise at_least; consumers ask
    known_for(owned) — Known.reduce across every owned span, with
    Known.NOTHING standing in for any uncovered gap — so a partial-quorum
    merge cannot overclaim per-range knowledge (definition, deps) for shards
    that never replied, while still crediting global facts (executeAt,
    outcome) decided anywhere (FoundKnownMap.knownFor)."""

    __slots__ = ("_map",)

    EMPTY: "KnownMap"

    def __init__(self, _map: Optional[ReducingRangeMap] = None):
        self._map = _map if _map is not None else ReducingRangeMap()

    @classmethod
    def create(cls, participants, known: Known) -> "KnownMap":
        m = ReducingRangeMap()
        for s, e in _token_spans(participants):
            m = m.update(s, e, known, Known.at_least)
        return cls(m)

    def merge(self, other: "KnownMap") -> "KnownMap":
        return KnownMap(self._map.merge(other._map, Known.at_least))

    def known_for(self, participants) -> Known:
        """The Known vector valid across ALL the given participants."""
        def f(acc, v):
            k = v if v is not None else Known.NOTHING
            return k if acc is None else acc.reduce(k)

        acc = None
        for s, e in _token_spans(participants):
            acc = self._map.fold_intersecting(s, e, f, acc)
        return acc if acc is not None else Known.NOTHING

    def known_for_any(self) -> Known:
        """The at_least union over every span (FoundKnownMap.knownForAny)."""
        acc = Known.NOTHING
        for _s, _e, v in self._map.spans():
            if v is not None:
                acc = acc.at_least(v)
        return acc

    def __eq__(self, other):
        return isinstance(other, KnownMap) and self._map == other._map

    def __repr__(self):
        return f"KnownMap({self._map!r})"


KnownMap.EMPTY = KnownMap()


class CheckStatusOk(Reply):
    """Everything one replica knows (CheckStatus.CheckStatusOk; with
    include_info=ALL also the Full fields: definition, deps, outcome)."""

    type = MessageType.CHECK_STATUS_RSP

    def __init__(self, save_status: SaveStatus, promised: Ballot,
                 accepted: Ballot, execute_at: Optional[Timestamp],
                 durability: Durability, route: Optional[Route],
                 is_coordinating: bool = False,
                 partial_txn: Optional[PartialTxn] = None,
                 stable_deps: Optional[Deps] = None,
                 writes: Optional[Writes] = None, result=None,
                 invalid_if_undecided: bool = False,
                 known_map: Optional[KnownMap] = None):
        self.save_status = save_status
        self.promised = promised
        self.accepted = accepted
        self.execute_at = execute_at
        self.durability = durability
        self.route = route
        self.is_coordinating = is_coordinating
        self.partial_txn = partial_txn
        self.stable_deps = stable_deps
        self.writes = writes
        self.result = result
        # durability-derived evidence this txn is headed for invalidation
        # (coordinate/infer.py); under ACCORD_INFER_FULL=0 it steers the
        # fetcher's escalation into the ballot-backed Invalidate round;
        # the full ladder instead reads the per-range InvalidIf lattice
        # carried inside known_map (see invalid_if below)
        self.invalid_if_undecided = invalid_if_undecided
        # per-range knowledge provenance; None only for legacy/hand-built
        # replies, in which case known_for falls back to the global vector
        self.known_map = known_map

    def merge(self, other: "CheckStatusOk") -> "CheckStatusOk":
        """Field-wise maximum knowledge (CheckStatusOk.merge)."""
        hi, lo = (self, other) if self.save_status >= other.save_status \
            else (other, self)
        route = hi.route
        if route is None or (lo.route is not None and lo.route.is_full
                             and not route.is_full):
            route = lo.route if lo.route is not None else route
        elif route is not None and lo.route is not None \
                and not route.is_full and not lo.route.is_full:
            route = route.with_(lo.route)
        return CheckStatusOk(
            hi.save_status,
            Ballot.max(self.promised, other.promised),
            Ballot.max(self.accepted, other.accepted),
            hi.execute_at if hi.execute_at is not None else lo.execute_at,
            max(self.durability, other.durability),
            route,
            self.is_coordinating or other.is_coordinating,
            # UNION the definitions (RecoverOk.merge does the same):
            # replicas hold slices of the txn body; keeping just one side
            # could later reconstitute a partial body as the whole txn and
            # silently drop other shards' reads/updates
            (hi.partial_txn.with_(lo.partial_txn)
             if hi.partial_txn is not None and lo.partial_txn is not None
             else hi.partial_txn if hi.partial_txn is not None
             else lo.partial_txn),
            # UNION the stable deps too (CheckStatusOkFull.merge:820-822
            # `fullMax.stableDeps.with(fullMin.stableDeps)`): each STABLE
            # replica holds the deps slice for ITS ranges only; keeping one
            # side would leave the known_map claiming deps-STABLE over
            # ranges whose actual deps were on the discarded side
            (hi.stable_deps.with_(lo.stable_deps)
             if hi.stable_deps is not None and lo.stable_deps is not None
             else hi.stable_deps if hi.stable_deps is not None
             else lo.stable_deps),
            # reunite writes: commands now store the FULL writes (Apply no
            # longer slices at store time), but replies from older partial
            # applications or hand-built sources may still carry slices —
            # the union is correct either way and costs one keys merge
            (hi.writes.merge(lo.writes) if hi.writes is not None
             else lo.writes),
            hi.result if hi.result is not None else lo.result,
            invalid_if_undecided=(self.invalid_if_undecided
                                  or other.invalid_if_undecided),
            known_map=(None if self.known_map is None
                       and other.known_map is None
                       else (self.known_map or KnownMap.EMPTY).merge(
                           other.known_map or KnownMap.EMPTY)),
        )

    def known_for(self, participants) -> Known:
        """The Known vector justified across ALL the given participants —
        Propagate's gate for per-store application (CheckStatusOk via
        FoundKnownMap.knownFor). Falls back to the global projection for
        hand-built replies with no provenance map."""
        if self.known_map is None:
            return self.save_status.known()
        return self.known_map.known_for(participants)

    @property
    def invalid_if(self) -> InvalidIf:
        """The strongest per-range invalidation condition any span of this
        reply carries (Infer.InvalidIf via the KnownMap lattice join) —
        evidence is global, so the span-wise at_least union is the reply's
        claim.  Legacy replies degrade to the boolean projection."""
        if self.known_map is None:
            return (InvalidIf.IF_UNDECIDED if self.invalid_if_undecided
                    else InvalidIf.NOT_KNOWN_TO_BE_INVALID)
        return self.known_map.known_for_any().invalid_if

    def to_progress_token(self) -> ProgressToken:
        """Progress summary for liveness comparisons
        (CheckStatusOk.toProgressToken)."""
        return ProgressToken.of(self.durability, self.save_status,
                                self.promised, self.accepted)

    def __repr__(self):
        return (f"CheckStatusOk({self.save_status.name}, "
                f"at={self.execute_at!r}, route={self.route!r})")


class CheckStatusNack(Reply):
    type = MessageType.CHECK_STATUS_RSP

    def __repr__(self):
        return "CheckStatusNack"


class CheckStatus(TxnRequest):
    type = MessageType.CHECK_STATUS_REQ

    def __init__(self, txn_id: TxnId, scope: Route,
                 include_info: IncludeInfo = IncludeInfo.ROUTE):
        super().__init__(txn_id, scope)
        self.include_info = include_info

    def apply(self, safe_store) -> Reply:
        from accord_tpu_torch.coordinate.infer import (invalid_if_for_span,
                                                 invalid_if_undecided)
        cmd = safe_store.if_present(self.txn_id)
        undecided = cmd is None or not cmd.save_status.is_decided
        proof = (undecided and invalid_if_undecided(
            safe_store, self.txn_id, self.scope.participants()))
        # provenance: this store's knowledge applies only to the scope slice
        # its ranges actually cover (FoundKnownMap.create over command-store
        # ranges, CheckStatus.java:326)
        owned = self.scope.owned_participants(safe_store.ranges)
        known = (Known.NOTHING if cmd is None else cmd.save_status.known())
        if undecided:
            # attach the per-range InvalidIf lattice (Infer.invalidIfNot):
            # each owned span reports the strongest condition ITS durability
            # watermarks justify, so a partial-quorum merge cannot borrow
            # one shard's fence for another's spans
            m = ReducingRangeMap()
            for s, e in _token_spans(owned):
                k = known.with_invalid_if(
                    invalid_if_for_span(safe_store, self.txn_id, s, e))
                m = m.update(s, e, k, Known.at_least)
            known_map = KnownMap(m)
        else:
            known_map = KnownMap.create(owned, known)
        if cmd is None:
            return CheckStatusOk(SaveStatus.NOT_DEFINED, Ballot.ZERO,
                                 Ballot.ZERO, None, Durability.NOT_DURABLE,
                                 None, invalid_if_undecided=proof,
                                 known_map=known_map)
        full = self.include_info == IncludeInfo.ALL
        return CheckStatusOk(
            cmd.save_status, cmd.promised, cmd.accepted_ballot,
            cmd.execute_at, cmd.durability,
            cmd.route if self.include_info != IncludeInfo.NO else None,
            is_coordinating=self.txn_id in safe_store.node.coordinating,
            partial_txn=cmd.partial_txn if full else None,
            stable_deps=cmd.stable_deps if full else None,
            writes=cmd.writes if full else None,
            result=cmd.result if full else None,
            invalid_if_undecided=proof,
            known_map=known_map)

    def reduce(self, a: Reply, b: Reply) -> Reply:
        if isinstance(a, CheckStatusNack):
            return b
        if isinstance(b, CheckStatusNack):
            return a
        return a.merge(b)

    def __repr__(self):
        return f"CheckStatus({self.txn_id!r}, {self.include_info.value})"
