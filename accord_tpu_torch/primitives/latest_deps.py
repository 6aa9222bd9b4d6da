"""LatestDeps: per-range, knowledge-level-aware dependency merging for
recovery.

Reference: accord/primitives/LatestDeps.java (429 LoC) — each BeginRecovery
reply describes, for every key range the replica covers, HOW WELL it knows the
txn's deps there (KnownDeps level), at what accepted ballot, with which
coordinator-proposed deps and which freshly-calculated local deps. Merging
replies range-by-range lets recovery survive mixed-status quorums: a range
where one replica holds committed deps wins outright; a range where two
replicas hold competing Accept-round proposals resolves by ballot; a range
nobody decided falls back to the union of local calculations.

Our layout: a ReducingIntervalMap over integer tokens holding immutable
LatestDepsEntry values. Entry deps are NOT pre-sliced to their interval —
extraction (`merge_proposal` / `merge_commit`) slices, which keeps merges
allocation-free (the reference's Merge buffer plays the same trick,
LatestDeps.java:246-251).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from accord_tpu_torch.local.status import KnownDeps
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Range, Ranges
from accord_tpu_torch.primitives.timestamp import Ballot
from accord_tpu_torch.utils.interval_map import ReducingIntervalMap


class LatestDepsEntry:
    """One range's deps knowledge (LatestDeps.LatestEntry).

    `local_list` is a merge-intention: the locals of every reply that lost
    the per-range reduction at or below PROPOSED, unioned only if extraction
    actually needs them."""

    __slots__ = ("known", "ballot", "coordinated", "local_list")

    def __init__(self, known: KnownDeps, ballot: Ballot,
                 coordinated: Optional[Deps],
                 local_list: Tuple[Deps, ...] = ()):
        self.known = known
        self.ballot = ballot
        self.coordinated = coordinated
        self.local_list = local_list

    @staticmethod
    def reduce(a: "LatestDepsEntry", b: "LatestDepsEntry"
               ) -> "LatestDepsEntry":
        """Higher knowledge wins; Accept-round proposals tie-break by ballot
        (only that phase re-proposes — LatestDeps.AbstractEntry.reduce).
        Local deps of both sides are retained while deps are undecided."""
        c = (a.known > b.known) - (a.known < b.known)
        if c == 0 and a.known == KnownDeps.PROPOSED:
            c = (a.ballot > b.ballot) - (a.ballot < b.ballot)
        if c < 0:
            a, b = b, a
        if a.known <= KnownDeps.PROPOSED:
            return LatestDepsEntry(a.known, a.ballot, a.coordinated,
                                   a.local_list + b.local_list)
        return a

    def __eq__(self, other):
        return (isinstance(other, LatestDepsEntry)
                and self.known == other.known and self.ballot == other.ballot
                and self.coordinated == other.coordinated
                and self.local_list == other.local_list)

    def __hash__(self):
        return hash((self.known, self.ballot))

    def __repr__(self):
        return (f"LatestDepsEntry({self.known.name}, b={self.ballot!r}, "
                f"locals={len(self.local_list)})")


class LatestDeps:
    __slots__ = ("map",)

    EMPTY: "LatestDeps"

    def __init__(self, map_: Optional[ReducingIntervalMap] = None):
        self.map = map_ if map_ is not None else ReducingIntervalMap.empty()

    @staticmethod
    def create(ranges: Ranges, known: KnownDeps, ballot: Ballot,
               coordinated: Optional[Deps], local: Optional[Deps]
               ) -> "LatestDeps":
        """One replica's contribution over the store ranges it covers
        (LatestDeps.create)."""
        m = ReducingIntervalMap.empty()
        entry = LatestDepsEntry(known, ballot, coordinated,
                                (local,) if local is not None else ())
        for r in ranges:
            m = m.update(r.start, r.end, entry, LatestDepsEntry.reduce)
        return LatestDeps(m)

    def merge(self, other: "LatestDeps") -> "LatestDeps":
        return LatestDeps(self.map.merge(other.map, LatestDepsEntry.reduce))

    def _spans(self) -> List[Tuple[int, int, LatestDepsEntry]]:
        return [(s, e, v) for s, e, v in self.map.spans() if v is not None]

    def merge_proposal(self) -> Deps:
        """Deps to re-propose (Recover's Accept payload): per range, the
        max-ballot accepted proposal if one exists, else the union of local
        calculations (LatestDeps.Merge.forProposal)."""
        parts: List[Deps] = []
        for s, e, v in self._spans():
            rng = Ranges([Range(s, e)])
            if v.known == KnownDeps.PROPOSED and v.coordinated is not None:
                parts.append(v.coordinated.slice(rng))
            else:
                parts.extend(d.slice(rng) for d in v.local_list)
        return Deps.merge(parts) if parts else Deps.NONE

    def merge_commit(self, use_local: bool) -> Tuple[Deps, Ranges]:
        """Deps for executing a decided txn, plus the ranges they are
        sufficient for; the remainder needs a CollectDeps round. `use_local`
        = executeAt == txnId: a fast-path commit's deps are exactly what the
        replicas calculate locally, so undecided ranges are still sufficient
        (LatestDeps.Merge.forCommit)."""
        parts: List[Deps] = []
        sufficient: List[Range] = []
        for s, e, v in self._spans():
            rng = Ranges([Range(s, e)])
            if v.known in (KnownDeps.COMMITTED, KnownDeps.STABLE):
                if v.coordinated is not None:
                    parts.append(v.coordinated.slice(rng))
                    sufficient.append(Range(s, e))
            elif use_local and (v.coordinated is not None or v.local_list):
                # sufficiency requires actual knowledge: an entry with
                # neither a proposal nor any local calculation (every replica
                # PRE_COMMITTED via depless Propagate) must NOT suppress the
                # CollectDeps round, or the txn commits with empty deps
                if v.coordinated is not None:
                    parts.append(v.coordinated.slice(rng))
                parts.extend(d.slice(rng) for d in v.local_list)
                sufficient.append(Range(s, e))
        merged = Deps.merge(parts) if parts else Deps.NONE
        return merged, Ranges(sufficient)

    def __eq__(self, other):
        return isinstance(other, LatestDeps) and self.map == other.map

    def __repr__(self):
        return f"LatestDeps({self._spans()!r})"


LatestDeps.EMPTY = LatestDeps()
