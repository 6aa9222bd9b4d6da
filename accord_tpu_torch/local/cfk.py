"""CommandsForKey: the per-key conflict index a flush window is encoded from.

Reference: accord/local/CommandsForKey.java:132 (design doc :74-131, TxnInfo
:194-293, the missing[] divergence encoding :412-470, mapReduceActive deps
scan :614-650, mapReduceFull recovery queries :553-612, incremental update
with missing maintenance :652-1000, Unmanaged registrations :140-184).

Representation (the reference's packed TxnInfo[] re-designed as parallel
arrays, which is also the zero-copy device format for accord_tpu_torch.ops):

  _ids[i]      sorted TxnIds — every globally-visible key-domain txn witnessed
               at this key that is not shard-redundant
  _status[i]   InternalStatus (compressed per-key view)
  _eat[i]      executeAt, or None meaning "executes at its own TxnId"
  _missing[i]  sorted tuple of TxnIds DIVERGING from the implied deps, or ()

The collection IMPLIES deps: a command with known deps (status.has_info) is
assumed to depend on every id in the collection below its depsKnownBefore
that its kind witnesses; only divergences are stored, in missing[i]. Ids
recorded COMMITTED-or-higher are elided from every missing collection (a
recovery coordinator that sees the committed status never needs to decipher
fast-path votes for it, CommandsForKey.java:82-88).

A committed-by-executeAt view (_committed) drives execution-order queries and
the transitive-dependency elision in map_reduce_active.

Host-side scalar implementation; the batched device equivalent (one kernel
call computing deps for a whole window of transactions) lives in
accord_tpu_torch.ops.deps_kernel and must stay bit-identical to this path.

A copy of the pure-Python tier of ``accord_tpu/local/cfk.py``.  The JAX
package also binds a C++ core over the same arrays (pinned identical to this
tier), which the port does not carry.
"""

from __future__ import annotations

import enum
import heapq
from bisect import bisect_left, bisect_right, insort
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import (_KIND_MASK, _KIND_SHIFT,
                                                   KindSet, Timestamp, TxnId,
                                                   TxnKind)
from accord_tpu_torch.utils import invariants

# kinds visible in other txns' deps (TxnKind.is_globally_visible), as a bit
# mask over kind ints — the per-entry visibility test in _block_point
_VISIBLE_MASK = sum(1 << int(k) for k in TxnKind if k.is_globally_visible)


class InternalStatus(enum.IntEnum):
    """Compressed per-key view of a command's state
    (CommandsForKey.InternalStatus, CommandsForKey.java:194-236)."""

    TRANSITIVELY_KNOWN = 0   # known only via deps; never witnessed directly
    HISTORICAL = 1
    PREACCEPTED = 2
    ACCEPTED = 3
    COMMITTED = 4
    STABLE = 5
    APPLIED = 6
    INVALID_OR_TRUNCATED = 7

    @property
    def is_committed(self) -> bool:
        return InternalStatus.COMMITTED <= self <= InternalStatus.APPLIED

    @property
    def is_decided(self) -> bool:
        return self >= InternalStatus.COMMITTED

    @property
    def is_terminal(self) -> bool:
        return self in (InternalStatus.APPLIED,
                        InternalStatus.INVALID_OR_TRUNCATED)

    @property
    def has_info(self) -> bool:
        """Deps (and a meaningful executeAt) are recorded from ACCEPTED on
        (InternalStatus.hasInfo): these are the entries whose missing[]
        answers recovery's dep-membership tests."""
        return InternalStatus.ACCEPTED <= self <= InternalStatus.APPLIED


class TestStartedAt(enum.Enum):
    STARTED_BEFORE = "STARTED_BEFORE"
    STARTED_AFTER = "STARTED_AFTER"
    ANY = "ANY"


class TestDep(enum.Enum):
    WITH = "WITH"
    WITHOUT = "WITHOUT"
    ANY_DEPS = "ANY_DEPS"


class TestStatus(enum.Enum):
    ANY_STATUS = "ANY_STATUS"
    IS_PROPOSED = "IS_PROPOSED"   # ACCEPTED or COMMITTED
    IS_STABLE = "IS_STABLE"       # STABLE..APPLIED


class TxnInfo:
    """Materialised view of one entry (the packed arrays are authoritative)."""

    __slots__ = ("txn_id", "status", "execute_at", "missing")

    def __init__(self, txn_id: TxnId, status: InternalStatus,
                 execute_at: Optional[Timestamp], missing: Tuple[TxnId, ...]):
        self.txn_id = txn_id
        self.status = status
        self.execute_at = execute_at
        self.missing = missing

    def execute_at_or_txn_id(self) -> Timestamp:
        return self.execute_at if self.execute_at is not None else self.txn_id

    def __repr__(self):
        return (f"TxnInfo({self.txn_id!r}, {self.status.name}, "
                f"at={self.execute_at!r}, missing={self.missing!r})")


class Unmanaged:
    """A pending notification for a txn waiting on this key
    (CommandsForKey.Unmanaged, :140-184): fire when every entry at this key
    ordered before `waiting_until` reaches COMMIT or APPLY.  Used both for
    range/sync-point txns and for the key dimension of WaitingOn (the
    reference's bitset spans txnIds AND keys, Command.java:1294-1643): a
    Stable key txn holds a key bit until the CFK certifies every
    earlier-executing entry applied.

    Callbacks take the live SafeCommandStore: the CFK itself is a pure data
    structure, so `update`/`prune_redundant` RETURN the fired registrations
    and the calling store context invokes them."""

    __slots__ = ("txn_id", "pending", "waiting_until", "callback")

    COMMIT = "COMMIT"
    APPLY = "APPLY"

    def __init__(self, txn_id: TxnId, pending: str, waiting_until: Timestamp,
                 callback: Callable[["object"], None]):
        self.txn_id = txn_id
        self.pending = pending
        self.waiting_until = waiting_until
        self.callback = callback


def _deps_known_before(txn_id: TxnId, status: InternalStatus,
                       execute_at: Optional[Timestamp]) -> Timestamp:
    """The bound below which this entry's deps are complete
    (InternalStatus.depsKnownBefore): txnId until commit, executeAt after."""
    if status.is_committed and execute_at is not None:
        return execute_at
    return txn_id


class CommandsForKey:
    """All transactions witnessed at one key, ordered by TxnId, with the
    missing[] divergence encoding and a committed-by-executeAt view."""

    __slots__ = ("key", "_ids", "_status", "_eat", "_missing", "_wdeps",
                 "_committed",
                 "redundant_before", "version", "last_mutator",
                 "committed_version", "_block_heap", "_wait_heap", "_wait_seq")

    def __init__(self, key: Key):
        self.key = key
        self._ids: List[TxnId] = []
        self._status: List[InternalStatus] = []
        self._eat: List[Optional[Timestamp]] = []
        self._missing: List[Tuple[TxnId, ...]] = []
        # the WRITE ids among each entry's registered deps at this key —
        # the entry's potential elision covers.  Resolved to timestamps at
        # QUERY time (locally-known executeAt when committed; reported
        # unresolved to the recovery coordinator otherwise) so a dep that
        # commits after registration contributes its real executeAt (see
        # omission_covers)
        self._wdeps: List[Tuple[TxnId, ...]] = []
        # (executeAt, txn_id) sorted, for entries COMMITTED..APPLIED
        self._committed: List[Tuple[Timestamp, TxnId]] = []
        # lazy min-heap of (block_point, txn_id) over non-terminal entries —
        # see _block_point; stale items are dropped at query time
        self._block_heap: List[Tuple[Timestamp, TxnId]] = []
        # APPLY-pending registrations as (waiting_until, seq, Unmanaged)
        self._wait_heap: List[Tuple[Timestamp, int, Unmanaged]] = []
        self._wait_seq = 0
        self.redundant_before: Optional[TxnId] = None
        # bumped on every mutation; device-store snapshots validate against it.
        # last_mutator = the txn of the latest update(), letting a snapshot
        # tolerate exactly one bump when it is the querying txn's own
        # registration (invisible to its deps scan, which excludes itself).
        # committed_version guards the tolerance: a bump that changed the
        # committed view moved the transitive-elision bound, which affects
        # OTHER entries' visibility — never tolerable.
        self.version = 0
        self.last_mutator: Optional[TxnId] = None
        self.committed_version = 0

    # ------------------------------------------------------------ plumbing --
    def _pos(self, txn_id: TxnId) -> int:
        """Index of txn_id, or -(insert_pos)-1 if absent."""
        i = bisect_left(self._ids, txn_id)
        if i < len(self._ids) and self._ids[i] == txn_id:
            return i
        return -i - 1

    def _eat_of(self, i: int) -> Timestamp:
        e = self._eat[i]
        return e if e is not None else self._ids[i]

    def _committed_add(self, txn_id: TxnId, at: Timestamp) -> None:
        self.committed_version += 1
        insort(self._committed, (at, txn_id))

    def _committed_remove(self, txn_id: TxnId, at: Timestamp) -> None:
        i = bisect_left(self._committed, (at, txn_id))
        if i < len(self._committed) and self._committed[i] == (at, txn_id):
            self.committed_version += 1
            del self._committed[i]

    # -------------------------------------------------------- maintenance --
    def update(self, txn_id: TxnId, status: InternalStatus,
               execute_at: Optional[Timestamp] = None,
               dep_ids: Optional[Sequence[TxnId]] = None
               ) -> List["Unmanaged"]:
        """Incremental maintenance on a command transition
        (CommandsForKey.update, :652-770 + the insert/update helpers).

        `dep_ids` — the command's key-domain dependency TxnIds AT THIS KEY
        (from its partial/stable deps), required to compute the missing[]
        divergence when `status.has_info`; ignored otherwise.

        Returns newly-satisfied Unmanaged registrations; the caller must
        invoke their callbacks with its SafeCommandStore.
        """
        pos = self._pos(txn_id)
        if pos >= 0:
            cur = self._status[pos]
            if status < cur:
                return []  # per-key view is monotone
            if status == cur and not InternalStatus.ACCEPTED <= status \
                    <= InternalStatus.APPLIED:  # not has_info
                return []
            self.version += 1
            self.last_mutator = txn_id
            # status-band tests inlined (enum <=> enum is a C int compare;
            # the properties cost a descriptor dispatch per call and update
            # consulted them three times per transition)
            was_committed = InternalStatus.COMMITTED <= cur \
                <= InternalStatus.APPLIED
            now_committed = InternalStatus.COMMITTED <= status \
                <= InternalStatus.APPLIED
            old_eat = self._eat_of(pos)
            if was_committed and now_committed \
                    and execute_at is not None \
                    and old_eat != execute_at:
                # executeAt is fixed at commit; keep the committed view exact
                self._committed_remove(txn_id, old_eat)
                self._committed_add(txn_id, execute_at)
            self._status[pos] = status
            if execute_at is not None:
                self._eat[pos] = None if execute_at == txn_id else execute_at
            # pos is stable through this branch (no inserts): reuse it
            # instead of re-bisecting per step
            if now_committed and not was_committed:
                self._committed_add(txn_id, self._eat_of(pos))
            if status == InternalStatus.INVALID_OR_TRUNCATED and was_committed:
                # use the eat recorded before the mutation above, so the exact
                # (eat, txn_id) pair leaves _committed even if the caller
                # passed a differing execute_at
                self._committed_remove(txn_id, old_eat)
            if status >= InternalStatus.COMMITTED \
                    and cur < InternalStatus.COMMITTED:
                # newly Committed-or-higher: elide from all missing[]
                self._remove_missing(txn_id)
            self._push_block_point(pos)
        else:
            self.version += 1
            self.last_mutator = txn_id
            pos = -pos - 1
            self._insert(pos, txn_id, status, execute_at)
            if status.is_committed:
                self._committed_add(txn_id, self._eat_of(pos))

        if status.has_info and dep_ids is not None:
            self._apply_deps(txn_id, status, dep_ids, pos=pos)

        if status.is_committed or status == InternalStatus.INVALID_OR_TRUNCATED:
            return self._notify_unmanaged()
        return []

    def _insert(self, i: int, txn_id: TxnId, status: InternalStatus,
                execute_at: Optional[Timestamp]) -> None:
        self._ids.insert(i, txn_id)
        self._status.insert(i, status)
        self._eat.insert(i, None if execute_at is None or execute_at == txn_id
                         else execute_at)
        self._missing.insert(i, ())
        self._wdeps.insert(i, ())
        self._push_block_point(i)
        if not status.is_decided:
            # every existing entry with known deps whose bound should have
            # witnessed this id did not (it was unknown until now): record
            # the divergence (insertInfoAndOneMissing, :897-960)
            self._add_missing_everywhere(txn_id)

    def _add_missing_everywhere(self, new_id: TxnId) -> None:
        for j in range(len(self._ids)):
            if self._ids[j] == new_id or not self._status[j].has_info:
                continue
            bound = _deps_known_before(self._ids[j], self._status[j],
                                       self._eat[j])
            if bound > new_id and self._ids[j].witnesses(new_id):
                m = self._missing[j]
                k = bisect_left(m, new_id)
                if k >= len(m) or m[k] != new_id:
                    self._missing[j] = m[:k] + (new_id,) + m[k:]

    def _remove_missing(self, txn_id: TxnId) -> None:
        """Elide a newly-committed id from every missing collection
        (removeMissing, :962-987)."""
        for j in range(len(self._missing)):
            m = self._missing[j]
            if not m:
                continue
            k = bisect_left(m, txn_id)
            if k < len(m) and m[k] == txn_id:
                self._missing[j] = m[:k] + m[k + 1:]

    def _apply_deps(self, txn_id: TxnId, status: InternalStatus,
                    dep_ids: Sequence[TxnId],
                    pos: Optional[int] = None) -> None:
        """Install the entry's own missing[] divergence and insert any dep
        ids not yet witnessed here (the additions path, :738-860).  `pos` —
        txn_id's known index in the arrays (update just positioned it),
        adjusted here as additions land below it."""
        dep_set = set(dep_ids)
        if pos is None:
            pos = self._pos(txn_id)
        # additions: deps referencing ids this key has never witnessed —
        # one bisect each (walking sorted keeps later probes exact), with
        # txn_id's index shifted as inserts land below it
        for t in sorted(dep_set):
            if not t.is_key_domain:
                continue
            p = self._pos(t)
            if p >= 0:
                continue
            i = -p - 1
            self._insert(i, t, InternalStatus.TRANSITIVELY_KNOWN, None)
            if i <= pos:
                pos += 1
        bound = _deps_known_before(txn_id, status, self._eat[pos])
        missing: List[TxnId] = []
        hi = bisect_left(self._ids, bound)
        for j in range(hi):
            t = self._ids[j]
            if t == txn_id or t in dep_set:
                continue
            if self._status[j].is_decided:
                continue  # elided: recovery sees the committed status
            if txn_id.witnesses(t):
                missing.append(t)
        self._missing[pos] = tuple(missing)
        self._wdeps[pos] = tuple(sorted(
            t for t in dep_set if t.is_key_domain and t.kind.is_write))

    def register_historical(self, txn_id: TxnId) -> None:
        """Witness a txn known only through another replica's deps
        (registerHistorical)."""
        if self._pos(txn_id) < 0:
            self.update(txn_id, InternalStatus.HISTORICAL)

    def prune_redundant(self, before: TxnId) -> List["Unmanaged"]:
        """Drop applied/invalidated txns below the redundancy watermark.
        Returns newly-satisfied Unmanaged registrations (the watermark can
        raise the min block point); caller dispatches the callbacks."""
        self.version += 1
        self.last_mutator = None
        self.redundant_before = (before if self.redundant_before is None
                                 else max(self.redundant_before, before))
        drop = [i for i, t in enumerate(self._ids)
                if t < before and self._status[i].is_terminal]
        if drop:
            dropped = {self._ids[i] for i in drop}
            for i in reversed(drop):
                if self._status[i].is_committed:
                    self._committed_remove(self._ids[i], self._eat_of(i))
                del self._ids[i], self._status[i], self._eat[i], \
                    self._missing[i], self._wdeps[i]
            for j in range(len(self._missing)):
                m = self._missing[j]
                if m and any(t in dropped for t in m):
                    self._missing[j] = tuple(t for t in m if t not in dropped)
        return self._notify_unmanaged()

    # ------------------------------------------------------ introspection --
    def get(self, txn_id: TxnId) -> Optional[TxnInfo]:
        i = self._pos(txn_id)
        if i < 0:
            return None
        return TxnInfo(self._ids[i], self._status[i], self._eat[i],
                       self._missing[i])

    def size(self) -> int:
        return len(self._ids)

    def all_ids(self) -> List[TxnId]:
        return list(self._ids)

    def as_arrays(self):
        """The packed representation, for the device encoder: parallel
        (ids, status, execute_at_or_txn_id, missing) sequences."""
        return (self._ids, self._status,
                [self._eat_of(i) for i in range(len(self._ids))],
                self._missing)

    def min_uncommitted(self) -> Optional[TxnId]:
        for i, t in enumerate(self._ids):
            if not self._status[i].is_decided:
                return t
        return None

    def max_committed_write_at(self) -> Optional[Timestamp]:
        for at, t in reversed(self._committed):
            if t.kind.is_write:
                return at
        return None

    def max_conflict(self) -> Optional[Timestamp]:
        """Max (txnId | committed executeAt) at this key — executeAt proposal
        input."""
        best: Optional[Timestamp] = None
        if self._ids:
            best = self._ids[-1]
        if self._committed and (best is None or self._committed[-1][0] > best):
            best = self._committed[-1][0]
        return best

    # ------------- the deps scan (mapReduceActive, CommandsForKey.java:614) --
    def max_committed_write_before(self, before: Timestamp
                                   ) -> Optional[Timestamp]:
        """Max executeAt among committed WRITES executing strictly before
        `before` — the transitive-elision bound."""
        if not self._committed:
            return None
        i = bisect_left(self._committed, (before,))
        i -= 1
        while i >= 0 and not self._committed[i][1].kind.is_write:
            i -= 1
        return self._committed[i][0] if i >= 0 else None

    def map_reduce_active(self, before: Timestamp, kinds: KindSet,
                          fn: Callable[[TxnId], None],
                          prune: bool = True) -> None:
        """Visit every active txn with txnId < `before` whose kind is in
        `kinds` — the dependency calculation for a new txn at this key.

        Transitive elision (mapReduceActive :614-650): establish the
        last-executing committed write below `before`; any COMMITTED-or-later
        txn with a lower executeAt is elided — its stable deps are complete,
        so depending on the bound write transitively orders us after it; for
        recovery, the committed status reported by this replica means no
        fast-path deciphering will consult these deps (design doc :101-112).
        TRANSITIVELY_KNOWN ids are unwitnessed (they exist only to track
        missing[] divergence) and never become deps themselves.
        """
        bound = self.max_committed_write_before(before) if prune else None
        hi = bisect_left(self._ids, before)
        for i in range(hi):
            t = self._ids[i]
            if t.kind not in kinds:
                continue
            st = self._status[i]
            if st == InternalStatus.TRANSITIVELY_KNOWN \
                    or st == InternalStatus.INVALID_OR_TRUNCATED:
                continue
            if st.is_committed and bound is not None \
                    and self._eat_of(i) < bound:
                continue  # transitively covered by the bound write
            fn(t)

    # ------------- recovery queries (mapReduceFull, CommandsForKey.java:553) --
    def map_reduce_full(self, test_txn_id: TxnId, kinds: KindSet,
                        test_started_at: TestStartedAt, test_dep: TestDep,
                        test_status: TestStatus,
                        fn: Callable[[TxnId, Timestamp], None]) -> None:
        """The recovery query family. Dep tests consult the missing[]
        divergence encoding: an entry with known deps (has_info) and
        executeAt > test_txn_id has test_txn_id as a dependency iff it is
        NOT listed in its missing collection (:598-608)."""
        pos = self._pos(test_txn_id)
        is_known = pos >= 0
        if not is_known and test_dep == TestDep.WITH:
            return
        insert_pos = pos if is_known else -pos - 1
        if test_started_at == TestStartedAt.STARTED_BEFORE:
            start, end = 0, insert_pos
        elif test_started_at == TestStartedAt.STARTED_AFTER:
            start, end = insert_pos, len(self._ids)
        else:
            start, end = 0, len(self._ids)

        kmask = kinds.mask()
        for i in range(start, end):
            t = self._ids[i]
            if t == test_txn_id \
                    or not (kmask >> ((t.flags & _KIND_MASK)
                                      >> _KIND_SHIFT)) & 1:
                continue
            st = self._status[i]
            if test_status == TestStatus.IS_PROPOSED:
                if st not in (InternalStatus.ACCEPTED,
                              InternalStatus.COMMITTED):
                    continue
            elif test_status == TestStatus.IS_STABLE:
                if not (InternalStatus.STABLE <= st
                        <= InternalStatus.APPLIED):
                    continue
            else:
                if st == InternalStatus.TRANSITIVELY_KNOWN:
                    continue
            execute_at = self._eat_of(i)
            if test_dep != TestDep.ANY_DEPS:
                if not st.has_info:
                    continue
                if execute_at <= test_txn_id:
                    continue
                m = self._missing[i]
                k = bisect_left(m, test_txn_id)
                has_as_dep = not (k < len(m) and m[k] == test_txn_id)
                if has_as_dep != (test_dep == TestDep.WITH):
                    continue
            fn(t, execute_at)

    # the four BeginRecovery predicates (BeginRecovery.java:329-380).
    # The *_ids variants return the matching ids (the batched device store
    # verifies its precomputed masks against them); the bool forms delegate.
    def omission_covers(self, i: int, txn_id: TxnId,
                        resolve=None) -> Optional[Tuple[TxnId, ...]]:
        """Entry i carries deps that omit `txn_id` — classify the omission.

        The deps calc (map_reduce_active) elides any committed entry whose
        executeAt lies below the last-executing committed write, so a
        fast-path-committed txn_id (executeAt == txn_id) is legally ABSENT
        from a later entry's deps wherever a committed write bound covered
        it.  The recovery reject predicates consult the missing[] encoding
        under exactly the fast-path hypothesis; reading an elision-shaped
        omission as a fast-path refutation invalidated a COMMITTED txn in
        a soak burn (seed 16005: fast commit on a reduced electorate, a
        later committed write as the elision bound, and a recovery quorum
        that avoided every committed copy).  The reference ships the same
        elision with an unproven-correctness TODO
        (CommandsForKey.java:640 PRUNE_TRANSITIVE_DEPENDENCIES).

        Returns a three-way verdict mirroring the exact elision rule:

        * ``None`` — ELIDED.  Some registered write dep of entry i is
          COMMITTED with executeAt strictly between the hypothesised
          fast-path timestamp and the entry's deps-known-before bound —
          exactly the window in which map_reduce_active elides: the
          bound write is always itself visited (only entries strictly
          below the bound are pruned), so if txn_id was elided, its
          cover IS among the entry's registered write deps.  The
          omission is no evidence either way; suppress it.
        * ``()`` — EVIDENCE.  Every registered write dep is resolved
          (committed outside the window, or invalidated) and none could
          have been a legal elision bound; the omission genuinely
          refutes the fast path.
        * non-empty tuple — INCONCLUSIVE.  The listed write deps are not
          decided locally, and any of them may yet commit (possibly on
          the slow path, with an executeAt well above its id) into the
          covering window.  The caller must NOT read the omission as
          evidence host-side: the recovery coordinator awaits these
          covers' commits and retries, by which time they resolve into
          one of the two definite verdicts.  This also closes the
          residual soundness edge recorded in round 3's SOAK_NOTES: a
          cover whose id is below the hypothesised timestamp but whose
          slow-path executeAt (above it) is not locally known used to
          be mis-read as reject evidence (its id was used as the
          resolution), re-opening the seed-16005 hazard; now it is
          reported unresolved and resolved by the coordinator.

        LIVENESS (await acyclicity): only undecided covers with id
        STRICTLY BELOW txn_id are reported unresolved.  Awaiting a cover
        triggers recovery of the cover if its coordinator died, and that
        recovery may itself await covers — were awaits unordered, two
        undecided writes could await each other through crossing deps
        (x deps=[b] omitting w, y deps=[w] omitting b: Recovery(w) parks
        on b while Recovery(b) parks on w, both wedged forever, the
        seed-15003 acked-write-loss class).  Restricting awaits to
        strictly-smaller ids makes every await chain strictly
        decreasing, hence finite and cycle-free.  An undecided cover
        with id ABOVE txn_id instead suppresses the omission (its
        eventual executeAt necessarily exceeds the hypothesis, so it
        may legally have elided txn_id at a replica that saw it
        committed): the fail-safe direction — reading the omission as
        evidence risks invalidating a committed txn (seed 16005), the
        strictly worse failure — and exactly round 3's behaviour for
        this sub-case, soaked over ~226 hostile seeds.  When the cover
        later resolves, a retried recovery reads the omission
        definitively.

        `resolve(w) -> ('committed', executeAt) | ('invalid', None) |
        ('undecided', None) | None` lets the store consult its command
        registry for deps this CFK no longer tracks precisely
        (INVALID_OR_TRUNCATED conflates invalidated with
        truncated-applied; prune_redundant drops entries wholesale).  A
        cover that is untrackable even there — pruned below the
        redundancy watermark AND erased from the registry — is treated
        as a cover (suppress): erasure requires the shard's durable
        frontier to have advanced past it, so it was applied at some
        executeAt we can no longer observe; reading its omission as
        reject evidence risks invalidating a committed txn (the
        seed-16005 class, the strictly worse failure), while awaiting
        it would livelock (it is already durably decided everywhere, so
        a WaitOnCommit acks instantly and a retry learns nothing new).

        The write-dep ids were recorded from the true dep list at
        registration (the missing[] encoding can't answer this because
        decided ids are exempt from it); each is resolved HERE so a dep
        that committed after registration contributes its real executeAt
        (its id alone is only a lower bound on where it executes)."""
        hyp = txn_id.as_timestamp()
        bound = _deps_known_before(self._ids[i], self._status[i],
                                   self._eat[i])
        unresolved: List[TxnId] = []
        for t in self._wdeps[i]:
            if t == txn_id:
                continue
            p = self._pos(t)
            if p >= 0 and self._status[p].is_committed:
                e = self._eat_of(p)
                if hyp < e < bound:
                    return None  # definite elision cover
                continue  # committed outside the window: no cover
            if p >= 0 and self._status[p] != InternalStatus.INVALID_OR_TRUNCATED:
                # witnessed here but undecided: consult the registry (it may
                # know a commit this per-key view hasn't absorbed yet)
                r = resolve(t) if resolve is not None else None
                if r is None or r[0] == "undecided":
                    if t > txn_id:
                        return None  # suppress: see LIVENESS note above
                    unresolved.append(t)
                    continue
            else:
                # INVALID_OR_TRUNCATED in place, or pruned entirely: the
                # per-key view can't distinguish invalidated (no cover)
                # from truncated-applied (possible cover)
                r = resolve(t) if resolve is not None else None
                if r is None:
                    return None  # untrackable: suppress (see docstring)
            kind, eat = r
            if kind == "committed":
                if eat is not None and hyp < eat < bound:
                    return None
                continue
            if kind == "invalid":
                continue
            if t > txn_id:
                return None  # suppress: see LIVENESS note above
            unresolved.append(t)
        return tuple(unresolved)

    def classify_omissions(self, found: List[TxnId], txn_id: TxnId,
                           resolve=None
                           ) -> Tuple[List[TxnId], List[TxnId]]:
        """Partition raw omission candidates into (evidence, unresolved
        cover ids).  An entry whose omission is elision-shaped contributes
        to neither; an entry with undecided cover candidates contributes
        those covers to `unresolved` instead of itself to `evidence`."""
        evidence: List[TxnId] = []
        unresolved: List[TxnId] = []
        for t in found:
            covers = self.omission_covers(self._pos(t), txn_id, resolve)
            if covers is None:
                continue
            if covers:
                unresolved.extend(covers)
            else:
                evidence.append(t)
        return evidence, unresolved

    def _filter_elided(self, found: List[TxnId], txn_id: TxnId
                       ) -> List[TxnId]:
        """Definite-evidence filter (no resolver): entries whose omission is
        elided OR inconclusive are dropped.  Callers that can act on
        inconclusiveness use classify_omissions instead."""
        return self.classify_omissions(found, txn_id)[0]

    def started_after_without_witnessing_ids(self, txn_id: TxnId,
                                             raw: bool = False
                                             ) -> List[TxnId]:
        """`raw=True` returns the unsuppressed candidates (the device tier's
        batched masks compute exactly these; suppression is a shared
        host-side post-filter on both paths)."""
        found: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.STARTED_AFTER, TestDep.WITHOUT,
                             TestStatus.IS_PROPOSED,
                             lambda t, at: found.append(t))
        return found if raw else self._filter_elided(found, txn_id)

    def accepted_or_committed_started_after_without_witnessing(
            self, txn_id: TxnId) -> bool:
        return bool(self.started_after_without_witnessing_ids(txn_id))

    def executes_after_without_witnessing_ids(self, txn_id: TxnId,
                                              raw: bool = False
                                              ) -> List[TxnId]:
        """hasStableExecutesAfterWithoutWitnessing (ANY started-at; the dep
        test already restricts to executeAt > txn_id).  Elision-shaped
        omissions are inconclusive (see omission_covers)."""
        found: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.ANY, TestDep.WITHOUT,
                             TestStatus.IS_STABLE,
                             lambda t, at: found.append(t))
        return found if raw else self._filter_elided(found, txn_id)

    def committed_executes_after_without_witnessing(self, txn_id: TxnId
                                                    ) -> bool:
        return bool(self.executes_after_without_witnessing_ids(txn_id))

    def stable_started_before_and_witnessed(self, txn_id: TxnId
                                            ) -> List[TxnId]:
        out: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.STARTED_BEFORE, TestDep.WITH,
                             TestStatus.IS_STABLE,
                             lambda t, at: out.append(t))
        return out

    def accepted_started_before_without_witnessing(self, txn_id: TxnId
                                                   ) -> List[TxnId]:
        """acceptedOrCommittedStartedBeforeWithoutWitnessing: proposed to
        execute after txn_id with deps omitting it — recovery must await
        their commit before deciphering the fast path (:329-342)."""
        out: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.STARTED_BEFORE, TestDep.WITHOUT,
                             TestStatus.IS_PROPOSED,
                             lambda t, at: out.append(t) if at > txn_id
                             else None)
        return out

    # ---------------------------------------- unmanaged (cross-key) waits --
    #
    # Efficiency: an entry's *block point* — the lowest waiting_until it can
    # block — is its id while undecided, its executeAt while committed, and
    # gone once terminal/invisible/redundant.  Transitions only ever RAISE
    # it, so a lazy min-heap over block points plus a min-heap of
    # registrations by waiting_until makes each update O(log n) amortised:
    # a registration fires exactly when min-block-point >= its
    # waiting_until.  (A notify-all-per-update formulation is quadratic on
    # a deep same-key chain — 3000 committed writes at one key wedged the
    # burn for minutes.)

    def register_unmanaged(self, unmanaged: Unmanaged) -> None:
        """Record an APPLY wait.  Caller contract: register only after
        proving blockers exist (commands._initialise_key_wait does) — the
        satisfaction check is the caller's, so no walk happens here."""
        invariants.check_state(unmanaged.pending == Unmanaged.APPLY,
                               "only APPLY waits are registrable; COMMIT is "
                               "a query mode (blocking_ids)")
        self._wait_seq += 1
        heapq.heappush(self._wait_heap,
                       (unmanaged.waiting_until, self._wait_seq, unmanaged))

    def has_unmanaged(self, txn_id: TxnId) -> bool:
        return any(w[2].txn_id == txn_id for w in self._wait_heap)

    def _block_point(self, i: int) -> Optional[Timestamp]:
        st = self._status[i]
        t = self._ids[i]
        # int-band tests instead of enum property dispatch: this runs per
        # lazy-heap pop and per update (terminal = APPLIED|INVALID = >= 6;
        # visibility via the precomputed kind mask)
        if st >= InternalStatus.APPLIED \
                or st == InternalStatus.TRANSITIVELY_KNOWN \
                or not (_VISIBLE_MASK
                        >> ((t.flags & _KIND_MASK) >> _KIND_SHIFT)) & 1:
            return None
        if self.redundant_before is not None and t < self.redundant_before:
            return None
        return self._eat_of(i) \
            if InternalStatus.COMMITTED <= st else t

    def _push_block_point(self, i: int) -> None:
        bp = self._block_point(i)
        if bp is not None:
            heapq.heappush(self._block_heap, (bp, self._ids[i]))

    def _min_block_point(self) -> Optional[Timestamp]:
        """Current minimum block point (None = nothing blocks).  Stale heap
        items — transitions pushed fresh copies — are popped lazily."""
        while self._block_heap:
            bp, t = self._block_heap[0]
            i = self._pos(t)
            cur = self._block_point(i) if i >= 0 else None
            if cur is not None and cur == bp:
                return bp
            heapq.heappop(self._block_heap)
            if cur is not None:
                # moved (committed: id -> executeAt); reinsert at the new point
                heapq.heappush(self._block_heap, (cur, t))
        return None

    def _notify_unmanaged(self) -> List[Unmanaged]:
        fired: List[Unmanaged] = []
        if self._wait_heap:
            mbp = self._min_block_point()
            while self._wait_heap and (mbp is None
                                       or self._wait_heap[0][0] <= mbp):
                fired.append(heapq.heappop(self._wait_heap)[2])
        return fired

    def blocking_ids(self, pending: str, waiting_until: Timestamp,
                     exclude: Optional[TxnId] = None,
                     first_only: bool = False,
                     skip_pred: Optional[Callable[[TxnId], bool]] = None
                     ) -> List[Tuple[TxnId, bool]]:
        """Entries currently failing the wait rule: for APPLY, every visible
        entry ordered before `waiting_until` must be terminal or committed
        with executeAt after it; for COMMIT, merely decided.  Returns
        (txn_id, is_decided) pairs — the progress log chases undecided
        blockers to Committed and decided ones to Applied.  Entries below
        the redundancy watermark (or matching `skip_pred`, e.g. the
        per-store RedundantBefore) are already reflected in local state
        (snapshot or GC) and never block."""
        out: List[Tuple[TxnId, bool]] = []
        # ids are sorted: only the prefix strictly below waiting_until can
        # block, and everything below the redundancy watermark never does
        lo = (bisect_left(self._ids, self.redundant_before)
              if self.redundant_before is not None else 0)
        hi = bisect_left(self._ids, waiting_until)
        for i in range(lo, hi):
            t = self._ids[i]
            if t == exclude:
                continue
            st = self._status[i]
            if not t.is_visible or st == InternalStatus.TRANSITIVELY_KNOWN:
                continue
            if pending == Unmanaged.COMMIT:
                if not st.is_decided:
                    out.append((t, False))
            else:  # APPLY
                if not st.is_terminal:
                    if not (st.is_committed
                            and self._eat_of(i) > waiting_until):
                        out.append((t, st.is_decided))
            if out and skip_pred is not None and skip_pred(out[-1][0]):
                out.pop()
            if out and first_only:
                return out
        return out

    def __repr__(self):
        return f"CFK({self.key!r}, {len(self._ids)} txns)"


class TimestampsForKey:
    """Per-key execution timestamps (reference impl/TimestampsForKey.java:33):
    lastExecutedTimestamp / lastWriteTimestamp feed executeAt validation and
    the read-timestamp watermark."""

    __slots__ = ("key", "last_executed", "last_write", "raw_hlc")

    def __init__(self, key: Key):
        self.key = key
        self.last_executed: Optional[Timestamp] = None
        self.last_write: Optional[Timestamp] = None
        self.raw_hlc = 0

    def on_executed(self, at: Timestamp, is_write: bool) -> None:
        if self.last_executed is None or at > self.last_executed:
            self.last_executed = at
        if is_write and (self.last_write is None or at > self.last_write):
            self.last_write = at
        self.raw_hlc = max(self.raw_hlc, at.hlc)

    def validate_execute_at(self, at: Timestamp) -> None:
        invariants.check_state(
            self.last_write is None or at >= self.last_write,
            "executeAt %s precedes last write %s at %s", at, self.last_write,
            self.key)
