"""CommandsForKey: the per-key conflict index a flush window is encoded from.

Reference: accord/local/CommandsForKey.java:132 (design doc :74-131, TxnInfo
:194-293, the missing[] divergence encoding :412-470, mapReduceActive deps
scan :614-650, incremental update with missing maintenance :652-1000).

A copy of the pure-Python tier of ``accord_tpu/local/cfk.py``, cut to what
``update`` (with ``dep_ids``), ``as_arrays``, ``max_committed_write_before``,
``map_reduce_active`` and the recovery queries' raw enumeration
(``map_reduce_full`` and the four BeginRecovery scans) need.  Not carried:
the native C++ tier (pinned identical to this one in the JAX package), the
elision classifier of the recovery scans (``omission_covers``,
``classify_omissions``, with the per-entry write deps they read), the
Unmanaged wait registry and its block-point heaps, and the version counters
the device store's snapshots read.  Nothing in this package registers a
wait, so ``update`` returns nothing.

Representation (parallel arrays, also the device encoder's input):

  _ids[i]      sorted TxnIds — every globally-visible key-domain txn witnessed
               at this key that is not shard-redundant
  _status[i]   InternalStatus (compressed per-key view)
  _eat[i]      executeAt, or None meaning "executes at its own TxnId"
  _missing[i]  sorted tuple of TxnIds DIVERGING from the implied deps, or ()

A committed-by-executeAt view (_committed) drives the transitive-dependency
elision in map_reduce_active.  The batched device equivalent lives in
accord_tpu_torch.ops.deps_kernel and must stay bit-identical to this path.
"""

from __future__ import annotations

import enum
from bisect import bisect_left, insort
from typing import Callable, List, Optional, Sequence, Tuple

from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import (_KIND_MASK, _KIND_SHIFT,
                                                   KindSet, Timestamp, TxnId)


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

    __slots__ = ("key", "_ids", "_status", "_eat", "_missing", "_committed")

    def __init__(self, key: Key):
        self.key = key
        self._ids: List[TxnId] = []
        self._status: List[InternalStatus] = []
        self._eat: List[Optional[Timestamp]] = []
        self._missing: List[Tuple[TxnId, ...]] = []
        # (executeAt, txn_id) sorted, for entries COMMITTED..APPLIED
        self._committed: List[Tuple[Timestamp, TxnId]] = []

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
        insort(self._committed, (at, txn_id))

    def _committed_remove(self, txn_id: TxnId, at: Timestamp) -> None:
        i = bisect_left(self._committed, (at, txn_id))
        if i < len(self._committed) and self._committed[i] == (at, txn_id):
            del self._committed[i]

    # -------------------------------------------------------- maintenance --
    def update(self, txn_id: TxnId, status: InternalStatus,
               execute_at: Optional[Timestamp] = None,
               dep_ids: Optional[Sequence[TxnId]] = None) -> None:
        """Incremental maintenance on a command transition
        (CommandsForKey.update, :652-770 + the insert/update helpers).

        `dep_ids` — the command's key-domain dependency TxnIds AT THIS KEY
        (from its partial/stable deps), required to compute the missing[]
        divergence when `status.has_info`; ignored otherwise.
        """
        pos = self._pos(txn_id)
        if pos >= 0:
            cur = self._status[pos]
            if status < cur:
                return  # per-key view is monotone
            if status == cur and not InternalStatus.ACCEPTED <= status \
                    <= InternalStatus.APPLIED:  # not has_info
                return
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
        else:
            pos = -pos - 1
            self._insert(pos, txn_id, status, execute_at)
            if status.is_committed:
                self._committed_add(txn_id, self._eat_of(pos))

        if status.has_info and dep_ids is not None:
            self._apply_deps(txn_id, status, dep_ids, pos=pos)

    def _insert(self, i: int, txn_id: TxnId, status: InternalStatus,
                execute_at: Optional[Timestamp]) -> None:
        self._ids.insert(i, txn_id)
        self._status.insert(i, status)
        self._eat.insert(i, None if execute_at is None or execute_at == txn_id
                         else execute_at)
        self._missing.insert(i, ())
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

    # ------------------------------------------------------ introspection --
    def get(self, txn_id: TxnId) -> Optional[TxnInfo]:
        i = self._pos(txn_id)
        if i < 0:
            return None
        return TxnInfo(self._ids[i], self._status[i], self._eat[i],
                       self._missing[i])

    def all_ids(self) -> List[TxnId]:
        return list(self._ids)

    def as_arrays(self):
        """The packed representation, for the device encoder: parallel
        (ids, status, execute_at_or_txn_id, missing) sequences."""
        return (self._ids, self._status,
                [self._eat_of(i) for i in range(len(self._ids))],
                self._missing)

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

    # The four BeginRecovery predicates (BeginRecovery.java:329-380), as the
    # raw candidate enumeration: the JAX package's *_ids(raw=True).  The
    # elision classifier that filters the first two is a host post-step not
    # carried here; the batched recovery scans (ops/recovery_kernel.py)
    # compute exactly these raw candidates.
    def started_after_without_witnessing_ids(self, txn_id: TxnId
                                             ) -> List[TxnId]:
        found: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.STARTED_AFTER, TestDep.WITHOUT,
                             TestStatus.IS_PROPOSED,
                             lambda t, at: found.append(t))
        return found

    def executes_after_without_witnessing_ids(self, txn_id: TxnId
                                              ) -> List[TxnId]:
        """hasStableExecutesAfterWithoutWitnessing (ANY started-at; the dep
        test already restricts to executeAt > txn_id)."""
        found: List[TxnId] = []
        self.map_reduce_full(txn_id, txn_id.kind.witnessed_by(),
                             TestStartedAt.ANY, TestDep.WITHOUT,
                             TestStatus.IS_STABLE,
                             lambda t, at: found.append(t))
        return found

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

    def __repr__(self):
        return f"CFK({self.key!r}, {len(self._ids)} txns)"
