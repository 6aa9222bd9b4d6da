"""A plain reference of one replica's command store under the lifecycle.

It works out again, from the generated transactions and ops alone, what the
store must answer: each PreAccept's outcome, executeAt and deps, each
Accept's outcome and deps, each Commit's and Apply's outcome, the
transactions each window applies, and the data each key holds.  It follows
the semantics of Accord's per-key conflict index (CommandsForKey's
mapReduceActive) written out directly, and imports nothing of the program.

* A transaction's id is (epoch 1, hlc, flags, node), flags = kind << 1 |
  domain; ids order as tuples.  The generator draws hlcs that grow with
  the index, so index order is id order.
* Deps of a transaction at a key, below `before`: every entry witnessed at
  the key with a smaller id whose kind the transaction witnesses (a READ
  witnesses WRITEs, a WRITE both), except committed entries (stable or
  applied) whose executeAt lies below the latest executeAt of a committed
  WRITE below `before`: the deps of that write order them already
  (transitive elision).
* executeAt is the id, unless a timestamp at one of the keys (an id or an
  executeAt ever proposed there) is not below it: then a fresh HLC of the
  replica (node 1) above it.
* A window's ops run in the order they were submitted; every Apply sent
  in a window executes in it, and the writes to each key execute in
  executeAt order.
* The data store holds, for each key a transaction writes, the values of
  the applied writes in executeAt order (transaction i writes i).

Range transactions (domain 1, READs only; the generator refuses others)
follow the store's range-conflict arm (``register_range_txn``,
``map_reduce_active``, ``_map_range_conflicts``, ``_active_range_conflict``
and ``MaxConflicts`` of the port's ``local/`` package), written out here:

* A range transaction enters the range index when it is first preaccepted
  and sits in no key's conflict index.  Nothing in a lifecycle leaves the
  index: only invalidation or erasure would take it out, so the range arm
  elides nothing.
* Its deps at `before` are the key tier over every key with conflict state
  inside its ranges (the rule above, key by key, reported per key), plus
  the range arm.  The range arm of a READ is empty: the index holds only
  READs, and a READ witnesses only WRITEs.
* A key transaction's deps gain the range arm: every range transaction in
  the index with a smaller id than `before` whose kind it witnesses and one
  of whose ranges holds one of its keys, reported as that range with the
  id (the store reports ranges, not keys), once each.
* executeAt takes in the range index too: a key's timestamps are joined by
  the executeAts of the range transactions whose ranges hold the key, and a
  range transaction's conflicts are the timestamps of every key inside its
  ranges and the executeAts of the range transactions that overlap them.
* A range transaction's Apply writes nothing and has no wave.

Three more answers are the card's: which deps scans it must serve, which
range-arm queries, and the window's execution waves.

* A flush computes every deps scan of its window on the card, from the
  index as it stood before the window's first op.  A scan is served from
  that snapshot (a device hit) when no op of another transaction that
  ran before it in the window changed one of its keys: the window runs
  its PreAccepts and Accepts, in the order sent, before its Commits and
  Applies, and each registers its transaction at its keys.  The keys of
  a range transaction's scan are every key inside its ranges, those an
  earlier op of the window created among them: such a key is one the
  snapshot does not cover.
* The flush stabs the range index on the card for every scan of its
  window when the index held a range transaction before the window's
  first op; each such scan's range arm is then served from the stab, the
  range transactions registered since unioned in.  With an empty index
  at the flush the range arm is the host's.
* The waves are the Kahn layers of the window's key-domain Apply graph:
  Apply i follows Apply j when j's executeAt is lower, they share a key
  and i's kind witnesses j's; a wave is one more than the deepest it
  follows, and a window of fewer than two such Applies has no plan.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

READ, WRITE = 1, 2
KEY_DOMAIN, RANGE_DOMAIN = 0, 1
KIND_SHIFT = 1
PREACCEPTED, ACCEPTED, STABLE, APPLIED = 2, 3, 5, 6
# the kinds each kind witnesses
WITNESSES = {READ: (WRITE,), WRITE: (READ, WRITE)}


def txn_id(spec) -> tuple:
    kind, domain, hlc, node, _tokens, _writes = spec
    return (1, hlc, (kind << KIND_SHIFT) | domain, node)


class _Key:
    __slots__ = ("uncommitted", "committed", "committed_writes", "max_ts",
                 "data")

    def __init__(self):
        self.uncommitted: Dict[int, int] = {}        # index -> status
        self.committed: List[Tuple[tuple, int]] = []  # sorted (eat, index)
        self.committed_writes: List[tuple] = []      # sorted eats
        self.max_ts: Optional[tuple] = None
        self.data: List[Tuple[tuple, int]] = []      # sorted (eat, value)


class _Segments:
    """The range index by the tokens it covers: the sorted bounds of every
    range registered and, for each segment from one bound to the next, the
    ranges that cover it as (txn index, start, end) in the order they were
    registered, and the highest executeAt among their transactions."""

    def __init__(self):
        self.bounds: List[int] = []
        self.cover: List[list] = []
        self.top: List[Optional[tuple]] = []

    def _split(self, token: int) -> int:
        s = bisect_left(self.bounds, token)
        if s == len(self.bounds) or self.bounds[s] != token:
            self.bounds.insert(s, token)
            self.cover.insert(s, list(self.cover[s - 1]) if s else [])
            self.top.insert(s, self.top[s - 1] if s else None)
        return s

    def add(self, i: int, start: int, end: int, eat: tuple) -> None:
        first, last = self._split(start), self._split(end)
        for s in range(first, last):
            self.cover[s].append((i, start, end))
            if self.top[s] is None or eat > self.top[s]:
                self.top[s] = eat

    def covering(self, token: int) -> list:
        s = bisect_right(self.bounds, token) - 1
        return self.cover[s] if s >= 0 else []

    def top_over(self, start: int, end: int) -> Optional[tuple]:
        """The highest executeAt of the ranges that meet [start, end)."""
        first = max(0, bisect_right(self.bounds, start) - 1)
        last = bisect_left(self.bounds, end)
        return max((t for t in self.top[first:last] if t is not None),
                   default=None)


class ReferenceStore:
    """The replica's answers to a lifecycle, op by op."""

    def __init__(self, specs):
        self.specs = specs
        self.ids: List[tuple] = []
        self.status: List[int] = []
        self.eat: List[Optional[tuple]] = []
        self.keys: Dict[int, _Key] = {}
        self._tokens: List[int] = []   # the keys' tokens, sorted when read
        self._unsorted = False
        self.ranged = _Segments()      # the range index
        self.range_txns: List[int] = []
        self.hlc = 0
        self.applied: List[int] = []   # indices, as they applied

    def _grow(self) -> None:
        while len(self.ids) < len(self.specs):
            self.ids.append(txn_id(self.specs[len(self.ids)]))
            self.status.append(0)
            self.eat.append(None)

    def _key(self, token: int) -> _Key:
        k = self.keys.get(token)
        if k is None:
            k = self.keys[token] = _Key()
            self._tokens.append(token)
            self._unsorted = True
        return k

    def _tokens_in(self, ranges) -> List[int]:
        """The sorted tokens of the keys inside `ranges`."""
        if self._unsorted:
            self._tokens.sort()
            self._unsorted = False
        toks = self._tokens
        return [t for start, end in ranges
                for t in toks[bisect_left(toks, start):
                              bisect_left(toks, end)]]

    def _is_range(self, i: int) -> bool:
        return self.specs[i][1] == RANGE_DOMAIN

    # ------------------------------------------------------------ index --
    def _register(self, i: int, status: int) -> None:
        prev, eat = self.status[i], self.eat[i]
        self.status[i] = max(prev, status)
        if self._is_range(i):
            if prev == 0:
                for start, end in self.specs[i][4]:
                    self.ranged.add(i, start, end, eat)
                self.range_txns.append(i)
            return
        for token in self.specs[i][4]:
            k = self._key(token)
            if status < STABLE:
                k.uncommitted[i] = status
            elif prev < STABLE:
                k.uncommitted.pop(i, None)
                insort(k.committed, (eat, i))
                if self.specs[i][0] == WRITE:
                    insort(k.committed_writes, eat)
            if k.max_ts is None or eat > k.max_ts:
                k.max_ts = eat

    def _key_deps(self, k: _Key, i: int, before: tuple, kinds) -> list:
        """The txns at one key that i's scan below `before` reports."""
        found = [j for j in k.uncommitted
                 if j != i and self.ids[j] < before
                 and self.specs[j][0] in kinds]
        w = bisect_left(k.committed_writes, before) - 1
        start = bisect_left(k.committed, (k.committed_writes[w],)) \
            if w >= 0 else 0
        found += [j for _eat, j in k.committed[start:]
                  if j != i and self.ids[j] < before
                  and self.specs[j][0] in kinds]
        return found

    def _deps(self, i: int, before: tuple) -> tuple:
        kind, parts = self.specs[i][0], self.specs[i][4]
        kinds = WITNESSES[kind]
        tokens = self._tokens_in(parts) if self._is_range(i) else parts
        keyed = [(t, self.ids[j]) for t in tokens if t in self.keys
                 for j in self._key_deps(self.keys[t], i, before, kinds)]
        ranged = set()
        if not self._is_range(i):
            # a range READ's range arm is empty: the index holds READs
            for t in parts:
                for j, start, end in self.ranged.covering(t):
                    if j != i and self.ids[j] < before \
                            and self.specs[j][0] in kinds:
                        ranged.add((start, end, self.ids[j]))
        return tuple(sorted(keyed)), tuple(sorted(ranged))

    def _conflict(self, i: int) -> Optional[tuple]:
        """The highest timestamp i's executeAt must pass."""
        parts = self.specs[i][4]
        if self._is_range(i):
            found = [self.keys[t].max_ts for t in self._tokens_in(parts)]
            found += [self.ranged.top_over(s, e) for s, e in parts]
        else:
            found = [self.keys[t].max_ts for t in parts if t in self.keys]
            if self.range_txns:
                found += [self.ranged.top_over(t, t + 1) for t in parts]
        return max((t for t in found if t is not None), default=None)

    # -------------------------------------------------------------- ops --
    def preaccept(self, i: int) -> tuple:
        self._grow()
        tid = self.ids[i]
        if self.status[i] >= PREACCEPTED:
            return ("preaccept", "REDUNDANT", self.eat[i],
                    self._deps(i, tid))
        top = self._conflict(i)
        if top is None or top < tid:
            eat = tid
        else:
            self.hlc = max(self.hlc, top[1]) + 1
            eat = (1, self.hlc, 0, 1)
        self.eat[i] = eat
        self._register(i, PREACCEPTED)
        return ("preaccept", "SUCCESS", eat, self._deps(i, tid))

    def accept(self, i: int) -> tuple:
        eat = self.eat[i]
        if self.status[i] >= STABLE:
            return ("accept", "REDUNDANT", self._deps(i, eat))
        self._register(i, ACCEPTED)
        return ("accept", "SUCCESS", self._deps(i, eat))

    def commit(self, i: int) -> tuple:
        if self.status[i] >= STABLE:
            return ("commit", "REDUNDANT")
        self._register(i, STABLE)
        return ("commit", "SUCCESS")

    def apply(self, i: int) -> tuple:
        if self.status[i] >= APPLIED:
            return ("apply", "REDUNDANT")
        self._register(i, APPLIED)
        for token in self.specs[i][5]:
            insort(self._key(token).data, (self.eat[i], i))
        self.applied.append(i)
        return ("apply", "SUCCESS")

    def run_window(self, ops) -> list:
        """Every op's reply, in submission order."""
        self._grow()
        return [getattr(self, name)(i) for name, i in ops]

    def data(self) -> Dict[int, Tuple[int, ...]]:
        return {t: tuple(v for _, v in k.data)
                for t, k in self.keys.items() if k.data}

    # ----------------------------------------------------- the card's --
    def served(self, ops) -> int:
        """The deps scans of a window that its flush must serve."""
        changed = {}          # token -> the txns that changed it so far
        moved: List[int] = []  # the same tokens, sorted when read
        n = 0
        for name, i in ops:
            if name not in ("preaccept", "accept"):
                continue
            parts = self.specs[i][4]
            if self._is_range(i):
                # a range transaction changes no key
                moved.sort()
                n += not any(bisect_left(moved, s) < bisect_left(moved, e)
                             for s, e in parts)
                continue
            if all(changed.get(t, {i}) == {i} for t in parts):
                n += 1
            for t in parts:
                if t not in changed:
                    moved.append(t)
                changed.setdefault(t, set()).add(i)
        return n

    def range_served(self, ops) -> int:
        """The range-arm queries of a window that its flush must serve:
        every scan, once the range index holds a transaction."""
        if not self.range_txns:
            return 0
        return sum(name in ("preaccept", "accept") for name, _i in ops)

    def waves(self, ops) -> Dict[int, int]:
        """{hlc: wave} of the window's key-domain Applies, once they have
        run."""
        applies = [i for name, i in ops
                   if name == "apply" and not self._is_range(i)]
        if len(applies) < 2:
            return {}
        applies.sort(key=lambda i: self.eat[i])
        wave: Dict[int, int] = {}
        last: Dict[Tuple[int, int], int] = {}   # (token, kind) -> deepest
        for i in applies:
            kind, tokens = self.specs[i][0], self.specs[i][4]
            w = 1 + max((last.get((t, k), -1) for t in tokens
                         for k in WITNESSES[kind]), default=-1)
            wave[i] = w
            for t in tokens:
                if w > last.get((t, kind), -1):
                    last[(t, kind)] = w
        return {self.specs[i][2]: w for i, w in wave.items()}
