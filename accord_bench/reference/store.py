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

Two more answers are the card's: which deps scans it must serve, and the
window's execution waves.

* A flush computes every deps scan of its window on the card, from the
  index as it stood before the window's first op.  A scan is served from
  that snapshot (a device hit) when no op of another transaction that
  ran before it in the window changed one of its keys: the window runs
  its PreAccepts and Accepts, in the order sent, before its Commits and
  Applies, and each registers its transaction at its keys.
* The waves are the Kahn layers of the window's Apply graph: Apply i
  follows Apply j when j's executeAt is lower, they share a key and i's
  kind witnesses j's; a wave is one more than the deepest it follows, and
  a window of fewer than two Applies has no plan.
"""

from __future__ import annotations

from bisect import bisect_left, insort
from typing import Dict, List, Optional, Tuple

READ, WRITE = 1, 2
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


class ReferenceStore:
    """The replica's answers to a lifecycle, op by op."""

    def __init__(self, specs):
        self.specs = specs
        self.ids: List[tuple] = []
        self.status: List[int] = []
        self.eat: List[Optional[tuple]] = []
        self.keys: Dict[int, _Key] = {}
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
        return k

    # ------------------------------------------------------------ index --
    def _register(self, i: int, status: int) -> None:
        prev, eat = self.status[i], self.eat[i]
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
        self.status[i] = max(prev, status)

    def _deps(self, i: int, before: tuple) -> tuple:
        kinds = WITNESSES[self.specs[i][0]]
        out = []
        for token in self.specs[i][4]:
            k = self.keys.get(token)
            if k is None:
                continue
            found = [j for j in k.uncommitted
                     if j != i and self.ids[j] < before
                     and self.specs[j][0] in kinds]
            w = bisect_left(k.committed_writes, before) - 1
            start = bisect_left(k.committed, (k.committed_writes[w],)) \
                if w >= 0 else 0
            found += [j for _eat, j in k.committed[start:]
                      if j != i and self.ids[j] < before
                      and self.specs[j][0] in kinds]
            out += [(token, self.ids[j]) for j in found]
        return tuple(sorted(out)), ()

    # -------------------------------------------------------------- ops --
    def preaccept(self, i: int) -> tuple:
        self._grow()
        tid = self.ids[i]
        if self.status[i] >= PREACCEPTED:
            return ("preaccept", "REDUNDANT", self.eat[i],
                    self._deps(i, tid))
        conflicts = [self.keys[t].max_ts for t in self.specs[i][4]
                     if t in self.keys and self.keys[t].max_ts is not None]
        top = max(conflicts, default=None)
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
        n = 0
        for name, i in ops:
            if name not in ("preaccept", "accept"):
                continue
            tokens = self.specs[i][4]
            if all(changed.get(t, {i}) == {i} for t in tokens):
                n += 1
            for t in tokens:
                changed.setdefault(t, set()).add(i)
        return n

    def waves(self, ops) -> Dict[int, int]:
        """{hlc: wave} of the window's Applies, once they have run."""
        applies = [i for name, i in ops if name == "apply"]
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
