"""Dependency sets in CSR form: KeyDeps, RangeDeps, Deps.

Reference: accord/primitives/KeyDeps.java:150-172 (CSR layout), :115-148
(merge), RangeDeps.java:63-120, Deps.java:36,98-124, and the shared helpers in
accord/utils/RelationMultiMap.java:58-80.

Layout (identical to the reference): sorted unique `keys`, sorted unique
`txn_ids`, and `keys_to_txn_ids` — the first len(keys) ints are *end offsets*
into the tail, the tail holds indices into txn_ids. This flat-int-array form is
deliberately the device format too: accord_tpu_torch.ops consumes these arrays
zero-copy as int32 numpy buffers.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.primitives.keys import Key, Keys, Range, Ranges, RoutingKey, RoutingKeys
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils import invariants
from operator import attrgetter

from accord_tpu_torch.utils.sorted_arrays import (find_ceil, linear_merge_n,
                                            linear_union)

# sort key for timestamp-like elements: C-level int compares on the packed
# total-order key instead of Python-level __lt__ dispatch per comparison
_CMP_KEY = attrgetter("_cmp")


def _build_csr(sorted_lhs: Sequence, lhs_to_sets: Dict, sorted_rhs: Sequence
               ) -> Tuple[int, ...]:
    """Build the [end-offsets..., value-indices...] CSR tail.

    Timestamps index by their packed `_cmp` int (hash/eq on plain ints take
    CPython's C fast path; the object forms dispatch to Python-level
    __hash__/__eq__ per probe, which made this dict build a top profile
    entry on the deps hot path).  Range lhs values have no `_cmp`; both
    element kinds sort by the same total order either way."""
    if sorted_rhs and hasattr(sorted_rhs[0], "_cmp"):
        rhs_index = {v._cmp: i for i, v in enumerate(sorted_rhs)}
        key_of = _CMP_KEY
    else:
        rhs_index = {v: i for i, v in enumerate(sorted_rhs)}
        key_of = None
    offsets: List[int] = []
    values: List[int] = []
    for lhs in sorted_lhs:
        ids = sorted(lhs_to_sets[lhs], key=key_of)
        if key_of is not None:
            values.extend(rhs_index[t._cmp] for t in ids)
        else:
            values.extend(rhs_index[t] for t in ids)
        offsets.append(len(sorted_lhs) + len(values))
    return tuple(offsets + values)


class KeyDeps:
    """key -> [TxnId] bidirectional multimap in CSR form (KeyDeps.java:150-172)."""

    __slots__ = ("keys", "txn_ids", "keys_to_txn_ids", "_inverse")

    def __init__(self, keys: Keys, txn_ids: Tuple[TxnId, ...],
                 keys_to_txn_ids: Tuple[int, ...]):
        self.keys = keys
        self.txn_ids = txn_ids
        self.keys_to_txn_ids = keys_to_txn_ids
        self._inverse: Optional[Tuple[Tuple[int, ...], ...]] = None  # lazy txn->keys

    # -- construction --
    NONE: "KeyDeps"

    class Builder:
        def __init__(self):
            self._map: Dict[Key, Set[TxnId]] = {}

        def add(self, key: Key, txn_id: TxnId) -> "KeyDeps.Builder":
            s = self._map.get(key)
            if s is None:
                s = self._map[key] = set()
            s.add(txn_id)
            return self

        def add_all(self, keys: Iterable[Key], txn_id: TxnId) -> "KeyDeps.Builder":
            for k in keys:
                self.add(k, txn_id)
            return self

        def is_empty(self) -> bool:
            return not self._map

        def build(self) -> "KeyDeps":
            if not self._map:
                return KeyDeps.NONE
            if len(self._map) == 1:
                # single-key deps (the common shape of a key txn's
                # calculate_deps): the CSR is the identity mapping
                (k, ids), = self._map.items()
                pool = tuple(sorted(ids, key=_CMP_KEY))
                n = len(pool)
                return KeyDeps(Keys((k,), _presorted=True), pool,
                               (1 + n,) + tuple(range(n)))
            keys = Keys(self._map.keys())
            all_ids = sorted(set().union(*self._map.values()), key=_CMP_KEY)
            csr = _build_csr(list(keys), self._map, all_ids)
            return KeyDeps(keys, tuple(all_ids), csr)

    @classmethod
    def builder(cls) -> "KeyDeps.Builder":
        return cls.Builder()

    @classmethod
    def of(cls, mapping: Dict[Key, Iterable[TxnId]]) -> "KeyDeps":
        b = cls.Builder()
        for k, ids in mapping.items():
            for t in ids:
                b.add(k, t)
        return b.build()

    # -- accessors --
    @property
    def is_empty(self) -> bool:
        return not self.keys

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def key_count(self) -> int:
        return len(self.keys)

    def _span(self, key_idx: int) -> Tuple[int, int]:
        nk = len(self.keys)
        start = self.keys_to_txn_ids[key_idx - 1] if key_idx > 0 else nk
        end = self.keys_to_txn_ids[key_idx]
        return start, end

    def txn_ids_for_key(self, key) -> List[TxnId]:
        i = self.keys.find(key)
        if i < 0:
            return []
        s, e = self._span(i)
        return [self.txn_ids[self.keys_to_txn_ids[j]] for j in range(s, e)]

    def for_each(self, key, fn: Callable[[TxnId], None]) -> None:
        for t in self.txn_ids_for_key(key):
            fn(t)

    def for_each_unique_txn_id(self, fn: Callable[[TxnId], None]) -> None:
        for t in self.txn_ids:
            fn(t)

    def contains(self, txn_id: TxnId) -> bool:
        i = find_ceil(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    def _invert(self) -> Tuple[Tuple[int, ...], ...]:
        """txn-idx -> tuple of key indices (lazily computed; KeyDeps.java inverts
        the CSR the same way)."""
        if self._inverse is None:
            inv: List[List[int]] = [[] for _ in self.txn_ids]
            nk = len(self.keys)
            for ki in range(nk):
                s, e = self._span(ki)
                for j in range(s, e):
                    inv[self.keys_to_txn_ids[j]].append(ki)
            self._inverse = tuple(tuple(x) for x in inv)
        return self._inverse

    def participants(self, txn_id: TxnId) -> Keys:
        """Keys this txn participates in (reference participants(TxnId))."""
        i = find_ceil(self.txn_ids, txn_id)
        if i >= len(self.txn_ids) or self.txn_ids[i] != txn_id:
            return Keys(())
        return Keys([self.keys[ki] for ki in self._invert()[i]], _presorted=True)

    def participating_keys(self) -> Keys:
        return self.keys

    # -- algebra (linear CSR walks; reference RelationMultiMap.LinearMerger
    # merges the flat arrays the same way, no intermediate maps) --
    def _span_indices(self, ki: int) -> List[int]:
        s, e = self._span(ki)
        return [self.keys_to_txn_ids[j] for j in range(s, e)]

    def _remap_into(self, merged_ids: Sequence[TxnId]) -> List[int]:
        """positions of our (sorted) txn_ids within merged (sorted) ids."""
        remap: List[int] = []
        j = 0
        for t in self.txn_ids:
            while merged_ids[j] != t:
                j += 1
            remap.append(j)
        return remap

    @staticmethod
    def _from_spans(keys: List[Key], spans: List[List[int]],
                    id_pool: Sequence[TxnId]) -> "KeyDeps":
        """Assemble a CSR from per-key ascending id-index lists, compacting
        the id pool to the indices actually referenced."""
        if not keys:
            return KeyDeps.NONE
        used = sorted({i for span in spans for i in span})
        compact = {old: new for new, old in enumerate(used)}
        ids = tuple(id_pool[i] for i in used)
        nk = len(keys)
        ends: List[int] = []
        payload: List[int] = []
        off = nk
        for span in spans:
            payload.extend(compact[i] for i in span)
            off += len(span)
            ends.append(off)
        return KeyDeps(Keys(keys, _presorted=True), ids,
                       tuple(ends + payload))

    def with_(self, other: "KeyDeps") -> "KeyDeps":
        if self.is_empty:
            return other
        if other.is_empty:
            return self
        merged_ids = linear_union(self.txn_ids, other.txn_ids)
        remap_a = self._remap_into(merged_ids)
        remap_b = other._remap_into(merged_ids)
        keys_a, keys_b = list(self.keys), list(other.keys)
        out_keys: List[Key] = []
        out_spans: List[List[int]] = []
        ia = ib = 0
        while ia < len(keys_a) or ib < len(keys_b):
            if ib >= len(keys_b) or (ia < len(keys_a)
                                     and keys_a[ia] < keys_b[ib]):
                out_keys.append(keys_a[ia])
                out_spans.append([remap_a[i] for i in self._span_indices(ia)])
                ia += 1
            elif ia >= len(keys_a) or keys_b[ib] < keys_a[ia]:
                out_keys.append(keys_b[ib])
                out_spans.append([remap_b[i]
                                  for i in other._span_indices(ib)])
                ib += 1
            else:
                sa = [remap_a[i] for i in self._span_indices(ia)]
                sb = [remap_b[i] for i in other._span_indices(ib)]
                out_keys.append(keys_a[ia])
                out_spans.append(list(linear_union(sa, sb)))
                ia += 1
                ib += 1
        return KeyDeps._from_spans(out_keys, out_spans, merged_ids)

    def without(self, predicate: Callable[[TxnId], bool]) -> "KeyDeps":
        keep = [not predicate(t) for t in self.txn_ids]
        if all(keep):
            return self
        out_keys: List[Key] = []
        out_spans: List[List[int]] = []
        for ki, k in enumerate(self.keys):
            span = [i for i in self._span_indices(ki) if keep[i]]
            if span:
                out_keys.append(k)
                out_spans.append(span)
        return KeyDeps._from_spans(out_keys, out_spans, self.txn_ids)

    def without_ids(self, remove: Set[TxnId]) -> "KeyDeps":
        return self.without(lambda t: t in remove)

    def slice(self, ranges: Ranges) -> "KeyDeps":
        owned = self.keys.slice(ranges)
        if owned is self.keys or len(owned) == len(self.keys):
            return self  # fully covered: one bisect pass, no span rebuild
        out_keys: List[Key] = []
        out_spans: List[List[int]] = []
        for k in owned:
            ki = self.keys.find(k)
            out_keys.append(k)
            out_spans.append(self._span_indices(ki))
        return KeyDeps._from_spans(out_keys, out_spans, self.txn_ids)

    @staticmethod
    def merge(deps: Sequence["KeyDeps"]) -> "KeyDeps":
        """Single-pass k-way merge over the flat CSRs (the reference's
        LinearMerger): one id-pool union, one remap per input, one walk over
        the merged key space — no per-pair CSR rebuilds."""
        live = [d for d in deps if d is not None and not d.is_empty]
        if not live:
            return KeyDeps.NONE
        if len(live) == 1:
            return live[0]
        merged_ids: Sequence[TxnId] = linear_merge_n(
            [d.txn_ids for d in live])
        remaps = [d._remap_into(merged_ids) for d in live]
        idxs = [0] * len(live)
        out_keys: List[Key] = []
        out_spans: List[List[int]] = []
        while True:
            cur = None
            for src, d in enumerate(live):
                if idxs[src] < len(d.keys):
                    k = d.keys[idxs[src]]
                    if cur is None or k < cur:
                        cur = k
            if cur is None:
                break
            span: List[int] = []
            for src, d in enumerate(live):
                i = idxs[src]
                if i < len(d.keys) and d.keys[i] == cur:
                    s = [remaps[src][j] for j in d._span_indices(i)]
                    span = list(linear_union(span, s)) if span else s
                    idxs[src] += 1
            out_keys.append(cur)
            out_spans.append(span)
        return KeyDeps._from_spans(out_keys, out_spans, merged_ids)

    def __eq__(self, other):
        return (isinstance(other, KeyDeps) and self.keys == other.keys
                and self.txn_ids == other.txn_ids
                and self.keys_to_txn_ids == other.keys_to_txn_ids)

    def __hash__(self):
        return hash((self.keys, self.txn_ids))

    def __repr__(self):
        return f"KeyDeps({ {k: self.txn_ids_for_key(k) for k in self.keys} })"


KeyDeps.NONE = KeyDeps(Keys(()), (), ())


class RangeDeps:
    """Range -> [TxnId] CSR multimap; ranges may overlap (RangeDeps.java:63-120).

    Stabbing queries (which ranges cover key X) go through the CINTIA
    checkpoint-interval index (reference SearchableRangeList.java:79,
    CheckpointIntervalArray.java:28-84), built lazily on first query once the
    range count justifies it; small sets use a direct sorted scan.
    """

    __slots__ = ("ranges", "txn_ids", "ranges_to_txn_ids", "_index")

    INDEX_THRESHOLD = 16

    def __init__(self, ranges: Tuple[Range, ...], txn_ids: Tuple[TxnId, ...],
                 ranges_to_txn_ids: Tuple[int, ...]):
        self.ranges = ranges            # sorted by (start, end); may overlap
        self.txn_ids = txn_ids          # sorted unique
        self.ranges_to_txn_ids = ranges_to_txn_ids
        self._index = None              # lazy CheckpointIntervalIndex

    NONE: "RangeDeps"

    class Builder:
        def __init__(self):
            self._map: Dict[Range, Set[TxnId]] = {}

        def add(self, rng: Range, txn_id: TxnId) -> "RangeDeps.Builder":
            self._map.setdefault(rng, set()).add(txn_id)
            return self

        def is_empty(self) -> bool:
            return not self._map

        def build(self) -> "RangeDeps":
            if not self._map:
                return RangeDeps.NONE
            ranges = sorted(self._map.keys(), key=lambda r: (r.start, r.end))
            all_ids = sorted(set().union(*self._map.values()))
            csr = _build_csr(ranges, self._map, all_ids)
            return RangeDeps(tuple(ranges), tuple(all_ids), csr)

    @classmethod
    def builder(cls) -> "RangeDeps.Builder":
        return cls.Builder()

    @classmethod
    def of(cls, mapping: Dict[Range, Iterable[TxnId]]) -> "RangeDeps":
        b = cls.Builder()
        for r, ids in mapping.items():
            for t in ids:
                b.add(r, t)
        return b.build()

    @property
    def is_empty(self) -> bool:
        return not self.ranges

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def _span(self, range_idx: int) -> Tuple[int, int]:
        nr = len(self.ranges)
        start = self.ranges_to_txn_ids[range_idx - 1] if range_idx > 0 else nr
        end = self.ranges_to_txn_ids[range_idx]
        return start, end

    def txn_ids_for_range_idx(self, i: int) -> List[TxnId]:
        s, e = self._span(i)
        return [self.txn_ids[self.ranges_to_txn_ids[j]] for j in range(s, e)]

    def _stab_index(self):
        if self._index is None and len(self.ranges) >= self.INDEX_THRESHOLD:
            from accord_tpu_torch.utils.checkpoint_intervals import \
                CheckpointIntervalIndex
            self._index = CheckpointIntervalIndex(
                [r.start for r in self.ranges], [r.end for r in self.ranges])
        return self._index

    def _emit(self, i: int, seen: Set[TxnId], fn: Callable[[TxnId], None]
              ) -> None:
        for t in self.txn_ids_for_range_idx(i):
            if t not in seen:
                seen.add(t)
                fn(t)

    def for_each_covering(self, key: RoutingKey, fn: Callable[[TxnId], None],
                          dedup: Optional[Set[TxnId]] = None) -> None:
        """Visit txn ids of every range containing `key`, once each."""
        seen = dedup if dedup is not None else set()
        index = self._stab_index()
        if index is not None:
            index.find(key.token, lambda i: self._emit(i, seen, fn))
            return
        for i, r in enumerate(self.ranges):
            if r.start > key.token:
                break
            if r.contains(key):
                self._emit(i, seen, fn)

    def for_each_intersecting(self, rng: Range, fn: Callable[[TxnId], None],
                              dedup: Optional[Set[TxnId]] = None) -> None:
        seen = dedup if dedup is not None else set()
        index = self._stab_index()
        if index is not None:
            index.find_overlaps(rng.start, rng.end,
                                lambda i: self._emit(i, seen, fn))
            return
        for i, r in enumerate(self.ranges):
            if r.start >= rng.end:
                break
            if r.intersects(rng):
                self._emit(i, seen, fn)

    def for_each_unique_txn_id(self, fn: Callable[[TxnId], None]) -> None:
        for t in self.txn_ids:
            fn(t)

    def contains(self, txn_id: TxnId) -> bool:
        i = find_ceil(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    def participants(self, txn_id: TxnId) -> Ranges:
        out: List[Range] = []
        for i in range(len(self.ranges)):
            if txn_id in self.txn_ids_for_range_idx(i):
                out.append(self.ranges[i])
        return Ranges(out)

    def _as_map(self) -> Dict[Range, Set[TxnId]]:
        return {r: set(self.txn_ids_for_range_idx(i))
                for i, r in enumerate(self.ranges)}

    def with_(self, other: "RangeDeps") -> "RangeDeps":
        if self.is_empty:
            return other
        if other.is_empty:
            return self
        m = self._as_map()
        for r, ids in other._as_map().items():
            m.setdefault(r, set()).update(ids)
        return RangeDeps.of(m)

    def without(self, predicate: Callable[[TxnId], bool]) -> "RangeDeps":
        m = {r: {t for t in ids if not predicate(t)}
             for r, ids in self._as_map().items()}
        return RangeDeps.of({r: ids for r, ids in m.items() if ids})

    def slice(self, ranges: Ranges) -> "RangeDeps":
        m: Dict[Range, Set[TxnId]] = {}
        for i, r in enumerate(self.ranges):
            for s in ranges:
                x = r.intersection(s)
                if x is not None:
                    m.setdefault(x, set()).update(self.txn_ids_for_range_idx(i))
        return RangeDeps.of(m)

    @staticmethod
    def merge(deps: Sequence["RangeDeps"]) -> "RangeDeps":
        live = [d for d in deps if d is not None and not d.is_empty]
        if not live:
            return RangeDeps.NONE
        if len(live) == 1:
            return live[0]
        m = live[0]._as_map()
        for d in live[1:]:
            for r, ids in d._as_map().items():
                m.setdefault(r, set()).update(ids)
        return RangeDeps.of(m)

    def __eq__(self, other):
        return (isinstance(other, RangeDeps) and self.ranges == other.ranges
                and self.txn_ids == other.txn_ids
                and self.ranges_to_txn_ids == other.ranges_to_txn_ids)

    def __hash__(self):
        return hash((self.ranges, self.txn_ids))

    def __repr__(self):
        return f"RangeDeps({self._as_map()!r})"


RangeDeps.NONE = RangeDeps((), (), ())


class Deps:
    """The pair {keyDeps, rangeDeps} (Deps.java:36,98-124)."""

    __slots__ = ("key_deps", "range_deps")

    NONE: "Deps"

    def __init__(self, key_deps: KeyDeps = None, range_deps: RangeDeps = None):
        self.key_deps = key_deps if key_deps is not None else KeyDeps.NONE
        self.range_deps = range_deps if range_deps is not None else RangeDeps.NONE

    @property
    def is_empty(self) -> bool:
        return self.key_deps.is_empty and self.range_deps.is_empty

    def txn_id_count(self) -> int:
        return len(self.txn_id_set())

    def txn_id_set(self) -> Set[TxnId]:
        return set(self.key_deps.txn_ids) | set(self.range_deps.txn_ids)

    def sorted_txn_ids(self) -> List[TxnId]:
        if not self.range_deps.txn_ids:
            # key_deps.txn_ids is already the sorted unique pool
            return list(self.key_deps.txn_ids)
        return sorted(self.txn_id_set(), key=_CMP_KEY)

    def contains(self, txn_id: TxnId) -> bool:
        return self.key_deps.contains(txn_id) or self.range_deps.contains(txn_id)

    def for_each_unique_txn_id(self, fn: Callable[[TxnId], None]) -> None:
        for t in self.sorted_txn_ids():
            fn(t)

    def participants(self, txn_id: TxnId):
        """Keys/Ranges through which txn_id appears."""
        return (self.key_deps.participants(txn_id),
                self.range_deps.participants(txn_id))

    def with_(self, other: "Deps") -> "Deps":
        return Deps(self.key_deps.with_(other.key_deps),
                    self.range_deps.with_(other.range_deps))

    def without(self, predicate: Callable[[TxnId], bool]) -> "Deps":
        return Deps(self.key_deps.without(predicate),
                    self.range_deps.without(predicate))

    def slice(self, ranges: Ranges) -> "Deps":
        return Deps(self.key_deps.slice(ranges), self.range_deps.slice(ranges))

    def intersects(self, ranges: Ranges) -> bool:
        return (self.key_deps.keys.intersects_ranges(ranges)
                or any(any(r.intersects(s) for s in ranges)
                       for r in self.range_deps.ranges))

    @staticmethod
    def merge(deps: Sequence["Deps"]) -> "Deps":
        live = [d for d in deps if d is not None]
        return Deps(KeyDeps.merge([d.key_deps for d in live]),
                    RangeDeps.merge([d.range_deps for d in live]))

    def max_txn_id(self) -> Optional[TxnId]:
        ids = self.txn_id_set()
        return max(ids) if ids else None

    def __eq__(self, other):
        return (isinstance(other, Deps) and self.key_deps == other.key_deps
                and self.range_deps == other.range_deps)

    def __hash__(self):
        return hash((self.key_deps, self.range_deps))

    def __repr__(self):
        return f"Deps(keys={self.key_deps!r}, ranges={self.range_deps!r})"


Deps.NONE = Deps(KeyDeps.NONE, RangeDeps.NONE)
