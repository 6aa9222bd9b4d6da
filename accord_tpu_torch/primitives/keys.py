"""The Routables type family: keys, ranges, routes.

Reference: accord/primitives/Routables.java:35, Seekables.java, Unseekables.java,
Route.java:25, AbstractKeys.java, AbstractRanges.java, Range.java, and the api
key model (accord/api/Key.java:28, RoutingKey.java:26).

Two domains — KEY and RANGE — and two roles: *seekable* (data-addressing: Key,
Ranges used by the data plane) vs *unseekable* (position-only routing). Our
keys carry an integer token (the position); hosts may subclass Key to attach
richer identity, exactly as C* does with its partition keys.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.sorted_arrays import (
    linear_intersection, linear_subtract, linear_union,
)


class RoutingKey:
    """Position-only key (unseekable): orders by token. Reference RoutingKey.java:26."""

    __slots__ = ("token",)

    def __init__(self, token: int):
        self.token = token

    def __lt__(self, other): return self.token < other.token
    def __le__(self, other): return self.token <= other.token
    def __gt__(self, other): return self.token > other.token
    def __ge__(self, other): return self.token >= other.token

    def __eq__(self, other):
        return isinstance(other, RoutingKey) and self.token == other.token

    def __hash__(self):
        return hash(self.token)

    def __repr__(self):
        return f"k{self.token}"

    def as_routing(self) -> "RoutingKey":
        return RoutingKey(self.token)


class Key(RoutingKey):
    """Data key (seekable). Hosts subclass to attach payload identity.
    Reference api/Key.java:28 (Key extends Seekable, RoutableKey)."""

    __slots__ = ()

    def __repr__(self):
        return f"K{self.token}"


class _SortedKeyList:
    """Base for Keys/RoutingKeys: immutable sorted unique key sequence."""

    __slots__ = ("_keys", "_tokens")
    _elem = RoutingKey

    def __init__(self, keys: Iterable[RoutingKey] = (), _presorted: bool = False):
        ks = list(keys)
        if not _presorted:
            ks = sorted(set(ks), key=lambda k: k.token)
        self._keys: Tuple[RoutingKey, ...] = tuple(ks)
        # parallel token tuple, built lazily: membership/slice queries then
        # bisect over plain ints (one C call) instead of rich-compared key
        # objects through the generic binary-search wrappers
        self._tokens: Optional[Tuple[int, ...]] = None

    def _tok(self) -> Tuple[int, ...]:
        # try/except rather than a None test: wire-decoded instances may
        # restore only the _keys slot, leaving this one unset
        try:
            t = self._tokens
        except AttributeError:
            t = None
        if t is None:
            t = self._tokens = tuple(k.token for k in self._keys)
        return t

    # -- sequence protocol --
    def __len__(self): return len(self._keys)
    def __iter__(self) -> Iterator[RoutingKey]: return iter(self._keys)
    def __getitem__(self, i): return self._keys[i]
    def __bool__(self): return bool(self._keys)

    def __eq__(self, other):
        return type(self) is type(other) and self._keys == other._keys

    def __hash__(self):
        return hash(self._keys)

    def __repr__(self):
        return f"{type(self).__name__}{list(self._keys)!r}"

    @property
    def is_empty(self) -> bool:
        return not self._keys

    def tokens(self) -> List[int]:
        return [k.token for k in self._keys]

    def contains(self, key: RoutingKey) -> bool:
        toks = self._tok()
        i = bisect.bisect_left(toks, key.token)
        return i < len(toks) and toks[i] == key.token

    def find(self, key: RoutingKey) -> int:
        """Index of key, or -(insertion)-1."""
        toks = self._tok()
        i = bisect.bisect_left(toks, key.token)
        if i < len(toks) and toks[i] == key.token:
            return i
        return -(i + 1)

    # -- set algebra (sorted merges) --
    def with_(self, other: "_SortedKeyList") -> "_SortedKeyList":
        return type(self)(linear_union(self._keys, other._keys), _presorted=True)

    def intersecting(self, other: "_SortedKeyList") -> "_SortedKeyList":
        return type(self)(linear_intersection(self._keys, other._keys), _presorted=True)

    def subtract(self, other: "_SortedKeyList") -> "_SortedKeyList":
        return type(self)(linear_subtract(self._keys, other._keys), _presorted=True)

    def slice(self, ranges: "Ranges") -> "_SortedKeyList":
        toks = self._tok()
        out: List[RoutingKey] = []
        for r in ranges:
            lo = bisect.bisect_left(toks, r.start)
            hi = bisect.bisect_left(toks, r.end, lo)
            if lo < hi:
                out.extend(self._keys[lo:hi])
        if len(out) == len(self._keys):
            return self  # fully covered: immutable, reuse
        if not out:
            cls = type(self)
            empty = cls.__dict__.get("_EMPTY")
            if empty is None:
                empty = cls()
                cls._EMPTY = empty
            return empty
        return type(self)(out, _presorted=True)

    def intersects_ranges(self, ranges: "Ranges") -> bool:
        toks = self._tok()
        for r in ranges:
            lo = bisect.bisect_left(toks, r.start)
            if lo < len(toks) and toks[lo] < r.end:
                return True
        return False

    def foldl(self, fn: Callable, acc):
        for k in self._keys:
            acc = fn(acc, k)
        return acc

    def to_ranges(self) -> "Ranges":
        """Minimal covering Ranges: one unit range per key, adjacent tokens
        merged inline (exactly what normalization would produce, without
        the per-key Range churn — this runs per destination per send via
        Route.covering)."""
        out: List[Range] = []
        start = prev = None
        for k in self._keys:
            t = k.token
            if prev is not None and t == prev + 1:
                prev = t
                continue
            if prev is not None:
                out.append(Range(start, prev + 1))
            start = prev = t
        if prev is not None:
            out.append(Range(start, prev + 1))
        return Ranges(out, _normalized=True)


class Keys(_SortedKeyList):
    """Sorted unique data keys (seekable). Reference primitives/Keys.java."""
    _elem = Key

    def __init__(self, keys: Iterable[Key] = (), _presorted: bool = False):
        super().__init__(keys, _presorted=_presorted)

    @classmethod
    def of(cls, *tokens: int) -> "Keys":
        return cls([Key(t) for t in tokens])

    def as_routing(self) -> "RoutingKeys":
        return RoutingKeys([RoutingKey(k.token) for k in self._keys], _presorted=True)


class RoutingKeys(_SortedKeyList):
    """Sorted unique routing keys (unseekable). Reference primitives/RoutingKeys.java."""

    @classmethod
    def of(cls, *tokens: int) -> "RoutingKeys":
        return cls([RoutingKey(t) for t in tokens])

    def as_routing(self) -> "RoutingKeys":
        return self


EMPTY_KEYS = Keys(())


class Range:
    """Half-open token range [start, end). Reference primitives/Range.java
    (the reference supports both end-inclusive/exclusive variants; we fix
    start-inclusive/end-exclusive, which is the variant its tests exercise)."""

    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        invariants.check_argument(start < end, "range start must precede end")
        self.start = start
        self.end = end

    def contains(self, key: RoutingKey) -> bool:
        return self.start <= key.token < self.end

    def contains_token(self, token: int) -> bool:
        return self.start <= token < self.end

    def intersects(self, other: "Range") -> bool:
        return self.start < other.end and other.start < self.end

    def contains_range(self, other: "Range") -> bool:
        return self.start <= other.start and other.end <= self.end

    def intersection(self, other: "Range") -> Optional["Range"]:
        s, e = max(self.start, other.start), min(self.end, other.end)
        return Range(s, e) if s < e else None

    def _key(self):
        return (self.start, self.end)

    def __lt__(self, other): return self._key() < other._key()
    def __le__(self, other): return self._key() <= other._key()

    def __eq__(self, other):
        return isinstance(other, Range) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"[{self.start},{self.end})"


class Ranges:
    """Sorted, deoverlapped range set. Reference primitives/Ranges.java /
    AbstractRanges.java."""

    __slots__ = ("_ranges", "_starts")

    def __init__(self, ranges: Iterable[Range] = (), _normalized: bool = False):
        rs = list(ranges)
        if not _normalized:
            rs = self._normalize(rs)
        self._ranges: Tuple[Range, ...] = tuple(rs)
        # bisect index for _find_containing, built lazily: Ranges are
        # constructed ~200k times per hostile burn (slices/intersections)
        # and most are never point-probed
        self._starts: Optional[Tuple[int, ...]] = None

    @staticmethod
    def _normalize(rs: List[Range]) -> List[Range]:
        if not rs:
            return []
        rs = sorted(rs, key=lambda r: (r.start, r.end))
        out = [rs[0]]
        for r in rs[1:]:
            last = out[-1]
            if r.start <= last.end:  # overlap or adjacency -> merge
                if r.end > last.end:
                    out[-1] = Range(last.start, r.end)
            else:
                out.append(r)
        return out

    @classmethod
    def of(cls, *pairs: Tuple[int, int]) -> "Ranges":
        return cls([Range(s, e) for s, e in pairs])

    @classmethod
    def single(cls, start: int, end: int) -> "Ranges":
        return cls([Range(start, end)])

    EMPTY: "Ranges"

    def __len__(self): return len(self._ranges)
    def __iter__(self) -> Iterator[Range]: return iter(self._ranges)
    def __getitem__(self, i): return self._ranges[i]
    def __bool__(self): return bool(self._ranges)

    def __eq__(self, other):
        return isinstance(other, Ranges) and self._ranges == other._ranges

    def __hash__(self):
        return hash(self._ranges)

    def __repr__(self):
        return f"Ranges{list(self._ranges)!r}"

    @property
    def is_empty(self) -> bool:
        return not self._ranges

    def contains(self, key: RoutingKey) -> bool:
        return self._find_containing(key.token) is not None

    def contains_token(self, token: int) -> bool:
        return self._find_containing(token) is not None

    def _find_containing(self, token: int) -> Optional[Range]:
        starts = self._starts
        if starts is None:
            starts = self._starts = tuple(r.start for r in self._ranges)
        i = bisect.bisect_right(starts, token) - 1
        if i >= 0 and self._ranges[i].contains_token(token):
            return self._ranges[i]
        return None

    def intersects(self, other) -> bool:
        if isinstance(other, Ranges):
            i = j = 0
            while i < len(self._ranges) and j < len(other._ranges):
                a, b = self._ranges[i], other._ranges[j]
                if a.intersects(b):
                    return True
                if a.end <= b.start:
                    i += 1
                else:
                    j += 1
            return False
        if isinstance(other, _SortedKeyList):
            return other.intersects_ranges(self)
        if isinstance(other, Range):
            return any(r.intersects(other) for r in self._ranges)
        raise TypeError(type(other))

    def intersection(self, other: "Ranges") -> "Ranges":
        out: List[Range] = []
        i = j = 0
        while i < len(self._ranges) and j < len(other._ranges):
            a, b = self._ranges[i], other._ranges[j]
            x = a.intersection(b)
            if x is not None:
                out.append(x)
            if a.end <= b.end:
                i += 1
            else:
                j += 1
        return Ranges(out, _normalized=True)

    # intersection is slicing for ranges
    slice = intersection

    def union(self, other: "Ranges") -> "Ranges":
        return Ranges(list(self._ranges) + list(other._ranges))

    def subtract(self, other: "Ranges") -> "Ranges":
        out: List[Range] = []
        for a in self._ranges:
            pieces = [a]
            for b in other._ranges:
                nxt: List[Range] = []
                for p in pieces:
                    if not p.intersects(b):
                        nxt.append(p)
                        continue
                    if p.start < b.start:
                        nxt.append(Range(p.start, b.start))
                    if b.end < p.end:
                        nxt.append(Range(b.end, p.end))
                pieces = nxt
            out.extend(pieces)
        return Ranges(out)

    def contains_all_keys(self, keys: _SortedKeyList) -> bool:
        return all(self.contains(k) for k in keys)

    def contains_all_ranges(self, other: "Ranges") -> bool:
        return other.subtract(self).is_empty


Ranges.EMPTY = Ranges(())


class Route:
    """Routing cover for a transaction: participating routing keys + the home
    key (the shard that owns coordination/recovery responsibility).

    Reference: primitives/Route.java:25 (FullKeyRoute/PartialKeyRoute/
    FullRangeRoute/PartialRangeRoute). We model key- and range-domain routes
    with one class carrying either keys or ranges; `is_full` marks whether it
    covers the whole transaction (a Full route) or a shard slice (Partial).
    """

    __slots__ = ("home_key", "keys", "ranges", "is_full")

    def __init__(self, home_key: RoutingKey, keys: Optional[RoutingKeys] = None,
                 ranges: Optional[Ranges] = None, is_full: bool = True):
        invariants.check_argument((keys is None) != (ranges is None),
                                  "route holds keys xor ranges")
        self.home_key = home_key
        self.keys = keys
        self.ranges = ranges
        self.is_full = is_full

    @classmethod
    def of_keys(cls, home_key: RoutingKey, keys: RoutingKeys) -> "Route":
        return cls(home_key, keys=keys)

    @classmethod
    def of_ranges(cls, home_key: RoutingKey, ranges: Ranges) -> "Route":
        return cls(home_key, ranges=ranges)

    @classmethod
    def probe(cls, participants) -> "Route":
        """Partial route over bare participants (Keys/RoutingKeys/Ranges),
        for rounds that only need to reach the owning shards — route
        discovery (FindRoute's someUnseekables) and watermark queries. The
        nominal home key is the first participant."""
        if isinstance(participants, Ranges):
            return cls(RoutingKey(participants[0].start),
                       ranges=participants, is_full=False)
        routing = participants.as_routing()
        return cls(routing[0], keys=routing, is_full=False)

    @property
    def is_key_domain(self) -> bool:
        return self.keys is not None

    def participants(self):
        return self.keys if self.keys is not None else self.ranges

    def covering(self) -> Ranges:
        """Minimal Ranges covering the participants."""
        if self.ranges is not None:
            return self.ranges
        return self.keys.to_ranges()

    def participant_keys(self) -> "Keys":
        """Data-key view of a key-domain route (empty for range routes)."""
        if self.keys is None:
            return Keys(())
        return Keys([Key(k.token) for k in self.keys])

    def slice(self, ranges: Ranges) -> "Route":
        if self.keys is not None:
            return Route(self.home_key, keys=self.keys.slice(ranges), is_full=False)
        return Route(self.home_key, ranges=self.ranges.slice(ranges), is_full=False)

    def owned_participants(self, ranges: Ranges):
        """Participants falling within a store's owned `ranges`; the full
        participant set for an unbounded (empty-ranges) store. The shared
        idiom for 'what slice of this route does this store answer for'."""
        if ranges.is_empty:
            return self.participants()
        return self.slice(ranges).participants()

    def with_(self, other: "Route") -> "Route":
        invariants.check_argument(other.home_key == self.home_key, "home key mismatch")
        if self.keys is not None:
            return Route(self.home_key, keys=self.keys.with_(other.keys),
                         is_full=self.is_full or other.is_full)
        return Route(self.home_key, ranges=self.ranges.union(other.ranges),
                     is_full=self.is_full or other.is_full)

    def intersects(self, ranges: Ranges) -> bool:
        if self.keys is not None:
            return self.keys.intersects_ranges(ranges)
        return self.ranges.intersects(ranges)

    def contains(self, key: RoutingKey) -> bool:
        if self.keys is not None:
            return self.keys.contains(key)
        return self.ranges.contains(key)

    def __eq__(self, other):
        return (isinstance(other, Route) and self.home_key == other.home_key
                and self.keys == other.keys and self.ranges == other.ranges
                and self.is_full == other.is_full)

    def __hash__(self):
        return hash((self.home_key, self.keys, self.ranges, self.is_full))

    def __repr__(self):
        body = self.keys if self.keys is not None else self.ranges
        return f"Route(home={self.home_key}, {body!r}, full={self.is_full})"
