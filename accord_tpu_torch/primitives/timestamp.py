"""Hybrid-logical-clock timestamps and transaction identity.

Reference: accord/primitives/Timestamp.java:27-140 (bit layout :36-44,80-90),
TxnId.java:32,124-157, Ballot.java:23, Txn.java:53-265 (kind conflict matrix
:220-260).

Bit layout follows the reference's 128-bit packing so timestamps round-trip
losslessly to a pair of int64 device lanes (accord_tpu_torch.ops.timestamps):
    msb = epoch(48b) | hlc_high(16b)
    lsb = hlc_low(48b) | flags(16b)      flags: REJECTED=0x8000, domain(1b), kind(3b)
plus a 32-bit node id used as the final comparison tie-breaker.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

from accord_tpu_torch.utils import invariants

FLAG_REJECTED = 0x8000
_KIND_SHIFT = 1          # bits 1..3 of flags
_KIND_MASK = 0b111 << _KIND_SHIFT
_DOMAIN_MASK = 0b1       # bit 0 of flags
_HLC_LOW_BITS = 48
_HLC_LOW_MASK = (1 << _HLC_LOW_BITS) - 1
_EPOCH_BITS = 48
MAX_EPOCH = (1 << _EPOCH_BITS) - 1


class Domain(enum.IntEnum):
    KEY = 0
    RANGE = 1


class TxnKind(enum.IntEnum):
    """Transaction kinds (reference Txn.Kind, Txn.java:53).

    The conflict matrix (witnesses/witnessedBy, Txn.java:220-260) decides which
    prior transactions appear in a new transaction's dependency set.
    """

    READ = 1
    WRITE = 2
    EPHEMERAL_READ = 3
    SYNC_POINT = 4
    EXCLUSIVE_SYNC_POINT = 5
    LOCAL_ONLY = 6

    def witnesses(self) -> "KindSet":
        return _WITNESSES[self]

    def witnessed_by(self) -> "KindSet":
        return _WITNESSED_BY[self]

    @property
    def is_write(self) -> bool:
        return self is TxnKind.WRITE or self is TxnKind.EXCLUSIVE_SYNC_POINT

    @property
    def is_read(self) -> bool:
        return self in (TxnKind.READ, TxnKind.EPHEMERAL_READ)

    @property
    def is_sync_point(self) -> bool:
        return self in (TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT)

    @property
    def is_globally_visible(self) -> bool:
        """Can this txn appear in other txns' deps? (Txn.java AnyGloballyVisible)"""
        return self not in (TxnKind.EPHEMERAL_READ, TxnKind.LOCAL_ONLY)

    @property
    def awaits_only_deps(self) -> bool:
        """Sync points execute once deps apply; they have no data read/write."""
        return self.is_sync_point


class KindSet(frozenset):
    """A set of TxnKinds with a packed-int device encoding."""

    def test(self, kind: TxnKind) -> bool:
        return kind in self

    def mask(self) -> int:
        # cached per instance: the protocol's KindSets are the handful of
        # module constants below, and the hot per-key scans test kind
        # membership via this mask instead of a frozenset hash per entry
        try:
            return self._mask
        except AttributeError:
            m = 0
            for k in self:
                m |= 1 << int(k)
            self._mask = m
            return m


WRITES = KindSet({TxnKind.WRITE, TxnKind.EXCLUSIVE_SYNC_POINT})
READS_OR_WRITES = KindSet({TxnKind.READ, TxnKind.WRITE,
                           TxnKind.EXCLUSIVE_SYNC_POINT})
ANY_GLOBALLY_VISIBLE = KindSet({TxnKind.READ, TxnKind.WRITE, TxnKind.SYNC_POINT,
                                TxnKind.EXCLUSIVE_SYNC_POINT})
NONE_KINDS = KindSet()

# what each kind's deps must include (Txn.java:220-260: Reads witness Ws;
# Writes witness RsOrWs; ESP witnesses AnyGloballyVisible).
_WITNESSES = {
    TxnKind.READ: WRITES,
    TxnKind.WRITE: READS_OR_WRITES,
    TxnKind.EPHEMERAL_READ: WRITES,
    TxnKind.SYNC_POINT: READS_OR_WRITES,
    TxnKind.EXCLUSIVE_SYNC_POINT: ANY_GLOBALLY_VISIBLE,
    TxnKind.LOCAL_ONLY: NONE_KINDS,
}

_WITNESSED_BY = {
    k: KindSet({o for o in TxnKind if k in _WITNESSES[o]}) for k in TxnKind
}

# -- hot-path lookup tables (derived; the dicts above stay the single source
#    of truth).  Enum by-value construction costs ~µs per call and the
#    protocol engine resolves kind/domain/witnesses tens of millions of
#    times per burn — a tuple index is ~50ns.
_KIND_BY_INT = tuple(TxnKind(i) if any(int(k) == i for k in TxnKind) else None
                     for i in range(8))
_DOMAIN_BY_INT = (Domain.KEY, Domain.RANGE)
# _WITNESS_BITS[kind_int] bit j set <=> kind witnesses TxnKind(j)
_WITNESS_BITS = tuple(
    sum(1 << int(o) for o in _WITNESSES[_KIND_BY_INT[i]])
    if _KIND_BY_INT[i] is not None else 0
    for i in range(8))


class Timestamp:
    """Immutable 128-bit HLC timestamp + node id.

    Total order: (epoch, hlc, flags, node) lexicographic — identical to the
    reference's msb/lsb/node compare (Timestamp.java compareTo).
    """

    __slots__ = ("epoch", "hlc", "flags", "node", "_cmp", "_repr")

    def __init__(self, epoch: int, hlc: int, flags: int, node: int):
        # inline packing-range validation (one branch, no helper-call
        # frames): timestamps are constructed on every wire decode / HLC
        # advance, so the two check_argument calls here were measurable
        if (epoch | hlc | flags | node) < 0 or epoch > MAX_EPOCH \
                or hlc >> 64 or flags >> 16 or node >> 32:
            invariants.check_argument(0 <= epoch <= MAX_EPOCH,
                                      "epoch out of range")
            invariants.check_argument(
                False, "timestamp component out of packing range")
        self.epoch = epoch
        self.hlc = hlc
        self.flags = flags
        self.node = node
        # packed total-order key: one int comparison per <=> instead of a
        # tuple build (timestamp compares dominate the host engine — ~45%
        # of a deep apply-chain profile before this)
        self._cmp = ((((epoch << 80) | hlc) << 16) | flags) << 32 | node

    # -- construction --
    @classmethod
    def from_bits(cls, epoch: int, hlc: int, flags: int, node: int) -> "Timestamp":
        return cls(epoch, hlc, flags, node)

    @classmethod
    def none(cls) -> "Timestamp":
        return NONE

    @classmethod
    def max_value(cls) -> "Timestamp":
        return MAX

    def with_epoch_at_least(self, epoch: int) -> "Timestamp":
        return self if epoch <= self.epoch else type(self)(epoch, self.hlc, self.flags, self.node)

    def with_flags(self, flags: int) -> "Timestamp":
        return type(self)(self.epoch, self.hlc, flags, self.node)

    def as_rejected(self) -> "Timestamp":
        return self.with_flags(self.flags | FLAG_REJECTED)

    @property
    def is_rejected(self) -> bool:
        return bool(self.flags & FLAG_REJECTED)

    def next_hlc(self) -> "Timestamp":
        return Timestamp(self.epoch, self.hlc + 1, 0, self.node)

    # -- packing (device lanes; reference bit layout Timestamp.java:36-44) --
    def msb(self) -> int:
        return (self.epoch << 16) | ((self.hlc >> _HLC_LOW_BITS) & 0xFFFF)

    def lsb(self) -> int:
        return ((self.hlc & _HLC_LOW_MASK) << 16) | (self.flags & 0xFFFF)

    def pack(self) -> Tuple[int, int, int]:
        return (self.msb(), self.lsb(), self.node)

    @classmethod
    def unpack(cls, msb: int, lsb: int, node: int) -> "Timestamp":
        epoch = msb >> 16
        hlc = ((msb & 0xFFFF) << _HLC_LOW_BITS) | (lsb >> 16)
        return cls(epoch, hlc, lsb & 0xFFFF, node)

    # -- ordering (all via the packed key) --
    def __lt__(self, other): return self._cmp < other._cmp
    def __le__(self, other): return self._cmp <= other._cmp
    def __gt__(self, other): return self._cmp > other._cmp
    def __ge__(self, other): return self._cmp >= other._cmp

    def __eq__(self, other):
        return isinstance(other, Timestamp) and self._cmp == other._cmp

    def __hash__(self):
        return hash(self._cmp)

    def compare_to(self, other: "Timestamp") -> int:
        a, b = self._cmp, other._cmp
        return -1 if a < b else (1 if a > b else 0)

    @staticmethod
    def max(a: "Timestamp", b: "Timestamp") -> "Timestamp":
        return a if a >= b else b

    @staticmethod
    def min(a: "Timestamp", b: "Timestamp") -> "Timestamp":
        return a if a <= b else b

    @staticmethod
    def non_null_or_max(a: Optional["Timestamp"], b: Optional["Timestamp"]):
        if a is None:
            return b
        if b is None:
            return a
        return Timestamp.max(a, b)

    def merge_max(self, other: "Timestamp") -> "Timestamp":
        """Component-wise dominance merge used by HLC propagation."""
        return self if self >= other else other

    def __repr__(self):
        return f"[{self.epoch},{self.hlc},{self.flags:x},{self.node}]"


class TxnId(Timestamp):
    """Timestamp whose flags carry Txn kind (3b) + domain (1b).

    Reference: TxnId.java:32,124-157.
    """

    __slots__ = ()

    def __init__(self, epoch: int, hlc: int, flags: int, node: int):
        super().__init__(epoch, hlc, flags, node)
        # validate kind bits at the source (unpack/wire paths take flags
        # verbatim): a lookup-table miss would otherwise surface later as a
        # silently thinner deps set.  flags == 0 is the NONE sentinel.
        if flags and _KIND_BY_INT[(flags & _KIND_MASK) >> _KIND_SHIFT] is None:
            invariants.check_argument(
                False, "invalid TxnKind bits in flags %s", flags)

    @classmethod
    def create(cls, epoch: int, hlc: int, kind: TxnKind, domain: Domain,
               node: int) -> "TxnId":
        flags = (int(kind) << _KIND_SHIFT) | int(domain)
        return cls(epoch, hlc, flags, node)

    @classmethod
    def from_timestamp(cls, ts: Timestamp) -> "TxnId":
        return cls(ts.epoch, ts.hlc, ts.flags, ts.node)

    @property
    def kind(self) -> TxnKind:
        k = _KIND_BY_INT[(self.flags & _KIND_MASK) >> _KIND_SHIFT]
        if k is None:  # the NONE sentinel has no kind (matches TxnKind(0))
            raise ValueError(f"no TxnKind in flags {self.flags:#x}")
        return k

    @property
    def domain(self) -> Domain:
        return _DOMAIN_BY_INT[self.flags & _DOMAIN_MASK]

    @property
    def is_key_domain(self) -> bool:
        return not (self.flags & _DOMAIN_MASK)

    @property
    def is_range_domain(self) -> bool:
        return bool(self.flags & _DOMAIN_MASK)

    @property
    def is_write(self) -> bool:
        return self.kind.is_write

    @property
    def is_visible(self) -> bool:
        return self.kind.is_globally_visible

    def witnesses(self, other: "TxnId") -> bool:
        """Must `other` (an earlier txn) appear in this txn's deps?"""
        return bool(_WITNESS_BITS[(self.flags & _KIND_MASK) >> _KIND_SHIFT]
                    >> ((other.flags & _KIND_MASK) >> _KIND_SHIFT) & 1)

    def witnessed_by(self, other_kind: TxnKind) -> bool:
        return other_kind in self.kind.witnessed_by()

    def as_timestamp(self) -> Timestamp:
        return Timestamp(self.epoch, self.hlc, self.flags, self.node)

    def __repr__(self):
        # cached lazily (unset slot -> AttributeError): the repr IS the
        # trace/flight key, recomputed per status transition and span event
        # for the same long-lived TxnId instance
        try:
            return self._repr
        except AttributeError:
            pass
        if self._cmp == 0:
            s = "TxnId.NONE"
        else:
            s = (f"{self.kind.name[0]}{'R' if self.is_range_domain else ''}"
                 f"[{self.epoch},{self.hlc},{self.node}]")
        self._repr = s
        return s


class Ballot(Timestamp):
    """Paxos-style promise ballot (reference Ballot.java:23)."""

    __slots__ = ()

    ZERO: "Ballot"

    @classmethod
    def zero(cls) -> "Ballot":
        return BALLOT_ZERO

    def __repr__(self):
        return f"B[{self.epoch},{self.hlc},{self.node}]"


NONE = Timestamp(0, 0, 0, 0)
MAX = Timestamp(MAX_EPOCH, (1 << 63) - 1, 0xFFFF, (1 << 31) - 1)
BALLOT_ZERO = Ballot(0, 0, 0, 0)
Ballot.ZERO = BALLOT_ZERO
TXNID_NONE = TxnId(0, 0, 0, 0)
