"""Named workload profiles: deterministic-seeded op streams.

A profile is a seeded generator of `Op`s — transport-neutral descriptions
(read tokens, appends, optional range windows, ephemeral flag) that the sim
runner turns into `Txn`s via `build_txn` and the TCP runner ships as submit
frames.  The four named profiles promote the device-kernel microbench
shapes (`bench.py --config zipf1m/rangestress/tpcc`) into end-to-end
protocol-path scenarios, plus the previously-uncovered ephemeral-read path:

  zipfian              hot-key-skewed read+append mix (Zipf 0.99), RMW-heavy
  range_mix            zipfian writes with ~1-in-3 range reads (stab mix)
  tpcc_neworder        TPC-C-style neworder: one hot district counter +
                       10 stock keys per txn, ~1% remote-warehouse
  ephemeral_read_heavy ~85% single-key reads on the EPHEMERAL_READ path
                       (never witnessed, single-round) + 15% writes
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from accord_tpu_torch.utils.random_source import RandomSource


class Op:
    """One client operation, transport-neutral."""

    __slots__ = ("reads", "appends", "ranges", "ephemeral")

    def __init__(self, reads: Tuple[int, ...] = (),
                 appends: Optional[Dict[int, int]] = None,
                 ranges: Optional[Tuple[Tuple[int, int], ...]] = None,
                 ephemeral: bool = False):
        self.reads = tuple(reads)
        self.appends = dict(appends or {})
        self.ranges = ranges
        self.ephemeral = ephemeral
        if ephemeral:
            assert not self.appends and not ranges and len(self.reads) >= 1

    def __repr__(self):
        return (f"Op(reads={self.reads} appends={self.appends} "
                f"ranges={self.ranges} eph={self.ephemeral})")


def build_txn(op: Op):
    """An Op as the sim/in-process Txn (list-register semantics, like the
    burn's generator)."""
    from accord_tpu_torch.impl.list_store import (ListQuery, ListRangeRead,
                                            ListRead, ListUpdate)
    from accord_tpu_torch.primitives.keys import Key, Keys, Ranges
    from accord_tpu_torch.primitives.timestamp import TxnKind
    from accord_tpu_torch.primitives.txn import Txn

    if op.ranges is not None:
        ranges = Ranges.of(*op.ranges)
        return Txn(TxnKind.READ, ranges, read=ListRangeRead(ranges),
                   query=ListQuery())
    if op.ephemeral:
        keys = Keys.of(*op.reads)
        return Txn(TxnKind.EPHEMERAL_READ, keys, read=ListRead(keys),
                   query=ListQuery())
    all_tokens = set(op.reads) | set(op.appends)
    return Txn(
        TxnKind.WRITE if op.appends else TxnKind.READ,
        Keys.of(*all_tokens),
        read=ListRead(Keys.of(*op.reads)) if op.reads else None,
        query=ListQuery(),
        update=ListUpdate({Key(t): v for t, v in op.appends.items()})
        if op.appends else None)


class Profile:
    """Base: seeded op stream with a monotonically unique append counter
    (list-register values must be distinct for the verifiers)."""

    name = "base"

    def __init__(self, keys: int = 64, seed: int = 0):
        assert keys >= 8, "profiles need at least 8 tokens"
        self.keys = keys
        self.rng = RandomSource(seed)
        self.next_value = 0

    def _value(self) -> int:
        v = self.next_value
        self.next_value += 1
        return v

    def next_op(self) -> Op:  # pragma: no cover - abstract
        raise NotImplementedError


class ZipfianProfile(Profile):
    """Hot-key-skewed read+append mix: every witnessed txn touches 1-3
    Zipf(0.99) tokens; ~70% carry a write, RMWs read what they write."""

    name = "zipfian"

    def _token(self) -> int:
        return self.rng.next_zipf(self.keys)

    def next_op(self) -> Op:
        rng = self.rng
        tokens = sorted({self._token()
                         for _ in range(1 + rng.next_int(3))})
        if rng.next_float() < 0.7:
            appends = {t: self._value() for t in tokens
                       if rng.next_float() < 0.8} or \
                {tokens[0]: self._value()}
            reads = tuple(tokens) if rng.next_bool() else \
                tuple(t for t in tokens if t not in appends)
            return Op(reads=reads, appends=appends)
        return Op(reads=tuple(tokens))


class UniformProfile(ZipfianProfile):
    """The zipfian mix SHAPE (1-3 tokens, ~70% writes, RMWs read what
    they write) drawn over a UNIFORM keyspace: the conflict-light control
    for lanes that measure admission/scheduling rather than contention
    (slo-overload) — a skewed draw's hot-key dependency chains add an
    execution-side tail orthogonal to what those lanes test."""

    name = "uniform"

    def _token(self) -> int:
        return self.rng.next_int(self.keys)


class RangeMixProfile(ZipfianProfile):
    """The zipfian mix with ~1-in-3 range reads stabbing a token window
    (the protocol-path version of the rangestress microbench)."""

    name = "range_mix"

    def next_op(self) -> Op:
        rng = self.rng
        if rng.next_int(3) == 0:
            lo = rng.next_int(self.keys - 1)
            hi = min(self.keys,
                     lo + 1 + rng.next_int(1, max(2, self.keys // 4)))
            return Op(ranges=((lo, hi),))
        return super().next_op()


class TpccNewOrderProfile(Profile):
    """TPC-C-style neworder: each txn appends to its district's order
    counter (the classic contention point — districts are the hot low
    tokens) and touches `items` stock tokens, ~1% from a remote warehouse.
    Districts occupy the bottom eighth of the keyspace, stock the rest."""

    name = "tpcc_neworder"

    def __init__(self, keys: int = 64, seed: int = 0, warehouses: int = 4,
                 items: int = 10):
        super().__init__(keys=keys, seed=seed)
        self.n_district = max(2, keys // 8)
        self.warehouses = max(1, min(warehouses, self.n_district))
        self.items = items

    def next_op(self) -> Op:
        rng = self.rng
        w = rng.next_int(self.warehouses)
        per_w = self.n_district // self.warehouses
        district = w * per_w + rng.next_int(max(1, per_w))
        stock_span = self.keys - self.n_district
        stock = set()
        for _ in range(self.items):
            sw = rng.next_int(self.warehouses) \
                if rng.next_float() < 0.01 else w
            stock.add(self.n_district
                      + (sw * 7919 + rng.next_int(stock_span)) % stock_span)
        appends = {district: self._value()}
        for t in sorted(stock):
            appends[t] = self._value()
        return Op(reads=(district,), appends=appends)


class EphemeralReadHeavyProfile(Profile):
    """Read-heavy lane on the ephemeral-read path: ~85% single-key Zipf
    reads as EPHEMERAL_READ (single-round, never witnessed), 15% writes so
    the reads observe growing histories."""

    name = "ephemeral_read_heavy"

    def __init__(self, keys: int = 64, seed: int = 0,
                 read_ratio: float = 0.85):
        super().__init__(keys=keys, seed=seed)
        self.read_ratio = read_ratio

    def next_op(self) -> Op:
        rng = self.rng
        if rng.next_float() < self.read_ratio:
            return Op(reads=(rng.next_zipf(self.keys),), ephemeral=True)
        token = rng.next_zipf(self.keys)
        return Op(reads=(token,), appends={token: self._value()})


PROFILES = {p.name: p for p in (ZipfianProfile, UniformProfile,
                                RangeMixProfile, TpccNewOrderProfile,
                                EphemeralReadHeavyProfile)}


def make_profile(name: str, keys: int = 64, seed: int = 0,
                 **kwargs) -> Profile:
    try:
        cls = PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown profile {name!r}; "
                         f"one of {sorted(PROFILES)}") from None
    return cls(keys=keys, seed=seed, **kwargs)
