"""The benchmark's one traffic generator.

A configuration (``configs/<name>.json``) names its key model, which says
which rows a transaction reads and writes.  A traffic mix
(``traffic/<name>.json``) gives the lifecycle's parameters.  From these and
the seed, ``Traffic`` draws the transactions and cuts them into flush
windows, always in the same order, so a run and the reference that checks
it see the same ops.

A transaction is plain data, ``(kind, domain, hlc, node, parts, writes)``:
kind 1 is READ and 2 WRITE (the protocol's TxnKind numbers), hlc grows by 1
or 2 each transaction, node is its coordinator (one of the shard's
``source_replicas``).  In the key domain (0) parts are the sorted keys it
declares (every row it reads or writes, as Accord registers a transaction
at each of its keys) and writes the sorted keys its update writes.  In the
range domain (1) parts are the sorted, disjoint half-open ``(start, end)``
token ranges it reads, no two adjacent and each inside the configuration's
``span``; it writes nothing, and it is a READ (the reference knows no other
range transaction).  An op is ``(name, txn index)``.  Window w of the
lifecycle:

* preaccepts the ``window`` new transactions of batch w;
* accepts every ``accept_every``-th transaction of batch w - 1;
* commits (stable) and then applies batch w - ``commit_lag``.

A key model is the file ``key_models/<key_model>.py``, found by the name
the configuration gives, as a metric's reader is.  It defines
``KeyModel(config, rng, seed)``, whose ``draw()`` returns one transaction's
``(kind, domain, parts, writes)``, drawing only from ``rng`` (the
generator's, shared with the lifecycle) and from generators of its own
seeded from ``seed``.  The helpers key models share stay here:
``seeded_rng``, ``fnvhash64`` and ``ScrambledZipfian``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import List

import numpy as np

READ, WRITE = 1, 2
KEY_DOMAIN, RANGE_DOMAIN = 0, 1
FIRST_HLC = 1000
MASK64 = (1 << 64) - 1
HERE = Path(__file__).resolve().parent


def seeded_rng(seed: int) -> np.random.Generator:
    """Any whole number is a seed; negative ones map to distinct streams."""
    return np.random.default_rng(seed % (1 << 64))


# ------------------------------------------------------------------ YCSB --
# YCSB's ScrambledZipfianGenerator (core/generator/): ITEM_COUNT and the
# zeta it precomputes for the constant 0.99, and Utils.fnvhash64
ZIPF_ITEMS = 10_000_000_000
ZIPF_ZETAN = 26.46902820178302
FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def fnvhash64(value: int) -> int:
    """YCSB's Utils.fnvhash64: FNV-1a over the eight low bytes, in signed
    64-bit arithmetic, then Math.abs."""
    h = FNV_OFFSET_64
    for _ in range(8):
        h = ((h ^ (value & 0xFF)) * FNV_PRIME_64) & MASK64
        value >>= 8
    return (1 << 64) - h if h >= 1 << 63 else h


class ScrambledZipfian:
    """YCSB's ScrambledZipfianGenerator(0, records): a ZipfianGenerator
    rank over ``ZIPF_ITEMS`` + 1 items (Gray et al.'s method), hashed onto
    ``records`` + 1 slots; CoreWorkload draws again past the last record."""

    def __init__(self, records: int, theta: float):
        if theta != 0.99:
            raise ValueError("only YCSB's precomputed constant 0.99")
        self.records = records
        self.slots = records + 1
        items = ZIPF_ITEMS + 1
        self.items = items
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = 1.0 + 0.5 ** theta
        self.half_pow = 0.5 ** theta
        self.eta = (1 - (2.0 / items) ** (1 - theta)) \
            / (1 - zeta2 / ZIPF_ZETAN)

    def rank(self, u: float) -> int:
        uz = u * ZIPF_ZETAN
        if uz < 1.0:
            return 0
        if uz < 1.0 + self.half_pow:
            return 1
        return int(self.items * (self.eta * u - self.eta + 1) ** self.alpha)

    def draw(self, rng: np.random.Generator) -> int:
        while True:
            key = fnvhash64(self.rank(float(rng.random()))) % self.slots
            if key < self.records:
                return key


def load_key_model(name: str):
    """The class ``KeyModel`` of ``key_models/<name>.py``."""
    path = HERE / "key_models" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no key model {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"accord_bench.key_models.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.KeyModel


def checked(kind: int, domain: int, parts: tuple, writes: tuple,
            span) -> tuple:
    """A drawn transaction's (kind, domain, parts, writes), once it is one
    the reference has semantics for; raises ValueError otherwise."""
    if kind not in (READ, WRITE):
        raise ValueError(f"kind {kind}: only READ and WRITE transactions")
    if domain == KEY_DOMAIN:
        return kind, domain, parts, writes
    if domain != RANGE_DOMAIN:
        raise ValueError(f"unknown domain {domain}")
    if kind != READ or writes:
        raise ValueError("a range transaction is a READ and writes nothing")
    lo, hi = span
    edge = lo - 1
    for start, end in parts:
        if not edge < start < end <= hi:
            raise ValueError(f"range parts {parts} are not sorted, disjoint "
                             f"and apart inside the span {span}")
        edge = end
    if not parts:
        raise ValueError("a range transaction reads at least one range")
    return kind, domain, tuple(tuple(p) for p in parts), ()


class Traffic:
    """The lifecycle of a configuration under a mix, drawn from the seed."""

    def __init__(self, config: dict, mix: dict, seed: int):
        if mix["shape"] != "lifecycle":
            raise ValueError(f"unknown traffic shape {mix['shape']!r}")
        self.rng = seeded_rng(seed)
        self.keys = load_key_model(config["key_model"])(config, self.rng,
                                                        seed)
        self.span = tuple(config["span"])
        self.coordinators = config["source_replicas"]
        self.window = mix["window"]
        self.accept_every = mix["accept_every"]
        self.commit_lag = mix["commit_lag"]
        self.warmup_windows = -(-mix["warmup_txns"] // self.window)
        self.txns: List[tuple] = []
        self._hlc = FIRST_HLC

    def _batch(self) -> None:
        r = self.rng
        for _ in range(self.window):
            self._hlc += 1 + int(r.integers(2))
            node = 1 + int(r.integers(self.coordinators))
            kind, domain, parts, writes = checked(*self.keys.draw(),
                                                  self.span)
            self.txns.append((kind, domain, self._hlc, node, parts, writes))

    def batch(self, w: int) -> range:
        return range(w * self.window, (w + 1) * self.window)

    def ops(self, w: int) -> List[tuple]:
        """Window w's ops, in the order they are submitted."""
        while len(self.txns) < (w + 1) * self.window:
            self._batch()
        ops = [("preaccept", i) for i in self.batch(w)]
        if w >= 1:
            ops += [("accept", i)
                    for i in self.batch(w - 1)[::self.accept_every]]
        if w >= self.commit_lag:
            done = self.batch(w - self.commit_lag)
            ops += [("commit", i) for i in done]
            ops += [("apply", i) for i in done]
        return ops

    def applied_batch(self, w: int) -> range:
        """The transactions window w applies (empty before commit_lag)."""
        return self.batch(w - self.commit_lag) if w >= self.commit_lag \
            else range(0)
