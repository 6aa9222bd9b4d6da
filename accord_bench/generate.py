"""The benchmark's one traffic generator.

A configuration (``configs/<name>.json``) gives the key model: which rows a
transaction reads and writes.  A traffic mix (``traffic/<name>.json``)
gives the lifecycle's parameters.  From these and the seed, ``Traffic``
draws the transactions and cuts them into flush windows, always in the
same order, so a run and the reference that checks it see the same ops.

A transaction is plain data, ``(kind, domain, hlc, node, tokens,
writes)``: kind 1 is READ and 2 WRITE (the protocol's TxnKind numbers),
domain 0 is the key domain, hlc grows by 1 or 2 each transaction, node is
its coordinator (one of the shard's ``source_replicas``), tokens are the
sorted keys it declares (every row it reads or writes, as Accord registers
a transaction at each of its keys) and writes the sorted keys its update
writes.  An op is ``(name, txn index)``.  Window w of the lifecycle:

* preaccepts the ``window`` new transactions of batch w;
* accepts every ``accept_every``-th transaction of batch w - 1;
* commits (stable) and then applies batch w - ``commit_lag``.

The key models:

* ``ycsb``: YCSB's CoreWorkload, one key an operation, READ with
  ``readproportion``, else an UPDATE (a blind write); keys drawn by
  ``ScrambledZipfianGenerator`` (a Zipf(0.99) rank over 10**10 items, then
  FNV-1a-64 hashed onto the records).
* ``tpcc``: TPC-C v5.11's five transactions in its mix, each declaring every
  row it reads and writes (clauses 2.4-2.8), over the initial database of
  clause 4.3.3.1.  Rows that a transaction finds by a read (the district's
  next order id, the oldest undelivered order, a customer by last name, a
  customer's last order, the last 20 orders' lines) are resolved by the
  generator, which keeps the database's order tables as the transactions it
  drew left them: a reconnaissance read made before submission.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np

READ, WRITE = 1, 2
KEY_DOMAIN = 0
FIRST_HLC = 1000
MASK64 = (1 << 64) - 1


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


class YcsbKeys:
    """YCSB core workload operations: one key each, READ with probability
    `readproportion`, else UPDATE."""

    def __init__(self, config: dict, rng: np.random.Generator, seed: int):
        self.rng = rng
        self.zipf = ScrambledZipfian(config["recordcount"],
                                     config["zipfian_constant"])
        self.read = config["readproportion"]

    def draw(self) -> Tuple[int, tuple, tuple]:
        kind = READ if self.rng.random() < self.read else WRITE
        key = (self.zipf.draw(self.rng),)
        return kind, key, key if kind == WRITE else ()


# ----------------------------------------------------------------- TPC-C --
# a row's token: its table above TABLE_SHIFT, its row number below
TABLE_SHIFT = 40
(WAREHOUSE, DISTRICT, CUSTOMER, ITEM, STOCK, ORDER, NEW_ORDER, ORDER_LINE,
 HISTORY) = range(9)
ORDER_BITS = 24      # order ids of a district
LINE_BITS = 4        # order line numbers 1-15


def row(table: int, number: int) -> int:
    return table << TABLE_SHIFT | number


class _District:
    """A district's order tables as the drawn transactions leave them."""

    __slots__ = ("perm", "next_o", "undelivered", "last_order", "orders",
                 "names")

    def __init__(self, perm, next_o, undelivered, last_order, names):
        self.perm = perm                    # order o's customer: perm[o-1]
        self.next_o = next_o
        self.undelivered = undelivered
        self.last_order = last_order        # [customer] -> order id
        self.orders: Dict[int, tuple] = {}  # order id -> (customer, lines)
        self.names = names                  # [customer - 1] -> last name


class TpccKeys:
    """TPC-C's transactions as the rows they read and write.

    The initial database (clause 4.3.3.1): each district holds
    `initial_orders` orders, their customers a random permutation, 5-15
    lines each of a uniform item from the home warehouse, the last
    `initial_new_orders` of them undelivered; customers 1-1000 carry the
    last names 0-999 in turn, the others NURand(255, 0, 999).  Each
    district's load is drawn from the seed and the district alone, when a
    transaction first needs it."""

    def __init__(self, config: dict, rng: np.random.Generator, seed: int):
        self.rng = rng
        self.seed = seed % (1 << 64)
        self.w = config["warehouses"]
        self.d = config["districts_per_warehouse"]
        self.customers = config["customers_per_district"]
        self.items = config["items"]
        self.lines = config["order_lines"]
        self.remote_line = config["remote_line"]
        self.rollback = config["rollback"]
        self.remote_payment = config["payment_remote_customer"]
        self.by_name = config["by_last_name"]
        self.initial_orders = config["initial_orders"]
        self.initial_new = config["initial_new_orders"]
        self.stock_orders = config["stock_level_orders"]
        mix = config["transaction_mix"]
        self.kinds = list(mix)
        self.cum = np.cumsum([mix[k] for k in self.kinds])
        if abs(self.cum[-1] - 1.0) > 1e-9:
            raise ValueError("the transaction mix does not sum to 1")
        a = config["nurand_a"]
        self.a_last, self.a_cid, self.a_item = a["c_last"], a["c_id"], \
            a["ol_i_id"]
        # NURand's constants C (clause 2.1.6): C_LAST's at load, and at run
        # time one that differs from it by 65-119, but not 96 or 112
        self.c_load = int(rng.integers(0, self.a_last + 1))
        delta = int(rng.choice([x for x in range(65, 120)
                                if x not in (96, 112)]))
        self.c_last = self.c_load + delta \
            if self.c_load + delta <= self.a_last else self.c_load - delta
        self.c_cid = int(rng.integers(0, self.a_cid + 1))
        self.c_item = int(rng.integers(0, self.a_item + 1))
        self.districts: Dict[int, _District] = {}
        self.history = 0
        self.draws = {"new_order": self._new_order, "payment": self._payment,
                      "order_status": self._order_status,
                      "delivery": self._delivery,
                      "stock_level": self._stock_level}

    # ------------------------------------------------------------ draws --
    def nurand(self, a: int, x: int, y: int, c: int, rng=None, size=None):
        """NURand(A, x, y) with the constant `c`: one number, or an array
        of `size`."""
        r = self.rng if rng is None else rng
        if size is not None:
            return ((r.integers(0, a + 1, size) | r.integers(x, y + 1, size))
                    + c) % (y - x + 1) + x
        return (((int(r.integers(0, a + 1)) | int(r.integers(x, y + 1))) + c)
                % (y - x + 1)) + x

    def _load(self, dist: int) -> _District:
        state = self.districts.get(dist)
        if state is not None:
            return state
        r = np.random.default_rng([self.seed, 1, dist])
        n = self.customers
        perm = r.permutation(n) + 1
        last_order = np.zeros(n + 1, np.int64)
        last_order[perm[:self.initial_orders]] = np.arange(
            1, self.initial_orders + 1)
        names = np.concatenate([
            np.arange(min(n, 1000)),
            self.nurand(self.a_last, 0, 999, self.c_load, r,
                        max(0, n - 1000))])
        first_new = self.initial_orders - self.initial_new + 1
        state = self.districts[dist] = _District(
            perm, self.initial_orders + 1,
            deque(range(first_new, self.initial_orders + 1)), last_order,
            names)
        return state

    def _order(self, dist: int, o: int) -> tuple:
        """(customer, ((supply warehouse, item), ...)) of order o."""
        state = self._load(dist)
        got = state.orders.get(o)
        if got is None:                       # an order of the initial load
            r = np.random.default_rng([self.seed, 2, dist, o])
            count = int(r.integers(self.lines[0], self.lines[1] + 1))
            items = r.integers(1, self.items + 1, count)
            home = dist // self.d
            got = state.orders[o] = (int(state.perm[o - 1]),
                                     tuple((home, int(i)) for i in items))
        return got

    def _customer(self, dist: int) -> Tuple[int, List[int]]:
        """A customer by last name (60%: every customer of that name is
        read, the middle one by id chosen) or by id -> (chosen, read)."""
        if self.rng.random() < self.by_name:
            name = self.nurand(self.a_last, 0, 999, self.c_last)
            same = (np.flatnonzero(self._load(dist).names == name)
                    + 1).tolist()
            return same[(len(same) + 1) // 2 - 1], same
        c = self.nurand(self.a_cid, 1, self.customers, self.c_cid)
        return c, [c]

    def _other_warehouse(self, w: int) -> int:
        return (w + 1 + int(self.rng.integers(self.w - 1))) % self.w

    def _cust(self, dist: int, c: int) -> int:
        return row(CUSTOMER, dist * self.customers + c - 1)

    @staticmethod
    def _ord(table: int, dist: int, o: int) -> int:
        return row(table, dist << ORDER_BITS | o)

    @staticmethod
    def _line(dist: int, o: int, ol: int) -> int:
        return row(ORDER_LINE, (dist << ORDER_BITS | o) << LINE_BITS | ol)

    def _stock(self, w: int, item: int) -> int:
        return row(STOCK, w * self.items + item - 1)

    def _new_order(self):
        r = self.rng
        w = int(r.integers(self.w))
        dist = w * self.d + int(r.integers(self.d))
        state = self._load(dist)
        c = self.nurand(self.a_cid, 1, self.customers, self.c_cid)
        count = int(r.integers(self.lines[0], self.lines[1] + 1))
        rolled_back = r.random() < self.rollback
        lines = []
        for ol in range(count):
            item = self.nurand(self.a_item, 1, self.items, self.c_item)
            if rolled_back and ol == count - 1:
                item = self.items + 1         # an unused item: rolls back
            supply = w
            if self.w > 1 and r.random() < self.remote_line:
                supply = self._other_warehouse(w)
            lines.append((supply, item))
        o = state.next_o
        reads = [row(WAREHOUSE, w), self._cust(dist, c)] + [
            row(ITEM, item - 1) for _, item in lines]
        writes = [row(DISTRICT, dist), self._ord(ORDER, dist, o),
                  self._ord(NEW_ORDER, dist, o)] + [
            self._line(dist, o, ol + 1) for ol in range(count)] + [
            self._stock(s, item) for s, item in lines]
        if rolled_back:
            # the keys are declared; the update writes nothing and the
            # order id is not taken (clause 2.4.2.3)
            return WRITE, set(reads) | set(writes), ()
        state.next_o += 1
        state.orders[o] = (c, tuple(lines))
        state.undelivered.append(o)
        state.last_order[c] = o
        return WRITE, set(reads) | set(writes), writes

    def _payment(self):
        r = self.rng
        w = int(r.integers(self.w))
        dist = w * self.d + int(r.integers(self.d))
        c_dist = dist
        if self.w > 1 and r.random() < self.remote_payment:
            c_dist = self._other_warehouse(w) * self.d + int(
                r.integers(self.d))
        c, read = self._customer(c_dist)
        self.history += 1
        writes = [row(WAREHOUSE, w), row(DISTRICT, dist),
                  self._cust(c_dist, c), row(HISTORY, self.history)]
        return WRITE, set(writes) | {self._cust(c_dist, x) for x in read}, \
            writes

    def _order_status(self):
        r = self.rng
        dist = int(r.integers(self.w)) * self.d + int(r.integers(self.d))
        c, read = self._customer(dist)
        keys = {self._cust(dist, x) for x in read}
        o = int(self._load(dist).last_order[c])
        if o:
            _c, lines = self._order(dist, o)
            keys.add(self._ord(ORDER, dist, o))
            keys.update(self._line(dist, o, ol)
                        for ol in range(1, len(lines) + 1))
        return READ, keys, ()

    def _delivery(self):
        w = int(self.rng.integers(self.w))
        writes = []
        for dist in range(w * self.d, (w + 1) * self.d):
            state = self._load(dist)
            if not state.undelivered:
                continue                      # skipped (clause 2.7.4.2)
            o = state.undelivered.popleft()
            c, lines = self._order(dist, o)
            writes += [self._ord(NEW_ORDER, dist, o),
                       self._ord(ORDER, dist, o)] + [
                self._line(dist, o, ol) for ol in range(1, len(lines) + 1)] \
                + [self._cust(dist, c)]
        return WRITE, set(writes), writes

    def _stock_level(self):
        r = self.rng
        w = int(r.integers(self.w))
        dist = w * self.d + int(r.integers(self.d))
        state = self._load(dist)
        keys = {row(DISTRICT, dist)}
        for o in range(max(1, state.next_o - self.stock_orders),
                       state.next_o):
            _c, lines = self._order(dist, o)
            for ol, (_s, item) in enumerate(lines, 1):
                keys.add(self._line(dist, o, ol))
                keys.add(self._stock(w, item))
        return READ, keys, ()

    def draw(self) -> Tuple[int, tuple, tuple]:
        i = int(np.searchsorted(self.cum, self.rng.random(), side="right"))
        kind, keys, writes = self.draws[self.kinds[min(i, len(self.kinds)
                                                       - 1)]]()
        return kind, tuple(sorted(keys)), tuple(sorted(set(writes)))


KEY_MODELS = {"ycsb": YcsbKeys, "tpcc": TpccKeys}


class Traffic:
    """The lifecycle of a configuration under a mix, drawn from the seed."""

    def __init__(self, config: dict, mix: dict, seed: int):
        if mix["shape"] != "lifecycle":
            raise ValueError(f"unknown traffic shape {mix['shape']!r}")
        self.rng = seeded_rng(seed)
        self.keys = KEY_MODELS[config["key_model"]](config, self.rng, seed)
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
            kind, tokens, writes = self.keys.draw()
            self.txns.append((kind, KEY_DOMAIN, self._hlc, node, tokens,
                              writes))

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
