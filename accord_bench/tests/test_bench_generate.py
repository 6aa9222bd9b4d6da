"""The traffic generator against hand-worked cases."""

import hashlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from accord_bench import generate
from accord_bench.generate import (
    KEY_DOMAIN, RANGE_DOMAIN, READ, WRITE, ZIPF_ZETAN, ScrambledZipfian,
    Traffic, fnvhash64, seeded_rng)
from accord_bench.key_models.tpcc import (
    CUSTOMER, DISTRICT, HISTORY, ITEM, NEW_ORDER, ORDER, ORDER_LINE, STOCK,
    TABLE_SHIFT, WAREHOUSE, TpccKeys, row)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
YCSB = json.loads((CONFIGS / "ycsb-a.json").read_text())
TPCC = json.loads((CONFIGS / "tpcc.json").read_text())


def mix(window=4, warm=8):
    return {"shape": "lifecycle", "window": window, "accept_every": 2,
            "commit_lag": 2, "warmup_txns": warm, "windows_per_s": 1.0}


def table(token):
    return token >> TABLE_SHIFT


def test_fnvhash64_by_hand():
    # FNV-1a over the eight bytes of 0: the offset times the prime, 8 times
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = h * 1099511628211 % 2**64
    signed = h - 2**64 if h >= 2**63 else h
    assert fnvhash64(0) == abs(signed)
    assert all(0 <= fnvhash64(v) < 2**63 for v in range(1000))
    assert len({fnvhash64(v) for v in range(1000)}) == 1000


def test_scrambled_zipfian_shares():
    z = ScrambledZipfian(1000, 0.99)
    assert z.rank(0.0) == 0 and z.rank(0.999 / ZIPF_ZETAN) == 0
    assert z.rank(1.001 / ZIPF_ZETAN) == 1
    r = seeded_rng(5)
    keys = Counter(z.draw(r) for _ in range(40000))
    assert set(keys) <= set(range(1000)) and len(keys) > 900
    # the hottest item (rank 0, about 1/zeta of the draws) lands on one
    # key, scrambled away from key 0
    top, n = keys.most_common(1)[0]
    assert top == fnvhash64(0) % 1001
    assert 0.03 < n / 40000 < 0.05


def test_ycsb_operations_are_one_key():
    t = Traffic(YCSB, mix(), 2**31 + 77)
    t.ops(50)
    kinds = Counter(s[0] for s in t.txns)
    assert 0.4 < kinds[READ] / len(t.txns) < 0.6
    for kind, domain, _hlc, node, tokens, writes in t.txns:
        assert domain == 0 and 1 <= node <= 3 and len(tokens) == 1
        assert 0 <= tokens[0] < 1000
        assert writes == (tokens if kind == WRITE else ())


def test_lifecycle_windows_by_hand():
    t = Traffic(YCSB, mix(), 1)
    assert t.ops(0) == [("preaccept", i) for i in range(4)]
    assert t.ops(1) == [("preaccept", i) for i in range(4, 8)] + [
        ("accept", 0), ("accept", 2)]
    assert t.ops(2) == [("preaccept", i) for i in range(8, 12)] + [
        ("accept", 4), ("accept", 6)] + [("commit", i) for i in range(4)] + [
        ("apply", i) for i in range(4)]
    assert list(t.applied_batch(1)) == [] and \
        list(t.applied_batch(3)) == [4, 5, 6, 7]
    assert t.warmup_windows == 2


def test_transactions_from_the_seed():
    for config in (YCSB, TPCC):
        a, b = Traffic(config, mix(), 2**31 + 77), \
            Traffic(config, mix(), 2**31 + 77)
        a.ops(5)
        for w in range(6):
            b.ops(w)
        assert a.txns == b.txns
        c, d = Traffic(config, mix(), 3), Traffic(config, mix(), 4)
        c.ops(3)
        d.ops(3)
        assert c.txns != d.txns
        hlcs = [s[2] for s in a.txns]
        assert all(x < y for x, y in zip(hlcs, hlcs[1:]))
        for _k, _d, _h, _n, tokens, writes in a.txns:
            assert list(tokens) == sorted(set(tokens))
            assert set(writes) <= set(tokens)
    assert seeded_rng(-1).random() != seeded_rng(1).random()


def kind_of(kind, tokens):
    tables = {table(t) for t in tokens}
    if kind == READ:
        return "order_status" if CUSTOMER in tables else "stock_level"
    if HISTORY in tables:
        return "payment"
    return "new_order" if ITEM in tables else "delivery"


def test_tpcc_mix_and_rows():
    keys = TpccKeys(TPCC, seeded_rng(9), 9)
    seen = Counter()
    for _ in range(6000):
        kind, tokens, writes = keys.draw()
        name = kind_of(kind, tokens)
        seen[name] += 1
        tables = Counter(table(t) for t in tokens)
        wtables = Counter(table(t) for t in writes)
        if name == "new_order":
            lines = tables[ORDER_LINE]
            assert 5 <= lines <= 15 and tables[ITEM] <= lines
            assert tables[WAREHOUSE] == tables[DISTRICT] == 1
            assert tables[CUSTOMER] == tables[ORDER] == tables[NEW_ORDER] == 1
            assert not writes or (wtables[DISTRICT] == 1 and
                                  wtables[ORDER_LINE] == lines and
                                  WAREHOUSE not in wtables)
        elif name == "payment":
            assert wtables == Counter({WAREHOUSE: 1, DISTRICT: 1,
                                       CUSTOMER: 1, HISTORY: 1})
        elif name == "delivery":
            assert wtables[NEW_ORDER] == wtables[ORDER] == 10
            assert wtables[CUSTOMER] <= 10 and \
                50 <= wtables[ORDER_LINE] <= 150
        else:
            assert not writes
    shares = {k: v / 6000 for k, v in seen.items()}
    assert abs(shares["new_order"] - 0.45) < 0.03
    assert abs(shares["payment"] - 0.43) < 0.03
    for k in ("order_status", "delivery", "stock_level"):
        assert 0.025 < shares[k] < 0.055


def test_tpcc_order_tables_follow_the_draws():
    keys = TpccKeys(dict(TPCC, warehouses=1, districts_per_warehouse=1,
                         transaction_mix={"new_order": 1.0}), seeded_rng(2), 2)
    kinds = [keys.draw() for _ in range(30)]
    committed = [k for k in kinds if k[2]]
    state = keys.districts[0]
    # the orders are numbered from 3001, a rollback takes none
    assert state.next_o == 3001 + len(committed)
    orders = sorted(t & ((1 << 24) - 1) for _k, toks, w in committed
                    for t in w if table(t) == ORDER)
    assert orders == list(range(3001, 3001 + len(committed)))
    # Delivery takes the oldest undelivered order, 2101 of the load
    keys.kinds, keys.cum = ["delivery"], np.array([1.0])
    _k, _t, writes = keys.draw()
    assert row(NEW_ORDER, 2101) in writes and row(ORDER, 2101) in writes
    # Stock-Level reads the last 20 orders' lines and their stock
    keys.kinds = ["stock_level"]
    kind, tokens, writes = keys.draw()
    lines = {t & ((1 << 28) - 1) for t in tokens if table(t) == ORDER_LINE}
    last = sorted({x >> 4 for x in lines})
    assert last == list(range(state.next_o - 20, state.next_o))
    assert kind == READ and writes == () and \
        {table(t) for t in tokens} == {DISTRICT, ORDER_LINE, STOCK}


def test_tpcc_customer_by_last_name():
    keys = TpccKeys(TPCC, seeded_rng(4), 4)
    keys.by_name = 1.0
    for _ in range(50):
        c, read = keys._customer(17)
        names = keys.districts[17].names
        assert read == [x for x in range(1, 3001)
                        if names[x - 1] == names[c - 1]]
        assert c == read[(len(read) + 1) // 2 - 1]
    # customers 1-1000 carry the names 0-999 in turn
    assert list(names[:1000]) == list(range(1000))
    assert 0 <= names.min() and names.max() <= 999


def test_nurand_by_hand():
    keys = TpccKeys(TPCC, seeded_rng(0), 0)

    class Fixed:
        def integers(self, lo, hi=None):
            return {(0, 4): 2, (1, 11): 5}[(lo, hi)]
    # ((2 | 5) + 7) % 10 + 1 = (7 + 7) % 10 + 1 = 5
    assert keys.nurand(3, 1, 10, 7, Fixed()) == 5
    # the run-time C_LAST differs from the load's by 65-119, not 96 or 112
    delta = abs(keys.c_last - keys.c_load)
    assert 65 <= delta <= 119 and delta not in (96, 112)


# sha256 of the JSON of the first 8 windows' transactions of each accepted
# configuration under its cell's mix, taken before the key models moved
# into key_models/: the move keeps every draw
PINNED = {
    ("ycsb-a", "lifecycle-w512", 0):
        "81a55ad0a5f6ae0026ac718cc42696a378c4440070197f2053b812c8b6a6622b",
    ("ycsb-a", "lifecycle-w512", 1):
        "daa27f93d6ed155e6d87fe33dbcdb6cbc3ef96c3cec411440b9825b96f7816d8",
    ("ycsb-a", "lifecycle-w512", 2):
        "372830d08a0c9be197686f531352d442481d451736d60adca6c510de3e89c25b",
    ("tpcc", "lifecycle-w128", 0):
        "3374fe0c340a055e57767e981c381e72d8e59b60b79e241c65db2d5b1b6d11fe",
    ("tpcc", "lifecycle-w128", 1):
        "d60b596ff86538376cd499d305b823d0fff6ae988bd9b22ad668204f4eb63b39",
    ("tpcc", "lifecycle-w128", 2):
        "11ff361f060eaece376ea950d535bc1aed61f1fddf9a91548c34df989870b9c3",
}


@pytest.mark.parametrize("config,traffic,seed", sorted(PINNED))
def test_draws_match_the_pinned_digest(config, traffic, seed):
    t = Traffic(json.loads((CONFIGS / f"{config}.json").read_text()),
                json.loads((CONFIGS.parent / "traffic" / f"{traffic}.json")
                           .read_text()), seed)
    t.ops(7)
    txns = t.txns[:8 * t.window]
    digest = hashlib.sha256(json.dumps(txns, default=int).encode())
    assert digest.hexdigest() == PINNED[(config, traffic, seed)]


class Drawn:
    """A key model that draws the transactions it is given, in turn."""

    def __init__(self, draws):
        self.draws = iter(draws)

    def draw(self):
        return next(self.draws)


def drawn(monkeypatch, *draws):
    monkeypatch.setattr(generate, "load_key_model",
                        lambda name: lambda c, r, s: Drawn(draws))
    t = Traffic(dict(YCSB, span=[0, 100]), mix(window=len(draws)), 1)
    t.ops(0)
    return t.txns


def test_range_transactions_are_checked(monkeypatch):
    txns = drawn(monkeypatch, (READ, RANGE_DOMAIN, ((0, 5), (6, 100)), ()),
                 (WRITE, KEY_DOMAIN, (3,), (3,)))
    assert [(k, d, p) for k, d, _h, _n, p, _w in txns] == [
        (READ, RANGE_DOMAIN, ((0, 5), (6, 100))),
        (WRITE, KEY_DOMAIN, (3,))]
    for bad in [(WRITE, RANGE_DOMAIN, ((0, 5),), ()),      # a range WRITE
                (READ, RANGE_DOMAIN, ((0, 5),), (3,)),     # writes
                (4, RANGE_DOMAIN, ((0, 5),), ()),          # a sync point
                (4, KEY_DOMAIN, (3,), ()),
                (READ, RANGE_DOMAIN, ((0, 5), (5, 9)), ()),  # adjacent
                (READ, RANGE_DOMAIN, ((6, 9), (0, 5)), ()),  # unsorted
                (READ, RANGE_DOMAIN, ((4, 4),), ()),       # empty
                (READ, RANGE_DOMAIN, ((90, 101),), ()),    # past the span
                (READ, RANGE_DOMAIN, (), ()),
                (READ, 2, (3,), ())]:
        with pytest.raises(ValueError):
            drawn(monkeypatch, bad)


def test_key_models_are_found_by_file():
    assert generate.load_key_model("ycsb").__module__ \
        == "accord_bench.key_models.ycsb"
    with pytest.raises(ValueError, match="no key model"):
        generate.load_key_model("no-such-model")
