"""Seeded worlds: a conflict index plus a window of new transactions.

``build_world`` and ``scalar_edges_per_sec`` are copies of the JAX package's
``bench.py`` functions, and ``random_world`` of ``tests/test_ops.py``'s, over
the port's own primitives.  The same seed draws the same stream from the same
RandomSource, so both packages build the same world: 1024 keys, a 65,536-txn
conflict index over Zipf(0.99) keys, and a 512-txn window by default (the
shape of the reference's hot loop, CommandsForKey.mapReduceActive, reference
accord/local/CommandsForKey.java:614-650, invoked per key per PreAccept).
``random_world`` is the small randomized world the equivalence checks use:
every kind and status, slow-path executeAts and per-key deps, so the
missing[] and elision paths are exercised.  ``recovery_world`` mixes such a
world's new transactions with ids it already knows into a window of
recovery probes.  ``keyset_cases`` are the key-set windows on which a sparse
key-to-rows formulation can go wrong, and ``succ_w_case`` the entry arrays
on which succ_w's can.  ``rangestress_inputs`` draws
``bench.py::bench_rangestress``'s intervals and queries.

The store tier is driven by plans: ``store_plan`` (a seeded random mix of
the local state machine's transitions, for the equivalence tests) and
``default_store_plan`` (the ``default`` cell's shape as a history of flush
windows).  ``StorePlanRunner`` runs a plan through ``store.execute(context,
fn)`` on a ``StoreNode``, the tests' FakeNode counterpart, and returns
every result as plain tuples.  ``PROTOCOL_BURNS`` are the burns the
protocol cells run, and ``burn_fingerprint`` reduces a finished burn of
either package to plain data, for the same-seed differentials.
``tcp_cluster_txns`` drives a three-node real-socket cluster in this process.
"""

from __future__ import annotations

import collections
import importlib
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import (Domain, Timestamp, TxnId,
                                                   TxnKind)
from accord_tpu_torch.utils.random_source import RandomSource


def build_world(n_keys=1024, n_existing=65536, n_batch=512, seed=42,
                zipf_alpha=0.99):
    """-> (list of CommandsForKey, batch of (TxnId, sorted keys))."""
    rng = RandomSource(seed)
    keys = [Key(i) for i in range(n_keys)]
    cfks = {k: CommandsForKey(k) for k in keys}
    kinds = [TxnKind.READ, TxnKind.WRITE]
    statuses = [InternalStatus.PREACCEPTED, InternalStatus.ACCEPTED,
                InternalStatus.COMMITTED, InternalStatus.STABLE,
                InternalStatus.APPLIED]

    # bounded-Zipf key picker (same scheme as the burn harness)
    weights = 1.0 / np.arange(1, n_keys + 1) ** zipf_alpha
    cdf = np.cumsum(weights / weights.sum())

    def pick_key():
        return keys[int(np.searchsorted(cdf, rng.next_float()))]

    hlc = 1000
    for _ in range(n_existing):
        hlc += 1 + rng.next_int(2)
        tid = TxnId.create(1, hlc, rng.pick(kinds), Domain.KEY,
                           rng.next_int(8))
        for k in {pick_key() for _ in range(1 + rng.next_int(3))}:
            cfks[k].update(tid, rng.pick(statuses), None)
    batch = []
    for _ in range(n_batch):
        hlc += 1 + rng.next_int(2)
        tid = TxnId.create(1, hlc, rng.pick(kinds), Domain.KEY,
                           rng.next_int(8))
        batch.append((tid, sorted({pick_key() for _ in range(1 + rng.next_int(4))})))
    return list(cfks.values()), batch


def scalar_edges_per_sec(cfks, batch):
    """The scalar host scan over the whole window: -> (edges/s, edges)."""
    by_key = {c.key: c for c in cfks}
    edges = 0

    def count(_):
        nonlocal edges
        edges += 1

    t0 = time.perf_counter()
    for tid, keyset in batch:
        for k in keyset:
            by_key[k].map_reduce_active(tid, tid.kind.witnesses(), count)
    dt = time.perf_counter() - t0
    return edges / dt, edges


RANDOM_WORLD_KINDS = [TxnKind.READ, TxnKind.WRITE, TxnKind.SYNC_POINT,
                      TxnKind.EXCLUSIVE_SYNC_POINT]


def random_world(rng: RandomSource, n_keys=12, n_existing=60, n_batch=16):
    """Randomized CFK state + a batch of new txns. Committed entries get an
    executeAt (sometimes bumped past their id, the slow-path shape) and
    random per-key deps so missing[]/elision paths are exercised."""
    statuses = list(InternalStatus)
    keys = [Key(i * 10) for i in range(n_keys)]
    cfks = {k: CommandsForKey(k) for k in keys}
    hlc = 100
    for _ in range(n_existing):
        hlc += 1 + rng.next_int(3)
        tid = TxnId.create(1, hlc, rng.pick(RANDOM_WORLD_KINDS), Domain.KEY,
                           rng.next_int(5))
        status = rng.pick(statuses)
        execute_at = None
        if status.has_info and rng.next_int(3) == 0:
            # slow path: executeAt bumped past the id
            execute_at = Timestamp(1, hlc + 5 + rng.next_int(40), 0,
                                   rng.next_int(5))
        touched = rng.sample(keys, 1 + rng.next_int(3))
        for k in touched:
            dep_ids = None
            if status.has_info:
                pool = cfks[k].all_ids()
                dep_ids = rng.sample(pool, rng.next_int(len(pool) + 1)) \
                    if pool else []
            cfks[k].update(tid, status, execute_at, dep_ids=dep_ids)
    batch = []
    for _ in range(n_batch):
        hlc += 1 + rng.next_int(3)
        tid = TxnId.create(1, hlc, rng.pick(RANDOM_WORLD_KINDS), Domain.KEY,
                           rng.next_int(5))
        touched = rng.sample(keys, 1 + rng.next_int(4))
        batch.append((tid, touched))
    return list(cfks.values()), batch


def recovery_world(n_keys=1024, n_existing=16384, n_probes=512, seed=42):
    """A window of recovery probes over a random world -> (cfks, probes
    [(TxnId, keys)]), mixed as tests/test_recovery_kernel.py mixes them:
    ``random_world``'s n_probes // 2 new transactions (unknown at most keys:
    the WITH-dep known gate), then ids the world knows, one every
    len(known) // (n_probes - n_probes // 2), each at every key that holds
    it, cut to n_probes.

    At the defaults the recovery encoder takes E = 32,896 entries and
    R = 19,313 ranks: about the largest power-of-two world whose
    entry_index * R + rank codes fit int32 (RecoveryEncoder's assert)."""
    n_batch = n_probes // 2
    cfks, batch = random_world(RandomSource(seed), n_keys=n_keys,
                               n_existing=n_existing, n_batch=n_batch)
    known = [t for c in cfks for t in c.all_ids()]
    probes = list(batch)
    for i in range(0, len(known),
                   max(1, len(known) // max(1, n_probes - n_batch))):
        t = known[i]
        keys = [c.key for c in cfks if c.get(t) is not None]
        if keys:
            probes.append((t, keys))
    return cfks, probes[:n_probes]


def rangestress_inputs(n_ranges=1_000_000, n_txns=10_000, seed=42):
    """``bench.py::bench_rangestress``'s draws (:481-485), in its order, from
    ``np.random.default_rng(seed)`` -> (starts, ends [n_ranges] int64,
    q_starts, q_ends [n_txns] int64, the 5 query indices of its host sample
    check, drawn next).  Every interval and query is non-empty and every
    bound fits int32."""
    universe = 1_000_000_000
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, universe - 1_000_000, n_ranges)
    ends = starts + rng.integers(1, 1_000_000, n_ranges)
    q_starts = rng.integers(0, universe - 2_000_000, n_txns)
    q_ends = q_starts + rng.integers(1000, 2_000_000, n_txns)
    return starts, ends, q_starts, q_ends, rng.integers(0, n_txns, 5)


def range_cases():
    """Interval stabbing inputs on which a tiled kernel can go wrong ->
    [(label, starts [N], ends [N], q_starts [Q], q_ends [Q]), int32]: N and Q
    that are no multiple of any tile, N = 1 and Q = 1, bounds at -2**31 and
    2**31-1, touching bounds (s == qe, e == qs), [0, 0) pads against
    negative queries and [0, 0) queries against intervals around 0."""
    rng = np.random.default_rng(0)
    lo, hi = -2 ** 31, 2 ** 31 - 1

    def draw(n, span):
        a = rng.integers(-span, span, n)
        b = a + rng.integers(1, span // 4 + 2, n)
        return a.astype(np.int32), np.minimum(b, hi).astype(np.int32)

    cases = []
    s, e = draw(5003, 10 ** 6)
    qs, qe = draw(2049, 10 ** 6)
    cases.append(("ragged N = 5003, Q = 2049", s, e, qs, qe))
    s, e = draw(70_001, 10 ** 7)
    qs, qe = draw(4099, 10 ** 7)
    cases.append(("ragged N = 70,001, Q = 4099", s, e, qs, qe))
    cases.append(("N = 1, Q = 1", np.array([-5], np.int32),
                  np.array([7], np.int32), np.array([6], np.int32),
                  np.array([9], np.int32)))
    s, e = draw(3000, 2 ** 30)
    s[:40], e[:40] = lo, rng.integers(lo + 1, hi, 40)
    e[40:80], s[40:80] = hi, rng.integers(lo, hi - 1, 40)
    s[80], e[80] = lo, hi
    qs, qe = draw(777, 2 ** 30)
    qs[:20], qe[:20] = lo, rng.integers(lo + 1, hi, 20)
    qe[20:40], qs[20:40] = hi, rng.integers(lo, hi - 1, 20)
    qs[40], qe[40] = lo, hi
    qs[41], qe[41] = lo, lo + 1
    qs[42], qe[42] = hi - 1, hi
    cases.append(("bounds at -2**31 and 2**31-1", s, e, qs, qe))
    s = rng.integers(0, 100, 1500).astype(np.int32)
    e = (s + rng.integers(1, 5, 1500)).astype(np.int32)
    q_at = rng.integers(0, 1500, 300)
    qs = np.where(rng.random(300) < 0.5, e[q_at], s[q_at] - 3)
    qe = np.where(qs == e[q_at], qs + 2, s[q_at])   # e == qs, or s == qe
    cases.append(("touching bounds", s, e, qs.astype(np.int32),
                  qe.astype(np.int32)))
    s, e = draw(2500, 1000)
    s[rng.random(2500) < 0.3] = 0
    e[s == 0] = 0                                   # [0, 0) pads
    qs, qe = draw(600, 1000)
    qs[:200] = rng.integers(-1000, -1, 200)         # qs < 0 < qe hits a pad
    qe[:100] = rng.integers(1, 1000, 100)
    qe[100:200] = rng.integers(-1000, 1, 100)
    qe[100:200] = np.maximum(qe[100:200], qs[100:200] + 1)
    qs[200:260], qe[200:260] = 0, 0                 # [0, 0) queries
    cases.append(("[0, 0) pads", s, e, qs.astype(np.int32),
                  qe.astype(np.int32)))
    return cases


def range_index_cases():
    """Inputs on which K5's query index can go wrong -> [(label, starts [N],
    ends [N], q_starts [Q], q_ends [Q]), int32]: every interval inverted;
    every query inverted; [0, 0) intervals against [0, 0) queries, at the
    same point and at others; one q_end shared by every query (ties in the
    sort); one interval repeated N times (one hot bin); Q = 30,001, more
    than two query tiles; a random mix of inverted, empty and extreme
    bounds; N = 0; Q = 1; N = 1."""
    rng = np.random.default_rng(8)
    lo, hi = -2 ** 31, 2 ** 31 - 1

    def draw(n, span):
        a = rng.integers(-span, span, n)
        return a, a + rng.integers(1, span // 4 + 2, n)

    def i32(*arrays):
        return tuple(np.asarray(a).astype(np.int32) for a in arrays)

    cases = []
    s, e = draw(2000, 1000)
    qs, qe = draw(700, 1000)
    cases.append(("all intervals inverted", *i32(e, s, qs, qe)))
    cases.append(("all queries inverted", *i32(s, e, qe, qs)))
    s, e = draw(1500, 50)
    zero = rng.random(1500) < 0.4
    s[zero], e[zero] = 0, 0
    point = rng.random(1500) < 0.1
    s[point] = e[point] = rng.integers(-50, 50, int(point.sum()))
    qs, qe = draw(400, 50)
    qs[:100], qe[:100] = 0, 0                        # at the pads' point
    qs[100:200] = qe[100:200] = rng.integers(-50, 50, 100)
    cases.append(("[0, 0) intervals and [0, 0) queries", *i32(s, e, qs, qe)))
    s, e = draw(3000, 10 ** 5)
    qs = rng.integers(-10 ** 5, 500, 900)
    cases.append(("one q_end for every query",
                  *i32(s, e, qs, np.full(900, 500))))
    qs, qe = draw(800, 10 ** 5)
    cases.append(("one interval repeated (one hot bin)",
                  *i32(np.full(4000, -7), np.full(4000, 300), qs, qe)))
    s, e = draw(3000, 10 ** 6)
    qs, qe = draw(30_001, 10 ** 6)
    cases.append(("Q = 30,001: three query tiles", *i32(s, e, qs, qe)))
    s, e = rng.integers(-40, 40, (2, 2500))
    qs, qe = rng.integers(-40, 40, (2, 1100))
    s[:30], e[30:60], qs[:30], qe[30:60] = lo, hi, hi, lo
    cases.append(("random mix of inverted, empty and extreme bounds",
                  *i32(s, e, qs, qe)))
    qs, qe = draw(50, 100)
    cases.append(("N = 0", *i32([], [], qs, qe)))
    s, e = draw(5000, 100)
    cases.append(("Q = 1", *i32(s, e, [-3], [20])))
    cases.append(("N = 1", *i32([4], [9], *draw(300, 12))))
    return cases


def _keyset_window(rng, b, p, domain, pad=0.2):
    """-> (txn_keys [1, b, p] int32: keys from `domain` values, unsorted and
    repeated, negative pads anywhere; txn_rank [1, b] int32: a permutation)."""
    tk = np.where(rng.random((1, b, p)) < 1 - pad,
                  rng.integers(0, domain, (1, b, p)),
                  rng.integers(-3, 0, (1, b, p)))
    return tk.astype(np.int32), rng.permutation(b).astype(np.int32)[None]


def large_keyset_window(b, p, seed=0):
    """One key-set window above K4's shared-memory range -> (label,
    txn_keys [1, B, P] int32, txn_rank [1, B] int32): keys from 3000
    values, unsorted and repeated, with pads anywhere; permuted ranks with
    5% padded rows."""
    rng = np.random.default_rng(seed + b * 100 + p)
    tk, tr = _keyset_window(rng, b, p, 3000)
    tr[0, rng.random(b) < 0.05] = -1
    return f"B = {b}, P = {p}", tk, tr


def keyset_cases(seed=0, full_slots=False):
    """Key-set windows -> [(label, txn_keys [1, B, P] int32, txn_rank [1, B]
    int32)]: tied ranks; keys at 0 and 2**31-1 with pads anywhere; a window
    whose rows are all padded; one key held by every row (B = 64); P = 1;
    P = 5.  With `full_slots`, also B = 2048 at P = 11 and B = 1408 at
    P = 16, 22,528 key slots each (the most K4's shared-memory kernel
    takes), and B = 4096 at P = 11 (45,056 slots) and B = 1200 at P = 20
    (24,000 slots), which take its large-window kernel."""
    rng = np.random.default_rng(seed)
    cases = []
    tk, _ = _keyset_window(rng, 96, 11, 40)
    tr = rng.integers(0, 24, (1, 96)).astype(np.int32)
    tr[rng.random((1, 96)) < 0.1] = -1
    cases.append(("tied ranks", tk, tr))
    tk, tr = _keyset_window(rng, 128, 11, 30)
    tk = np.where(tk == 1, 2 ** 31 - 1, tk).astype(np.int32)
    tk[0, rng.random((128, 11)) < 0.05] = 2 ** 31 - 1
    tr[0, rng.random(128) < 0.1] = -1
    cases.append(("keys 0 and 2**31-1", tk, tr))
    tk, _ = _keyset_window(rng, 64, 11, 20)
    cases.append(("all rows padded", tk, np.full((1, 64), -1, np.int32)))
    tk, tr = _keyset_window(rng, 64, 11, 200)
    tk[0, np.arange(64), rng.integers(0, 11, 64)] = 77
    cases.append(("one key in every row", tk, tr))
    tk, tr = _keyset_window(rng, 200, 1, 30)
    tr[0, rng.random(200) < 0.1] = -1
    cases.append(("P = 1", tk, tr))
    tk, _ = _keyset_window(rng, 130, 5, 100)
    tr = rng.integers(-1, 60, (1, 130)).astype(np.int32)
    cases.append(("P = 5", tk, tr))
    if full_slots:
        for b, p, domain in ((2048, 11, 3000), (1408, 16, 3000)):
            tk, tr = _keyset_window(rng, b, p, domain)
            tr[0, rng.random(b) < 0.05] = -1
            cases.append((f"B = {b}, P = {p}", tk, tr))
        cases += [large_keyset_window(4096, 11), large_keyset_window(1200, 20)]
    return cases


SUCC_W_CASES = ("one hot key", "all writes", "no writes", "equal eats",
                "single entry", "pads alone", "encoder layout")
_STATUS_PAD = int(InternalStatus.INVALID_OR_TRUNCATED)


def succ_w_case(name: str, e: int = 512, n_shards: int = 0, seed: int = 0):
    """One window on which succ_w can go wrong -> (the five entry arrays
    (entry_rank, entry_eat_rank, entry_key, entry_status, entry_kind), int32
    [E], or [S, E] with keys local to each shard when `n_shards` is S, and
    the keys of one shard's block).  Eats are drawn with ties; every status
    and kind (TxnKind 1..6, writes 2 and 5) appears unless the case says
    otherwise.

    one hot key: every entry on key 0 of 4.  all writes: every entry a
    committed write.  no writes: none is (each fails one of the filter's
    three clauses: status, rank, kind).  equal eats: one key of three, eats
    in 0..3, a write before and after most entries of the same eat.  single
    entry: E = 1, a committed write.  pads alone: the encoder's pads (key 0,
    eat -1, rank -1, status INACTIVE).  encoder layout: keys in blocks in
    a shuffled key order, as ``BatchEncoder`` lays out its CommandsForKey,
    then a tail of pads on key 0."""
    rng = np.random.default_rng([seed, SUCC_W_CASES.index(name)])
    if name == "single entry":
        e = 1
    rows = [_succ_w_row(rng, name, e) for _ in range(max(1, n_shards))]
    arrays = tuple(np.stack([r[i] for r, _ in rows]) if n_shards
                   else rows[0][0][i] for i in range(5))
    return tuple(a.astype(np.int32) for a in arrays), rows[0][1]


def _succ_w_row(rng, name: str, e: int):
    n_keys = {"one hot key": 4, "equal eats": 3, "single entry": 1,
              "pads alone": 1}.get(name, 16)
    key = rng.integers(0, n_keys, e)
    eat = rng.integers(-1, max(2, e // 8), e)
    rank = rng.integers(-1, max(2, e), e)
    status = rng.integers(0, 8, e)
    kind = rng.integers(1, 7, e)
    if name == "one hot key":
        key[:] = 0
    elif name in ("all writes", "single entry"):
        rank = np.abs(rank)
        status = rng.integers(4, 7, e)
        kind = rng.choice([2, 5], e)
    elif name == "no writes":
        # each entry fails one clause of the filter and passes the others
        clause = rng.integers(0, 3, e)
        status = np.where(clause == 0, rng.choice([0, 1, 2, 3, 7], e),
                          rng.integers(4, 7, e))
        rank = np.where(clause == 1, -1, np.abs(rank))
        kind = np.where(clause == 2, rng.choice([1, 3, 4, 6], e),
                        rng.choice([2, 5], e))
    elif name == "equal eats":
        key[:] = 1
        eat = rng.integers(0, 4, e)
        status = np.where(rng.random(e) < 0.5, rng.integers(4, 7, e), 2)
        rank = np.abs(rank)
        kind = rng.choice([1, 2, 5], e)
    elif name == "pads alone":
        key, eat, rank = np.zeros(e), np.full(e, -1), np.full(e, -1)
        status, kind = np.full(e, _STATUS_PAD), np.zeros(e)
    elif name == "encoder layout":
        pads = e // 8
        sizes = rng.multinomial(e - pads, np.ones(n_keys) / n_keys)
        key = np.concatenate([np.repeat(rng.permutation(n_keys), sizes),
                              np.zeros(pads)])
        eat[e - pads:], rank[e - pads:] = -1, -1
        status[e - pads:], kind[e - pads:] = _STATUS_PAD, 0
    return (rank, eat, key, status, kind), n_keys


# -------------------------------------------------------------- store tier --

STORE_KIT_MODULES = ("api.spi", "impl.list_store", "local.commands",
                     "local.status", "local.store", "primitives.deps",
                     "primitives.keys", "primitives.timestamp",
                     "primitives.txn")


def store_kit(modules=None) -> SimpleNamespace:
    """The classes ``StoreNode`` and ``StorePlanRunner`` build from.  By
    default the port's; `modules`, a {name: module} map over
    STORE_KIT_MODULES, gives another package's modules of the same names
    (the equivalence tests pass the JAX package's, so one plan drives each
    store through its own package's classes)."""
    if modules is None:
        modules = {n: importlib.import_module("accord_tpu_torch." + n)
                   for n in STORE_KIT_MODULES}
    spi, ls, cmds, status, store, deps, keys, ts, txn = (
        modules[n] for n in STORE_KIT_MODULES)
    return SimpleNamespace(
        Agent=spi.Agent, EventsListener=spi.EventsListener,
        ProgressLog=spi.ProgressLog, ListStore=ls.ListStore,
        ListRead=ls.ListRead, ListRangeRead=ls.ListRangeRead,
        ListQuery=ls.ListQuery, ListUpdate=ls.ListUpdate, C=cmds,
        SaveStatus=status.SaveStatus, KnownDeps=status.KnownDeps,
        PreLoadContext=store.PreLoadContext, Deps=deps.Deps, Key=keys.Key,
        Keys=keys.Keys, Range=keys.Range, Ranges=keys.Ranges,
        Route=keys.Route, RoutingKey=keys.RoutingKey, Ballot=ts.Ballot,
        Domain=ts.Domain, Timestamp=ts.Timestamp, TxnId=ts.TxnId,
        TxnKind=ts.TxnKind, Txn=txn.Txn)


class QueueScheduler:
    """A scheduler whose `now` and `once` queue their callbacks until
    `drain` runs them in order: every operation a DeviceCommandStore is
    handed between two drains falls into one flush window."""

    def __init__(self):
        self._queue = collections.deque()

    def now(self, fn) -> None:
        self._queue.append(fn)

    def once(self, delay_s: float, fn) -> None:
        self._queue.append(fn)

    def drain(self) -> None:
        while self._queue:
            self._queue.popleft()()


class StoreNode:
    """Just enough of a Node for the store tier (the counterpart of
    tests/test_local_statemachine.py::FakeNode): an HLC, an agent that
    raises on uncaught exceptions and records handled ones, a ListStore, a
    null progress log and events listener, ``infer_stats`` and a
    ``QueueScheduler``.  `kit` picks the package its parts come from."""

    def __init__(self, kit: SimpleNamespace = None):
        kit = kit if kit is not None else store_kit()

        class _Agent(kit.Agent):
            def __init__(self):
                self.failures = []

            def on_uncaught_exception(self, failure):
                self.failures.append(failure)
                raise failure

            def on_handled_exception(self, failure):
                self.failures.append(failure)

            def empty_txn(self, kind, keys_or_ranges):
                return kit.Txn(kind, keys_or_ranges)

        class _NullProgressLog(kit.ProgressLog):
            pass

        self.id = 1
        self.epoch = 1
        self.kit = kit
        self.agent = _Agent()
        self.data_store = kit.ListStore(self.id)
        self.events = kit.EventsListener()
        self.scheduler = QueueScheduler()
        self.infer_stats = collections.defaultdict(int)
        self._progress_log = _NullProgressLog()
        self._hlc = 0

    def progress_log_for(self, store):
        return self._progress_log

    def now_us(self) -> int:
        return self._hlc

    def unique_now(self):
        self._hlc += 1
        return self.kit.Timestamp(self.epoch, self._hlc, 0, self.id)

    def unique_now_at_least(self, at_least):
        self._hlc = max(self._hlc, at_least.hlc) + 1
        return self.kit.Timestamp(max(self.epoch, at_least.epoch), self._hlc,
                                  0, self.id)


# a plan's transaction: (kind, domain, hlc, node, participants), where the
# participants are key tokens (key domain) or (start, end) pairs (range
# domain); an op is (name, txn index) or ("recover", txn index, ballot hlc)
STORE_MIX = (("preaccept", 0.50), ("accept", 0.10), ("commit", 0.15),
             ("apply", 0.15), ("recover", 0.05), ("range", 0.05))
STORE_ZIPF_ALPHA = 0.99
# store_plan: the share of accepts, commits and applies that re-deliver
REPLAYS = 0.05
# default_store_plan: the cell's keys; batches undecided; one txn in
# ACCEPT_EVERY accepted a window after its preaccept
DEFAULT_STORE_KEYS = 1024
DEFAULT_STORE_WINDOW = 512
DEFAULT_STORE_LAG = 2
ACCEPT_EVERY = 8
# default_store_windows: range txns registered; one op in RANGE_SHARE of
# the range window is range-domain
RANGE_TXNS = 1024
RANGE_SHARE = 8
_RANGE_KINDS = (int(TxnKind.READ), int(TxnKind.WRITE),
                int(TxnKind.EXCLUSIVE_SYNC_POINT))


def _zipf_cdf(n_keys: int, alpha: float) -> np.ndarray:
    weights = 1.0 / np.arange(1, n_keys + 1) ** alpha
    return np.cumsum(weights / weights.sum())


def _pick_tokens(r, cdf, n_max: int, scale: int = 1) -> Tuple[int, ...]:
    picks = np.searchsorted(cdf, r.random(1 + int(r.integers(n_max))))
    return tuple(sorted({scale * min(int(p), len(cdf) - 1) for p in picks}))


def store_plan(seed: int, n_keys: int = 32, n_txns: int = 360,
               window=(1, 64), mix=STORE_MIX):
    """A seeded plan of plain data -> (txns, windows).

    Each window draws 1..64 ops from `mix`: preaccepts of new key-domain
    txns (READ or WRITE over 1-3 of `n_keys` Zipf keys, tokens 10 apart),
    accepts, stable commits and applies of txns preaccepted in an EARLIER
    window (the protocol's messages carry an executeAt their sender knows),
    recovery probes (at increasing ballots) of any earlier txn, and
    preaccepts of new range-domain txns over one or two spans.  A share
    REPLAYS of accepts, commits and applies re-deliver to a txn already
    past that phase (the REDUNDANT paths).  An op whose kind has no
    eligible txn becomes a preaccept.  Ends when `n_txns` txns exist."""
    r = np.random.default_rng(seed)
    cdf = _zipf_cdf(n_keys, STORE_ZIPF_ALPHA)
    names = [n for n, _ in mix]
    probs = np.asarray([p for _, p in mix], float)
    probs /= probs.sum()
    txns: List[tuple] = []
    windows: List[List[tuple]] = []
    state: Dict[int, str] = {}        # txn -> last phase: pa, acc, com, app
    since: Dict[int, int] = {}        # txn -> window it entered that phase
    hlc = 1000
    ballot = 0
    order = {"pa": 0, "acc": 1, "com": 2, "app": 3}
    needs = {"accept": ("pa",), "commit": ("pa", "acc"),
             "apply": ("pa", "acc", "com")}

    def new_txn(w: int, ranged: bool) -> int:
        nonlocal hlc
        hlc += 1 + int(r.integers(3))
        if ranged:
            spans = []
            for _ in range(1 + int(r.integers(2))):
                s = 10 * int(r.integers(n_keys))
                spans.append((s, s + 10 * (1 + int(r.integers(6))) - 5))
            spans = tuple(sorted(set(spans)))
            spec = (_RANGE_KINDS[int(r.integers(3))], int(Domain.RANGE), hlc,
                    int(r.integers(8)), spans)
        else:
            kind = int(TxnKind.WRITE) if r.random() < 0.7 \
                else int(TxnKind.READ)
            spec = (kind, int(Domain.KEY), hlc, int(r.integers(8)),
                    _pick_tokens(r, cdf, 3, 10))
        txns.append(spec)
        i = len(txns) - 1
        state[i], since[i] = "pa", w
        return i

    while len(txns) < n_txns:
        w = len(windows)
        ops = []
        for _ in range(int(r.integers(window[0], window[1] + 1))):
            if len(txns) >= n_txns:
                break
            name = names[int(r.choice(len(names), p=probs))]
            if name in needs:
                ready = [i for i, s in state.items()
                         if s in needs[name] and since[i] < w]
                if r.random() < REPLAYS:
                    ready = [i for i, s in state.items() if since[i] < w
                             and s not in needs[name]] or ready
                if ready:
                    i = ready[int(r.integers(len(ready)))]
                    ops.append((name, i))
                    phase = {"accept": "acc", "commit": "com",
                             "apply": "app"}[name]
                    if order[phase] > order[state[i]]:
                        state[i], since[i] = phase, w
                    continue
            elif name == "recover":
                ready = [i for i in state if since[i] < w]
                if ready:
                    ballot += 1
                    ops.append(("recover", ready[int(r.integers(len(ready)))],
                                ballot))
                    continue
            ops.append(("preaccept", new_txn(w, name == "range")))
        windows.append(ops)
    return txns, windows


def default_store_plan(n_history: int = 65536, seed: int = 42):
    """The ``default`` cell's shape as a store history -> (txns, windows).

    Its txns are ``build_world``'s: READ or WRITE over 1-3 of 1024
    Zipf(0.99) keys, hlc 1 or 2 apart, node 0-7.  Window w preaccepts the
    w-th batch of DEFAULT_STORE_WINDOW (512) new txns, accepts every ACCEPT_EVERY-th txn of
    batch w-1 and commits (stable) and applies batch w-DEFAULT_STORE_LAG,
    so the index holds that many batches undecided and the rest applied;
    the last of them stay preaccepted."""
    r = np.random.default_rng(seed)
    cdf = _zipf_cdf(DEFAULT_STORE_KEYS, STORE_ZIPF_ALPHA)
    lag, window = DEFAULT_STORE_LAG, DEFAULT_STORE_WINDOW
    txns: List[tuple] = []
    windows: List[List[tuple]] = []
    hlc = 1000
    for w in range(n_history // window):
        ops = []
        for _ in range(window):
            hlc += 1 + int(r.integers(2))
            kind = int(TxnKind.WRITE) if r.random() < 0.5 \
                else int(TxnKind.READ)
            txns.append((kind, int(Domain.KEY), hlc, int(r.integers(8)),
                         _pick_tokens(r, cdf, 3)))
            ops.append(("preaccept", len(txns) - 1))
        if w >= 1:
            ops += [("accept", i) for i in range((w - 1) * window,
                                                 w * window, ACCEPT_EVERY)]
        if w >= lag:
            batch = range((w - lag) * window, (w - lag + 1) * window)
            ops += [("commit", i) for i in batch]
            ops += [("apply", i) for i in batch]
        windows.append(ops)
    return txns, windows


def default_store_windows(plan, seed: int = 43):
    """The measured windows after ``default_store_plan``'s history, each of
    DEFAULT_STORE_WINDOW ops unless said -> {name: ops}; their new txns are
    appended to the plan's.

    * ``preaccept``: a batch of new txns drawn as the history's are;
    * ``recovery``: a recovery probe of each of them, ballots 1..512
      (undecided txns: the four predicates and the local deps run);
    * ``commit``: stable commits of every undecided batch (the history's
      last DEFAULT_STORE_LAG and ``preaccept``'s), and ``apply``: their
      applies, one flush window of (DEFAULT_STORE_LAG + 1) * 512 Applies;
    * ``range_register``: RANGE_TXNS range-domain preaccepts (READ,
      WRITE or EXCLUSIVE_SYNC_POINT over one span of 1-16 tokens), and
      ``range``: new key-domain preaccepts with every RANGE_SHARE-th op a
      range-domain one."""
    txns, history = plan
    r = np.random.default_rng(seed)
    n_keys, window = DEFAULT_STORE_KEYS, DEFAULT_STORE_WINDOW
    cdf = _zipf_cdf(n_keys, STORE_ZIPF_ALPHA)
    hlc = txns[-1][2]

    def new_txn(ranged: bool) -> int:
        nonlocal hlc
        hlc += 1 + int(r.integers(2))
        if ranged:
            s = int(r.integers(n_keys))
            parts = ((s, s + 1 + int(r.integers(16))),)
            kind = _RANGE_KINDS[int(r.integers(3))]
            txns.append((kind, int(Domain.RANGE), hlc, int(r.integers(8)),
                         parts))
        else:
            kind = int(TxnKind.WRITE) if r.random() < 0.5 \
                else int(TxnKind.READ)
            txns.append((kind, int(Domain.KEY), hlc, int(r.integers(8)),
                         _pick_tokens(r, cdf, 3)))
        return len(txns) - 1

    undecided = list(range(len(txns) - DEFAULT_STORE_LAG * window,
                           len(txns)))
    batch = [new_txn(False) for _ in range(window)]
    undecided += batch
    return {
        "preaccept": [("preaccept", i) for i in batch],
        "recovery": [("recover", i, b + 1) for b, i in enumerate(batch)],
        "commit": [("commit", i) for i in undecided],
        "apply": [("apply", i) for i in undecided],
        "range_register": [("preaccept", new_txn(True))
                           for _ in range(RANGE_TXNS)],
        "range": [("preaccept", new_txn(j % RANGE_SHARE == RANGE_SHARE - 1))
                  for j in range(window)],
    }


def first_touch_preaccepts(plan, ops) -> int:
    """The key-domain preaccepts of a window of preaccepts (`ops`, one
    flush) none of whose keys an earlier op of the window touched.  These
    are the deps scans the store's version gate serves: each preaccept bumps
    its keys' versions, and a scan is served only when its own
    registration is the sole mutation of each key since the window's
    snapshot; every other scan misses with cause ``version``."""
    seen: set = set()
    n = 0
    for op in ops:
        tokens = set(plan[0][op[1]][4])
        n += not tokens & seen
        seen |= tokens
    return n


def ts_tuple(t) -> Optional[tuple]:
    """A Timestamp (any package's) as plain (epoch, hlc, flags, node)."""
    return None if t is None else (t.epoch, t.hlc, t.flags, t.node)


def deps_tuple(deps) -> Optional[tuple]:
    """Deps as plain data: (sorted (token, id) key deps, sorted (start, end,
    id) range deps)."""
    if deps is None:
        return None
    kd, rd = deps.key_deps, deps.range_deps
    keyed = sorted((k.token, ts_tuple(t)) for k in kd.keys
                   for t in kd.txn_ids_for_key(k))
    ranged = sorted((rng.start, rng.end, ts_tuple(t))
                    for i, rng in enumerate(rd.ranges)
                    for t in rd.txn_ids_for_range_idx(i))
    return tuple(keyed), tuple(ranged)


DEVICE_COUNTERS = (
    "device_hits", "device_misses", "device_batches",
    "device_batched_probes", "device_max_batch", "device_flush_windows",
    "device_cross_txn_windows", "device_window_txn_max",
    "device_recovery_hits", "device_recovery_misses", "device_wave_batches",
    "device_wave_planned", "device_wave_executed", "device_wave_max_depth",
    "device_range_hits", "device_range_misses", "device_range_batches",
    "device_range_candidates", "device_compile_shapes")
MISS_CAUSES = ("no_probe", "version", "key_cover")


def device_counters(store) -> Dict[str, int]:
    """Every device_* counter of a DeviceCommandStore, miss causes
    included, as plain ints."""
    out = {n: int(getattr(store, n)) for n in DEVICE_COUNTERS}
    out.update({"miss_" + c: int(store.device_miss_causes[c])
                for c in MISS_CAUSES})
    return out


def store_state(store) -> dict:
    """A command store's state as plain data: every command's save status
    and executeAt, every CFK's ``as_arrays()`` and the data store."""
    def cfk_arrays(cfk):
        ids, statuses, eats, missing = cfk.as_arrays()
        return (tuple(map(ts_tuple, ids)), tuple(int(s) for s in statuses),
                tuple(map(ts_tuple, eats)),
                tuple(tuple(map(ts_tuple, m)) for m in missing))

    return {
        "commands": tuple(sorted(
            (ts_tuple(t), c.save_status.name, ts_tuple(c.execute_at))
            for t, c in store.commands.items())),
        "cfks": tuple((k.token, cfk_arrays(c)) for k, c in
                      sorted(store.cfks.items(), key=lambda kv: kv[0].token)),
        "data": tuple(sorted(store.data_store.snapshot().items())),
    }


# The protocol cells: the reference's flagship device burn (the closing
# flagship of SOAK_NOTES.md:217-224) and the soak's mesh arm
# (mesh-loss12-part-drift, soak.py:43-44), as arguments of ``sim.burn``'s
# CLI, each with the summary line the JAX package's burn prints for them (on
# the CPU; the simulation runs on virtual time, so any backend prints it)
PROTOCOL_BURNS = {
    "flagship": (
        "-s 1 -o 1000 --device-store --device-verify --drop 0.1 "
        "--partitions --drift --stores 4",
        "seed=1 ops=1000 acks=368 nacks=632 shed=0 lost=0 pending=0 "
        "lat_p50=3019.3ms lat_p95=18722.4ms virtual_time=1804.2s "
        "events=323301 OK device[hits=6273 misses=7 batches=14742 "
        "probes=14829 max_batch=2 cross_txn_windows=3557 recovery_hits=5764 "
        "recovery_misses=636 wave_batches=6 wave_planned=12 wave_executed=10 "
        "wave_depth=2 range_hits=6262 range_misses=12] infer[evidence=75 "
        "quorum_evidence=23 inferred_rounds=0 no_round=0 fence_refusals=0 "
        "safe_to_clean=0] audit[rounds=45 agree=31]"),
    "mesh": (
        "-s 54400 -o 100 --device-verify --mesh-store --drop 0.12 "
        "--partitions --drift --stores 4",
        "seed=54400 ops=100 acks=20 nacks=80 shed=0 lost=0 pending=0 "
        "lat_p50=1072.8ms lat_p95=10995.1ms virtual_time=850.8s "
        "events=124384 OK device[hits=3515 misses=1 batches=2980 probes=2995 "
        "max_batch=2 cross_txn_windows=583 recovery_hits=3640 "
        "recovery_misses=78 wave_batches=1 wave_planned=2 wave_executed=2 "
        "wave_depth=1 range_hits=3385 range_misses=12] infer[evidence=37 "
        "quorum_evidence=11 inferred_rounds=0 no_round=0 fence_refusals=0 "
        "safe_to_clean=1] audit[rounds=15 agree=8]"),
    # the delayed-executor nemesis over the flat and the mesh store
    # (SOAK_NOTES.md:201 and :203, at the soak's 60 ops a seed), a
    # crash-restart whose WAL replay resolves a 45-probe window and a
    # 16-deep wave plan (tests/test_wal.py:248's burn on device stores),
    # and the geo profile with a narrowed electorate and DC partitions
    # (README.md:853's arm)
    "delayed": (
        "-s 53000 -o 60 --device-store --device-verify --delayed-stores "
        "--drop 0.15 --partitions --stores 4",
        "seed=53000 ops=60 acks=8 nacks=52 shed=0 lost=0 pending=0 "
        "lat_p50=122.3ms lat_p95=16428.6ms virtual_time=912.4s events=95629 "
        "OK device[hits=1184 misses=0 batches=1358 probes=1362 max_batch=2 "
        "cross_txn_windows=130 recovery_hits=1480 recovery_misses=45 "
        "wave_batches=0 wave_planned=0 wave_executed=0 wave_depth=0 "
        "range_hits=1043 range_misses=10] infer[evidence=25 quorum_evidence=4"
        " inferred_rounds=0 no_round=0 fence_refusals=0 safe_to_clean=0] "
        "audit[rounds=21 agree=12]"),
    "delayed_mesh": (
        "-s 55000 -o 60 --device-verify --mesh-store --delayed-stores --drop "
        "0.15 --keys 6 --range-heavy",
        "seed=55000 ops=60 acks=26 nacks=34 shed=0 lost=0 pending=0 "
        "lat_p50=4357.8ms lat_p95=9116.7ms virtual_time=910.1s events=61837 "
        "OK device[hits=1840 misses=0 batches=1282 probes=1283 max_batch=2 "
        "cross_txn_windows=155 recovery_hits=1968 recovery_misses=24 "
        "wave_batches=0 wave_planned=0 wave_executed=0 wave_depth=0 "
        "range_hits=1831 range_misses=3] infer[evidence=16 quorum_evidence=6 "
        "inferred_rounds=0 no_round=0 fence_refusals=0 safe_to_clean=0] "
        "audit[rounds=18 agree=7]"),
    "restart": (
        "-s 23 -o 90 --device-store --device-verify --drop 0.05 --restart 1",
        "seed=23 ops=90 acks=63 nacks=27 shed=0 lost=0 pending=0 restarts=1 "
        "lat_p50=570.5ms lat_p95=5682.3ms virtual_time=740.7s events=28555 OK"
        " device[hits=764 misses=72 batches=623 probes=684 max_batch=45 "
        "cross_txn_windows=120 recovery_hits=324 recovery_misses=87 "
        "wave_batches=1 wave_planned=34 wave_executed=34 wave_depth=16 "
        "range_hits=730 range_misses=67] infer[evidence=3 quorum_evidence=2 "
        "inferred_rounds=0 no_round=0 fence_refusals=0 safe_to_clean=0] "
        "audit[rounds=12 agree=11]"),
    "geo": (
        "-s 29 -o 60 --geo --electorate 1,2,3,5 --dc-partitions "
        "--device-store --device-verify",
        "seed=29 ops=60 acks=55 nacks=5 shed=0 lost=0 pending=0 "
        "lat_p50=201.1ms lat_p95=816.3ms virtual_time=72.6s events=17995 OK "
        "device[hits=1033 misses=23 batches=1440 probes=1780 max_batch=11 "
        "cross_txn_windows=770 recovery_hits=52 recovery_misses=18 "
        "wave_batches=10 wave_planned=20 wave_executed=14 wave_depth=2 "
        "range_hits=989 range_misses=8] infer[evidence=116 quorum_evidence=0 "
        "inferred_rounds=0 no_round=0 fence_refusals=55 safe_to_clean=0] "
        "audit[rounds=28 agree=28] dc_partitions[4]"),
}

# ``bench.slo_zipf1m_run`` (1,000,000 keys, 4,000 ops, Poisson at 300/s,
# seed 17, 50 resident commands a store, 25 s to settle) with every store a
# DeviceCommandStore (300 µs windows, verify on), as
# ``open_loop_fingerprint`` reduces it after the lane: the JAX package's
# lane (bench.py::bench_slo_zipf1m) on the CPU with the JAX
# DeviceCommandStore, same windows, gave these
ZIPF1M_DEVICE_FINGERPRINT = {
    "counts": {"acked": 4000, "shed": 0, "failed": 0, "pending": 0},
    "open_loop_us": {"count": 4000,
                     "mean_us": 57750.8,
                     "max_us": 190225,
                     "p50_us": 53278,
                     "p99_us": 137358,
                     "p999_us": 170516},
    "paging": {"cap": 50,
               "working_set": 4000,
               "resident_high_water": 51,
               "resident": 47,
               "spilled": 3966,
               "hit_rate": 0.9021,
               "evictions": 11998,
               "refaults": 102,
               "refault_probe": 96,
               "cfk_evictions": 13665,
               "cfk_restores": 0,
               "spill_disk_bytes": 5890274,
               "spill_compactions": 0,
               "lost_acks": 0,
               "leak_alarms": 0,
               "audit_agree": True},
    "nodes": {
        1: {
            "paging": {"hits": 37397,
                       "misses": 4049,
                       "evictions": 4002,
                       "refaults": 37,
                       "resident": 47,
                       "resident_high_water": 77,
                       "spilled": 3965,
                       "cfk_evictions": 4555,
                       "cfk_restores": 0,
                       "spill_disk_bytes": 5871591,
                       "spill_compactions": 0},
            "device": {"device_disabled": 0,
                       "device_hits": 4186,
                       "device_misses": 37,
                       "device_batches": 3385,
                       "device_batched_probes": 4223,
                       "device_max_batch": 5,
                       "device_flush_windows": 11805,
                       "device_cross_txn_windows": 3854,
                       "device_window_txn_max": 6,
                       "device_recovery_hits": 0,
                       "device_recovery_misses": 0,
                       "device_wave_batches": 297,
                       "device_wave_planned": 607,
                       "device_wave_executed": 589,
                       "device_wave_max_depth": 2,
                       "device_range_hits": 998,
                       "device_range_misses": 1,
                       "device_range_batches": 827,
                       "device_range_candidates": 249,
                       "device_compile_shapes": 14,
                       "miss_no_probe": 0,
                       "miss_version": 37,
                       "miss_key_cover": 0},
        },
        2: {
            "paging": {"hits": 37207,
                       "misses": 4045,
                       "evictions": 3999,
                       "refaults": 33,
                       "resident": 46,
                       "resident_high_water": 81,
                       "spilled": 3966,
                       "cfk_evictions": 4555,
                       "cfk_restores": 0,
                       "spill_disk_bytes": 5890274,
                       "spill_compactions": 0},
            "device": {"device_disabled": 0,
                       "device_hits": 4180,
                       "device_misses": 43,
                       "device_batches": 3375,
                       "device_batched_probes": 4223,
                       "device_max_batch": 4,
                       "device_flush_windows": 11868,
                       "device_cross_txn_windows": 3822,
                       "device_window_txn_max": 5,
                       "device_recovery_hits": 0,
                       "device_recovery_misses": 0,
                       "device_wave_batches": 277,
                       "device_wave_planned": 563,
                       "device_wave_executed": 548,
                       "device_wave_max_depth": 2,
                       "device_range_hits": 996,
                       "device_range_misses": 1,
                       "device_range_batches": 816,
                       "device_range_candidates": 252,
                       "device_compile_shapes": 15,
                       "miss_no_probe": 0,
                       "miss_version": 43,
                       "miss_key_cover": 0},
        },
        3: {
            "paging": {"hits": 37232,
                       "misses": 4044,
                       "evictions": 3997,
                       "refaults": 32,
                       "resident": 47,
                       "resident_high_water": 79,
                       "spilled": 3965,
                       "cfk_evictions": 4555,
                       "cfk_restores": 0,
                       "spill_disk_bytes": 5887972,
                       "spill_compactions": 0},
            "device": {"device_disabled": 0,
                       "device_hits": 4177,
                       "device_misses": 46,
                       "device_batches": 3384,
                       "device_batched_probes": 4223,
                       "device_max_batch": 4,
                       "device_flush_windows": 11767,
                       "device_cross_txn_windows": 3920,
                       "device_window_txn_max": 5,
                       "device_recovery_hits": 0,
                       "device_recovery_misses": 0,
                       "device_wave_batches": 272,
                       "device_wave_planned": 551,
                       "device_wave_executed": 537,
                       "device_wave_max_depth": 2,
                       "device_range_hits": 995,
                       "device_range_misses": 1,
                       "device_range_batches": 821,
                       "device_range_candidates": 247,
                       "device_compile_shapes": 15,
                       "miss_no_probe": 0,
                       "miss_version": 46,
                       "miss_key_cover": 0},
        },
    },
}


def node_device_counters(node) -> Dict[str, int]:
    """The ``device_*`` counters of a node's stores summed, with how many
    disabled their device tier (empty for stores without one)."""
    summed: Dict[str, int] = {}
    for store in node.command_stores.all():
        if hasattr(store, "device_hits"):
            summed["device_disabled"] = (summed.get("device_disabled", 0)
                                         + int(store.device_disabled))
            for name, v in device_counters(store).items():
                summed[name] = summed.get(name, 0) + v
    return summed


def burn_fingerprint(run) -> dict:
    """A finished ``sim.burn.BurnRun`` of either package as plain data: its
    stats, every ack latency, the events and virtual time, the end-of-run
    audit's outcomes and the final histories, and per node the Infer
    tallies, the agent's recorded failures and the ``device_*`` counters of
    its stores summed (none for stores without a device tier)."""
    st = run.stats
    nodes = {nid: {"device": node_device_counters(node),
                   "infer": dict(node.infer_stats),
                   "failures": len(run.cluster.agents[nid].failures)}
             for nid, node in sorted(run.cluster.nodes.items())}
    return {
        "stats": (st.acks, st.nacks, st.shed, st.lost, st.pending,
                  st.restarts),
        "ack_latencies_us": list(st.ack_latencies_us),
        "events": run.cluster.queue.processed,
        "now_us": run.cluster.queue.clock.now_us,
        "audit": [r["outcome"] for r in run.audit_rounds],
        "final": run._final_histories(),
        "nodes": nodes,
    }


def open_loop_fingerprint(run, node_paging_stats) -> dict:
    """A finished open-loop run of either package (``workload.openloop.
    run_open_loop_sim`` with ``keep_cluster=True``) as plain data: the
    report's counts and its open-loop quantiles in virtual microseconds,
    the ``paging`` section a lane added to the report, and per node its
    ``node_paging_stats`` (`node_paging_stats` is that package's
    ``local.paging.node_paging_stats``) and its stores' device counters,
    as they stand when this is called."""
    rep = run.report
    return {
        "counts": dict(rep["counts"]),
        "open_loop_us": dict(rep["open_loop"]),
        "paging": rep.get("paging"),
        "nodes": {nid: {"paging": node_paging_stats(node),
                        "device": node_device_counters(node)}
                  for nid, node in sorted(run.cluster.nodes.items())},
    }


# the plan that warms a store's flush path: every op kind of store_plan
WARM_MIX = (("preaccept", 0.40), ("accept", 0.05), ("commit", 0.15),
            ("apply", 0.15), ("recover", 0.05), ("range", 0.20))


def warm_flush_path(device, devices=None) -> None:
    """Run every step of a ``DeviceCommandStore``'s flush on `device` once,
    so that a store serving after it finds each kernel loaded.  CUDA loads
    a kernel's module at its first launch, and a node process's first deps
    flush then held its loop 0.5-1 s on an H100 (``node_probe.py``): far
    past the 1 s RPC timeout of its peers.  A seeded plan
    of every op kind (``store_plan``: preaccepts, accepts, commits, applies,
    recovery probes, range txns) runs through a DeviceCommandStore, then a
    window of 5,760 entries through ``resolve_step`` (torch's sort takes
    other kernels above 4,096 elements).  With `devices`, the cards of a
    ``MeshDeviceCommandStore`` (``devices[0]`` is `device`), the same plan
    then runs through such a store over them: CUDA loads a kernel's module
    on each card at its first launch there, and ``torch.cuda.nccl`` builds
    the communicators of a tuple of cards at its first all-reduce over
    them, far slower than a flush, and keeps them for the process.  The
    launches count as the kernels' launches."""
    from accord_tpu_torch.impl.device_store import (DeviceCommandStore,
                                                    MeshDeviceCommandStore)
    from accord_tpu_torch.ops.encode import BatchEncoder, window_to_tensors
    from accord_tpu_torch.ops.sharded import resolve_step

    plan = store_plan(0, n_keys=16, n_txns=160, window=(8, 64),
                      mix=WARM_MIX)
    factories = [DeviceCommandStore.factory(device=device)]
    if devices is not None:
        factories.append(MeshDeviceCommandStore.factory(
            n_shards=len(devices), device=device, devices=devices))
    for factory in factories:
        node = StoreNode()
        store = factory(0, node, node.kit.Ranges.of((0, 1 << 20)))
        runner = StorePlanRunner(store, node, plan)
        for ops in plan[1]:
            runner.run_window(ops)
    cfks, batch = build_world(n_keys=64, n_existing=3000, n_batch=64,
                              seed=1)
    enc = BatchEncoder(cfks, batch)
    for out in resolve_step(*window_to_tensors(enc.state, enc.dbatch,
                                               store.device)):
        out.cpu()


def tcp_cluster_txns(n_txns: int = 20, tokens=(10, 11, 12)) -> dict:
    """Three ``host.tcp.TcpHost`` nodes in this process on real localhost
    sockets (``tests/test_tcp_host.py``'s in-process cluster; the
    environment decides their stores, ``ACCORD_TCP_DEVICE_STORE=1`` the
    device ones): `n_txns` single-key appends round-robin over the nodes
    and `tokens`, each acked, then one read per token, all checked strictly
    serializable by ``StrictSerializabilityVerifier`` (raises on a failed
    txn or an anomaly).  -> {"seconds": wall seconds of the appends,
    "stores": every node's command stores, "nodes": the nodes}."""
    from accord_tpu_torch.host.tcp import TcpHost
    from accord_tpu_torch.sim.verify import (Observation,
                                             StrictSerializabilityVerifier)

    ports = {1: ("127.0.0.1", 0), 2: ("127.0.0.1", 0), 3: ("127.0.0.1", 0)}
    hosts = {}
    try:
        for i in (1, 2, 3):  # each binds its port; the next learns it
            hosts[i] = TcpHost(i, ports)
            ports = dict(hosts[i].peers)
        for h in hosts.values():
            h.peers.update(ports)
        verifier = StrictSerializabilityVerifier()
        t0 = time.perf_counter()
        for i in range(n_txns):
            h = hosts[1 + i % 3]
            token = tokens[i % len(tokens)]
            start = int(time.monotonic() * 1e6)
            res = h.submit([token], {token: i + 1}).wait(30.0)
            end = int(time.monotonic() * 1e6)
            if res.failure is not None:
                raise AssertionError(f"txn {i} failed: {res.failure!r}")
            verifier.observe(Observation(
                f"txn{i}@n{h.my_id}",
                {k.token: tuple(v) for k, v in res.value.read_values.items()},
                {token: i + 1}, start, end))
        seconds = time.perf_counter() - t0
        final = {}
        for token in tokens:
            res = hosts[2].submit([token], {}).wait(30.0)
            if res.failure is not None:
                raise AssertionError(f"read of {token} failed: "
                                     f"{res.failure!r}")
            final[token] = tuple(next(iter(res.value.read_values.values())))
        verifier.verify(final)
        return {"seconds": seconds, "nodes": [h.node for h in hosts.values()],
                "stores": [s for h in hosts.values()
                           for s in h.node.command_stores.all()]}
    finally:
        for h in hosts.values():
            h.close()


class _PlanTxn:
    __slots__ = ("txn_id", "txn", "route", "witnessed", "pa_deps", "acc_deps")


class StorePlanRunner:
    """Drives a plan through ``store.execute(context, fn)`` with the local
    state machine's transitions (``local/commands.py``), each op as the
    protocol's message applies it: PreAccept (preaccept, then the deps up to
    the txn id), Accept (at the preaccept's executeAt, then the deps up to
    it), a stable Commit, Apply (writes from the txn's update) and
    BeginRecovery (the recover promise, local deps, the fast-path decipher
    and the two earlier-txn scans).  Each op declares the probes its message
    declares, so a DeviceCommandStore precomputes them for its window.

    ``run_window`` submits a window's ops, drains the node's scheduler (one
    flush) and returns each op's result as plain tuples."""

    def __init__(self, store, node: StoreNode, plan):
        self.store = store
        self.node = node
        self.kit = node.kit
        self.specs, self.windows = plan
        self.txns: Dict[int, _PlanTxn] = {}

    def run(self, windows=None) -> List[list]:
        return [self.run_window(ops)
                for ops in (self.windows if windows is None else windows)]

    def run_window(self, ops) -> list:
        results = [None] * len(ops)
        for j, op in enumerate(ops):
            context, fn = getattr(self, "_" + op[0])(*op[1:])
            self.store.execute(context, self._recording(fn, results, j))
        self.node.scheduler.drain()
        return results

    @staticmethod
    def _recording(fn, results, j):
        def run(safe):
            results[j] = fn(safe)
        return run

    def _txn(self, i: int) -> _PlanTxn:
        st = self.txns.get(i)
        if st is not None:
            return st
        k = self.kit
        kind, domain, hlc, node, parts = self.specs[i]
        kind, domain = k.TxnKind(kind), k.Domain(domain)
        st = self.txns[i] = _PlanTxn()
        st.txn_id = k.TxnId.create(1, hlc, kind, domain, node)
        if domain == k.Domain.KEY:
            keys = k.Keys.of(*parts)
            update = (k.ListUpdate({k.Key(t): i for t in parts})
                      if kind == k.TxnKind.WRITE else None)
            txn = k.Txn(kind, keys, read=k.ListRead(keys),
                        query=k.ListQuery(), update=update)
            st.route = k.Route.of_keys(keys[0].as_routing(),
                                       keys.as_routing())
        else:
            ranges = k.Ranges.of(*parts)
            txn = (k.Txn(kind, ranges) if kind.is_sync_point else
                   k.Txn(kind, ranges, read=k.ListRangeRead(ranges),
                         query=k.ListQuery()))
            st.route = k.Route.of_ranges(k.RoutingKey(parts[0][0]), ranges)
        st.txn = txn.slice(self.store.ranges, include_query=True)
        st.witnessed = st.pa_deps = st.acc_deps = None
        return st

    def _execute_at(self, st: _PlanTxn):
        return st.witnessed if st.witnessed is not None else st.txn_id

    def _deps(self, st: _PlanTxn):
        for d in (st.acc_deps, st.pa_deps):
            if d is not None:
                return d
        return self.kit.Deps.NONE

    def _preaccept(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys = st.txn_id, st.txn.keys
        ctx = k.PreLoadContext.for_txn(
            tid, keys, deps_probes=((tid, tid.kind.witnesses(), keys),))

        def fn(safe):
            outcome, witnessed = k.C.preaccept(safe, tid, st.txn, st.route)
            deps = None
            if outcome in (k.C.AcceptOutcome.SUCCESS,
                           k.C.AcceptOutcome.REDUNDANT):
                deps = k.C.calculate_deps(safe, tid, keys, before=tid)
                if st.pa_deps is None:
                    st.witnessed, st.pa_deps = witnessed, deps
            return ("preaccept", outcome.name, ts_tuple(witnessed),
                    deps_tuple(deps))
        return ctx, fn

    def _accept(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys, at = st.txn_id, st.txn.keys, self._execute_at(st)
        ctx = k.PreLoadContext.for_txn(
            tid, keys, deps_probes=((at, tid.kind.witnesses(), keys),))

        def fn(safe):
            outcome = k.C.accept(safe, tid, k.Ballot.ZERO, st.route, keys, at,
                                 st.pa_deps or k.Deps.NONE)
            deps = None
            if outcome in (k.C.AcceptOutcome.SUCCESS,
                           k.C.AcceptOutcome.REDUNDANT):
                deps = k.C.calculate_deps(safe, tid, keys, before=at)
                if st.acc_deps is None:
                    st.acc_deps = deps
            return ("accept", outcome.name, deps_tuple(deps))
        return ctx, fn

    def _commit(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, at = st.txn_id, self._execute_at(st)
        ctx = k.PreLoadContext.for_txn(tid, st.txn.keys)

        def fn(safe):
            outcome = k.C.commit(safe, tid, st.route, st.txn, at,
                                 self._deps(st), stable=True)
            return ("commit", outcome.name)
        return ctx, fn

    def _apply(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys, at = st.txn_id, st.txn.keys, self._execute_at(st)
        probes = (((tid, at, keys),) if tid.domain == k.Domain.KEY else ())
        ctx = k.PreLoadContext.for_txn(tid, keys, execute_probes=probes)

        def fn(safe):
            writes = st.txn.execute(tid, at, None)
            outcome = k.C.apply(safe, tid, st.route, at, self._deps(st),
                                writes, None, partial_txn=st.txn)
            return ("apply", outcome.name)
        return ctx, fn

    def _recover(self, i: int, ballot_hlc: int):
        k, st = self.kit, self._txn(i)
        tid, keys = st.txn_id, st.txn.keys
        ballot = k.Ballot(1, ballot_hlc, 0, 2)
        ctx = k.PreLoadContext.for_txn(
            tid, keys, deps_probes=((tid, tid.kind.witnesses(), keys),),
            recovery_probes=((tid, keys),))

        def fn(safe):
            outcome, cmd = k.C.recover(safe, tid, st.txn, st.route, ballot)
            if outcome != k.C.AcceptOutcome.SUCCESS:
                return ("recover", outcome.name, cmd.save_status.name)
            local = None
            if cmd.known().deps < k.KnownDeps.COMMITTED:
                local = k.C.calculate_deps(safe, tid, keys, before=tid)
            rejects, unresolved = False, None
            witness = no_witness = None
            if not cmd.has_been(k.SaveStatus.PRE_COMMITTED):
                rejects, unresolved = safe.decipher_fast_path(tid, keys)
                witness = safe.earlier_committed_witness(tid, keys)
                no_witness = safe.earlier_accepted_no_witness(tid, keys)
            return ("recover", outcome.name, cmd.save_status.name,
                    ts_tuple(cmd.execute_at), deps_tuple(local), rejects,
                    deps_tuple(unresolved), deps_tuple(witness),
                    deps_tuple(no_witness))
        return ctx, fn
