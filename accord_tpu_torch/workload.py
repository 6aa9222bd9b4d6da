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
key-to-rows formulation can go wrong.  ``rangestress_inputs`` draws
``bench.py::bench_rangestress``'s intervals and queries.

The store tier is driven by plans: ``store_plan`` (a seeded random mix of
the local state machine's transitions, for the equivalence tests) and
``default_store_plan`` (the ``default`` cell's shape as a history of flush
windows).  ``StorePlanRunner`` runs a plan through ``store.execute(context,
fn)`` on a ``StoreNode``, the tests' FakeNode counterpart, and returns
every result as plain tuples.
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
