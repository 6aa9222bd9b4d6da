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
"""

from __future__ import annotations

import time

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
