"""The store tier's copied primitives against the JAX package's modules.

The same numpy-seeded inputs go through each package's copy: sorted-array
search and merges, Keys/Ranges slice, union and subtract, KeyDeps/RangeDeps
build, merge and slice, the interval map's folds, the checkpoint interval
index, and the completed CommandsForKey (versions, ``update``'s fired waits,
the elision classifier of the recovery scans) on a seeded update sequence.
Outputs are compared as plain tuples, with ==.
"""

import numpy as np
import pytest

from accord_tpu.local import cfk as jax_cfk
from accord_tpu.primitives import deps as jax_deps
from accord_tpu.primitives import keys as jax_keys
from accord_tpu.primitives import timestamp as jax_ts
from accord_tpu.utils import checkpoint_intervals as jax_ci
from accord_tpu.utils import interval_map as jax_im
from accord_tpu.utils import sorted_arrays as jax_sa
from accord_tpu_torch.local import cfk as port_cfk
from accord_tpu_torch.primitives import deps as port_deps
from accord_tpu_torch.primitives import keys as port_keys
from accord_tpu_torch.primitives import timestamp as port_ts
from accord_tpu_torch.utils import checkpoint_intervals as port_ci
from accord_tpu_torch.utils import interval_map as port_im
from accord_tpu_torch.utils import sorted_arrays as port_sa
from accord_tpu_torch.workload import deps_tuple, ts_tuple

SEEDS = [0, 1, 2]


def _sorted_unique(r, n, hi=200):
    return sorted(set(int(x) for x in r.integers(0, hi, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_sorted_arrays(seed):
    r = np.random.default_rng(seed)
    lists = [_sorted_unique(r, int(r.integers(0, 40))) for _ in range(6)]
    for a in lists:
        for b in lists:
            for name in ("linear_union", "linear_intersection",
                         "linear_subtract"):
                assert list(getattr(port_sa, name)(a, b)) == \
                    list(getattr(jax_sa, name)(a, b)), name
        for target in range(-2, 203, 7):
            for name in ("find_ceil", "find_floor", "binary_search"):
                assert getattr(port_sa, name)(a, target) == \
                    getattr(jax_sa, name)(a, target), (name, target)
    assert list(port_sa.linear_merge_n(lists)) == \
        list(jax_sa.linear_merge_n(lists))


def _ranges(mod, r, n):
    pairs = []
    for _ in range(n):
        s = int(r.integers(0, 900))
        pairs.append((s, s + 1 + int(r.integers(0, 120))))
    return mod.Ranges.of(*pairs)


def _span_tuple(ranges):
    return tuple((x.start, x.end) for x in ranges)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_ranges(seed):
    r = np.random.default_rng(seed)
    for _ in range(20):
        toks = [int(x) for x in r.integers(0, 1000, int(r.integers(1, 30)))]
        toks2 = [int(x) for x in r.integers(0, 1000, int(r.integers(1, 30)))]
        state = r.bit_generator.state
        pr = [_ranges(port_keys, r, int(r.integers(1, 5))) for _ in range(2)]
        r.bit_generator.state = state
        jr = [_ranges(jax_keys, r, int(r.integers(1, 5))) for _ in range(2)]
        assert [_span_tuple(x) for x in pr] == [_span_tuple(x) for x in jr]
        pk, jk = port_keys.Keys.of(*toks), jax_keys.Keys.of(*toks)
        pk2, jk2 = port_keys.Keys.of(*toks2), jax_keys.Keys.of(*toks2)
        assert pk.slice(pr[0]).tokens() == jk.slice(jr[0]).tokens()
        assert pk.with_(pk2).tokens() == jk.with_(jk2).tokens()
        assert pk.subtract(pk2).tokens() == jk.subtract(jk2).tokens()
        assert pk.intersects_ranges(pr[1]) == jk.intersects_ranges(jr[1])
        assert _span_tuple(pk.to_ranges()) == _span_tuple(jk.to_ranges())
        for op in ("union", "subtract", "intersection"):
            assert _span_tuple(getattr(pr[0], op)(pr[1])) == \
                _span_tuple(getattr(jr[0], op)(jr[1])), op
        assert pr[0].intersects(pr[1]) == jr[0].intersects(jr[1])
        assert pr[0].contains_all_ranges(pr[1]) == \
            jr[0].contains_all_ranges(jr[1])


def _txn_ids(mod, r, n):
    return [mod.TxnId.create(1, int(r.integers(1, 500)),
                             mod.TxnKind(int(r.integers(1, 6))),
                             mod.Domain(int(r.integers(0, 2))),
                             int(r.integers(0, 4))) for _ in range(n)]


def _deps_pair(seed):
    """The same random KeyDeps and RangeDeps, one per package."""
    out = []
    for ts, keys, deps in ((port_ts, port_keys, port_deps),
                           (jax_ts, jax_keys, jax_deps)):
        r = np.random.default_rng(seed)
        kb, rb = deps.KeyDeps.builder(), deps.RangeDeps.builder()
        ids = _txn_ids(ts, r, 40)
        for _ in range(60):
            kb.add(keys.Key(int(r.integers(0, 50)) * 10),
                   ids[int(r.integers(len(ids)))])
            s = int(r.integers(0, 450))
            rb.add(keys.Range(s, s + 1 + int(r.integers(0, 60))),
                   ids[int(r.integers(len(ids)))])
        out.append(deps.Deps(kb.build(), rb.build()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_range_deps(seed):
    p1, j1 = _deps_pair(seed)
    p2, j2 = _deps_pair(seed + 100)
    assert deps_tuple(p1) == deps_tuple(j1)
    assert deps_tuple(p1.with_(p2)) == deps_tuple(j1.with_(j2))
    assert deps_tuple(port_deps.Deps.merge([p1, p2])) == \
        deps_tuple(jax_deps.Deps.merge([j1, j2]))
    for lo, hi in ((0, 100), (50, 260), (300, 520)):
        assert deps_tuple(p1.slice(port_keys.Ranges.of((lo, hi)))) == \
            deps_tuple(j1.slice(jax_keys.Ranges.of((lo, hi))))
    assert list(map(ts_tuple, p1.sorted_txn_ids())) == \
        list(map(ts_tuple, j1.sorted_txn_ids()))
    for tok in range(0, 500, 37):
        got, want = [], []
        p1.range_deps.for_each_covering(port_keys.RoutingKey(tok), got.append)
        j1.range_deps.for_each_covering(jax_keys.RoutingKey(tok),
                                        want.append)
        assert sorted(map(ts_tuple, got)) == sorted(map(ts_tuple, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_interval_map_folds(seed):
    r = np.random.default_rng(seed)
    pm = port_im.ReducingRangeMap.empty()
    jm = jax_im.ReducingRangeMap.empty()
    for _ in range(40):
        s = int(r.integers(0, 200))
        e = s + int(r.integers(0, 60))
        v = int(r.integers(0, 1000))
        pm = pm.update(s, e, v, max)
        jm = jm.update(s, e, v, max)
        assert pm.spans() == jm.spans()
    other = [(int(r.integers(0, 200)), int(r.integers(0, 1000)))
             for _ in range(10)]
    po, jo = port_im.ReducingRangeMap.empty(), jax_im.ReducingRangeMap.empty()
    for s, v in other:
        po, jo = po.update(s, s + 25, v, max), jo.update(s, s + 25, v, max)
    assert pm.merge(po, max).spans() == jm.merge(jo, max).spans()
    for s in range(0, 260, 13):
        assert pm.fold_max(s, s + 30) == jm.fold_max(s, s + 30)
        assert pm.get_range_min(s, s + 30, -1) == \
            jm.get_range_min(s, s + 30, -1)
        assert pm.get(s) == jm.get(s)


@pytest.mark.parametrize("seed", SEEDS)
def test_checkpoint_interval_index(seed):
    r = np.random.default_rng(seed)
    pairs = sorted((int(s), int(s) + int(w)) for s, w in
                   zip(r.integers(0, 500, 120), r.integers(1, 80, 120)))
    starts, ends = [s for s, _ in pairs], [e for _, e in pairs]
    pi = port_ci.CheckpointIntervalIndex(starts, ends)
    ji = jax_ci.CheckpointIntervalIndex(starts, ends)
    for p in range(-5, 600, 11):
        got, want = [], []
        pi.find(p, got.append)
        ji.find(p, want.append)
        assert got == want
        got, want = [], []
        pi.find_overlaps(p, p + 17, got.append)
        ji.find_overlaps(p, p + 17, want.append)
        assert sorted(got) == sorted(want)


def _cfk_sequence(ts, cfk_mod, seed):
    """A seeded sequence of update / unmanaged / prune calls on one CFK ->
    what each step returned and the CFK's state after it, as plain data."""
    r = np.random.default_rng(seed)
    key = cfk_mod.Key(7)
    c = cfk_mod.CommandsForKey(key)
    statuses = list(cfk_mod.InternalStatus)
    ids = []
    trace = []
    for step in range(160):
        roll = r.random()
        if roll < 0.6 or not ids:
            hlc = 100 + 3 * step + int(r.integers(3))
            kind = ts.TxnKind([1, 2, 2, 4, 5][int(r.integers(5))])
            tid = ts.TxnId.create(1, hlc, kind, ts.Domain.KEY,
                                  int(r.integers(4)))
            ids.append(tid)
        else:
            tid = ids[int(r.integers(len(ids)))]
        status = statuses[int(r.integers(1, len(statuses)))]
        eat = None
        if status.has_info and r.random() < 0.3:
            eat = ts.Timestamp(1, tid.hlc + 1 + int(r.integers(40)), 0,
                               int(r.integers(4)))
        dep_ids = None
        if status.has_info:
            pool = c.all_ids()
            dep_ids = [pool[int(i)] for i in
                       r.choice(len(pool), int(r.integers(len(pool) + 1)),
                                replace=False)] if pool else []
        fired = c.update(tid, status, eat, dep_ids=dep_ids)
        if r.random() < 0.15:
            until = ts.Timestamp(1, tid.hlc + int(r.integers(30)), 0, 0)
            if c.blocking_ids(cfk_mod.Unmanaged.APPLY, until):
                c.register_unmanaged(cfk_mod.Unmanaged(
                    tid, cfk_mod.Unmanaged.APPLY, until, None))
        if r.random() < 0.03:
            fired = fired + c.prune_redundant(
                ids[int(r.integers(len(ids)))])
        probe = ids[int(r.integers(len(ids)))]
        trace.append((
            sorted(ts_tuple(u.txn_id) for u in fired),
            c.version, c.committed_version, ts_tuple(c.last_mutator),
            [ts_tuple(t) for t in c.all_ids()],
            [int(s) for s in c.as_arrays()[1]],
            [ts_tuple(e) for e in c.as_arrays()[2]],
            [[ts_tuple(m) for m in ms] for ms in c.as_arrays()[3]],
            [(ts_tuple(t), d) for t, d in c.blocking_ids(
                cfk_mod.Unmanaged.APPLY, probe)],
            [ts_tuple(t) for t in
             c.started_after_without_witnessing_ids(probe)],
            [ts_tuple(t) for t in
             c.executes_after_without_witnessing_ids(probe)],
            [ts_tuple(t) for t in
             c.started_after_without_witnessing_ids(probe, raw=True)],
            ts_tuple(c.max_conflict()), ts_tuple(c.min_uncommitted()),
        ))
    return trace


@pytest.mark.parametrize("seed", SEEDS)
def test_cfk_versions_and_waits(seed):
    """The completed CommandsForKey: version counters, last mutator, the
    waits update and prune fire, blocking ids and the elision classifier
    == the JAX package's after every step of a seeded sequence."""
    port = _cfk_sequence(port_ts, port_cfk, seed)
    ref = _cfk_sequence(jax_ts, jax_cfk, seed)
    for step, (got, want) in enumerate(zip(port, ref)):
        assert got == want, f"step {step}"
