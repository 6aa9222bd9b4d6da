"""The deps encoder's two tiers, bit for bit, on the CPU.

``ops/encode.py::BatchEncoder`` ranks a flush window's timestamps in one
C++ pass of the native CFK core (``native/_cfk_core.cpp::encode_window``)
and falls back to its Python walk where the core does not load
(``ACCORD_NATIVE=0``, ``ACCORD_NO_NATIVE=1``, no toolchain).  Seeded random
worlds are encoded under each tier and every array of the state and the
batch, the counts, the universe (the objects it keeps, by type), the rank
map and both decodes must be equal.  The worlds hold executeAts set and
unset (some equal to another entry's id or to a probe's bound), every
``InternalStatus``, every ``TxnKind`` in both domains, empty CFKs, probe
keys with no CFK and windows with no entries.  Last, a device store on
the CPU counts each deps flush's tier and answers alike under both.

Every test here is marked ``slow``: the tier-1 run's budget guard
(``tests/conftest.py``) has no room for another unmarked test.  The tier-1
run holds the two tiers to the JAX encoder in ``tests/test_torch_port.py``.
They run with ``python -m pytest tests/test_torch_encode_tiers.py -m slow``.
"""

import random

import numpy as np
import pytest

from accord_tpu_torch import native
from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus
from accord_tpu_torch.ops import encode
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import (Domain, Timestamp, TxnId,
                                                   TxnKind)

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(native.get_cfk() is None,
                                 reason="no C++ toolchain: native CFK tier "
                                        "unavailable")]

STATE = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
         "entry_kind")
BATCH = ("txn_rank", "txn_witness_mask", "txn_kind", "touches")


def force_tier(monkeypatch, native_on: bool) -> None:
    """Select the encoder's tier through the loader, as ``ACCORD_NATIVE=0``
    does in a fresh interpreter."""
    import accord_tpu_torch.native as native_pkg
    if native_on:
        assert native_pkg.get_cfk() is not None
        return
    monkeypatch.setenv("ACCORD_NATIVE", "0")
    monkeypatch.setattr(native_pkg, "_cfk_tried", False)
    monkeypatch.setattr(native_pkg, "_cfk_mod", None)
    assert native_pkg.get_cfk() is None


def _world(seed):
    """-> (cfks, batch of (TxnId, keys), probes of (before, kinds, keys))."""
    rng = random.Random(seed)
    n_keys = rng.choice((0, 1, 3, 8, 16))
    keys = [Key(10 * i) for i in range(n_keys + 3)]
    # the last three keys never get a CFK; some CFKs stay empty
    cfks = [CommandsForKey(k) for k in keys[:n_keys]]
    ids, stamps = [], []
    hlc = 100
    for _ in range(rng.choice((0, 5, 40, 200))):
        if not cfks:
            break
        # a few ids share an hlc, so ranks tie-break on flags and node
        hlc += rng.choice((0, 1, 1, 2, 5))
        tid = TxnId.create(1, hlc, rng.choice(list(TxnKind)),
                           rng.choice(list(Domain)), rng.randrange(4))
        status = rng.choice(list(InternalStatus))
        eat = None
        r = rng.random()
        if r < 0.3:
            eat = Timestamp(1, hlc + rng.randrange(1, 30), 0,
                            rng.randrange(4))
        elif r < 0.4 and ids:
            # an executeAt equal to another entry's id, as a Timestamp
            other = rng.choice(ids)
            eat = Timestamp(other.epoch, other.hlc, other.flags, other.node)
        elif r < 0.45:
            eat = tid  # stored as None: the entry's own id
        for cfk in rng.sample(cfks, rng.randint(1, min(3, len(cfks)))):
            cfk.update(tid, status, eat)
        ids.append(tid)
        if eat is not None:
            stamps.append(eat)
    rng.shuffle(cfks)
    cfks = [c for c in cfks if rng.random() < 0.9]

    def some_keys():
        return sorted(rng.sample(keys, rng.randint(1, min(4, len(keys)))))

    batch, probes = [], []
    for _ in range(rng.choice((0, 1, 7, 30))):
        hlc += 1
        tid = TxnId.create(1, hlc, rng.choice(list(TxnKind)),
                           rng.choice(list(Domain)), rng.randrange(4))
        batch.append((tid, some_keys()))
        r = rng.random()
        if r < 0.25 and ids:
            before = rng.choice(ids)  # a probe bound equal to an entry id
        elif r < 0.4 and stamps:
            before = rng.choice(stamps)  # or to an executeAt
        elif r < 0.5 and ids:
            t = rng.choice(ids)  # an equal copy of another type
            before = Timestamp(t.epoch, t.hlc, t.flags, t.node)
        else:
            before = tid
        probes.append((before, rng.choice(list(TxnKind)).witnesses(),
                       some_keys()))
    return cfks, batch, probes


def _encodings(seed):
    cfks, batch, probes = _world(seed)
    return (lambda: encode.BatchEncoder(cfks, batch),
            lambda: encode.BatchEncoder.for_probes(cfks, probes))


def _snapshot(enc, mask):
    """Everything an encoder hands its callers, as plain data."""
    out = {f: getattr(enc.state, f).copy() for f in STATE}
    out.update({f: getattr(enc.dbatch, f).copy() for f in BATCH})
    out["counts"] = (enc.state.num_entries, enc.state.num_keys,
                     enc.dbatch.num_txns)
    out["universe"] = [(type(t), t.epoch, t.hlc, t.flags, t.node)
                       for t in enc.universe]
    out["rank"] = {(t.epoch, t.hlc, t.flags, t.node): i
                   for t, i in enc.rank.items()}
    out["keys"] = [(type(k), k.token) for k in enc.keys]
    out["entry_ids"] = [(type(t), t._cmp) for t in enc.entry_ids]
    out["deps"] = [[t._cmp for t in row] for row in enc.decode_deps(mask)]
    out["key_deps"] = [{k: [t._cmp for t in v] for k, v in row.items()}
                       for row in enc.decode_key_deps(mask)]
    return out


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], np.ndarray):
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name], b[name]), name
        else:
            assert a[name] == b[name], name


@pytest.mark.parametrize("seed", range(40))
def test_native_and_python_tiers_encode_alike(seed, monkeypatch):
    for make in _encodings(seed):
        native_enc = make()
        assert native_enc.tier == "native"
        rng = np.random.default_rng(seed)
        mask = rng.random((native_enc.dbatch.touches.shape[0],
                           native_enc.state.entry_rank.shape[0])) < 0.3
        want = _snapshot(native_enc, mask)
        with monkeypatch.context() as m:
            force_tier(m, False)
            python_enc = make()
        assert python_enc.tier == "python"
        _assert_equal(want, _snapshot(python_enc, mask))


def test_world_covers_every_status_kind_and_domain():
    """The seeds above reach every status, kind and domain, and both empty
    windows and windows with entries."""
    statuses, kinds, domains, sizes = set(), set(), set(), set()
    for seed in range(40):
        cfks, _batch, _probes = _world(seed)
        sizes.add(sum(len(c._ids) for c in cfks) > 0)
        for c in cfks:
            statuses.update(c._status)
            kinds.update(t.kind for t in c._ids)
            domains.update(t.domain for t in c._ids)
    assert statuses == set(InternalStatus)
    assert kinds == set(TxnKind)
    assert domains == set(Domain)
    assert sizes == {True, False}


@pytest.mark.parametrize("native_on", (True, False))
def test_an_id_without_a_kind_is_refused(native_on, monkeypatch):
    """An id whose kind bits name no TxnKind (here the NONE sentinel's
    flags 0) raises in both tiers, as ``TxnId.kind`` does."""
    cfk = CommandsForKey(Key(1))
    cfk.update(TxnId(1, 100, 0, 1), InternalStatus.PREACCEPTED)
    force_tier(monkeypatch, native_on)
    with pytest.raises(ValueError, match="no TxnKind in flags 0x0"):
        encode.BatchEncoder.for_probes([cfk], [])


def _lifecycle(monkeypatch, native_on):
    """A seeded plan of lifecycle windows, recovery probes and range txns
    among them, through a CPU device store under one encoder tier.  -> the
    store, its results and its deps flushes (K1's launches)."""
    from accord_tpu_torch.impl import device_store
    from accord_tpu_torch.workload import (StoreNode, StorePlanRunner,
                                           store_kit, store_plan)
    launches = []
    deps_step = device_store.batched_active_deps_cuda

    def counted(*args):
        launches.append(1)
        return deps_step(*args)

    with monkeypatch.context() as m:
        force_tier(m, native_on)
        m.setattr(device_store, "batched_active_deps_cuda", counted)
        node = StoreNode(store_kit())
        store = device_store.DeviceCommandStore(
            0, node, node.kit.Ranges.of((0, 1 << 20)), verify=True,
            device="cpu")
        results = StorePlanRunner(store, node,
                                  store_plan(3, n_keys=12, n_txns=160)).run()
    assert not store.device_disabled
    return store, results, len(launches)


def test_store_counts_each_deps_flush_by_tier(monkeypatch):
    """A short lifecycle on a CPU device store: every deps flush is counted
    under the encoder's tier, and both tiers give the same replies."""
    native_store, native_results, flushes = _lifecycle(monkeypatch, True)
    python_store, python_results, again = _lifecycle(monkeypatch, False)
    assert flushes > 0 and again == flushes
    assert native_store.device_encode_windows == {"native": flushes,
                                                  "python": 0}
    assert python_store.device_encode_windows == {"native": 0,
                                                  "python": flushes}
    assert python_results == native_results
    assert python_store.device_encoded_entries == \
        native_store.device_encoded_entries
