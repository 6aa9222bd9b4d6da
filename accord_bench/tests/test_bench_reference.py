"""The plain reference against hand-worked cases, and against the program
on the CPU at small sizes."""

import pytest

from accord_bench.generate import Traffic
from accord_bench.reference.store import READ, WRITE, ReferenceStore, txn_id

from accord_bench.tests.test_bench_generate import TPCC, YCSB, mix


def spec(kind, hlc, tokens, node=1, writes=None):
    if writes is None:
        writes = tokens if kind == WRITE else ()
    return (kind, 0, hlc, node, tuple(tokens), tuple(writes))


def ids(store, *indices):
    return [store.ids[i] for i in indices]


def test_txn_id_by_hand():
    # flags = kind << 1 | domain
    assert txn_id(spec(WRITE, 1005, (1,), node=3)) == (1, 1005, 4, 3)
    assert txn_id(spec(READ, 1006, (1,), node=2)) == (1, 1006, 2, 2)


def test_deps_witness_kinds_by_hand():
    specs = [spec(WRITE, 1001, [7]), spec(READ, 1002, [7]),
             spec(READ, 1003, [7]), spec(WRITE, 1004, [7, 8])]
    ref = ReferenceStore(specs)
    r = ref.run_window([("preaccept", i) for i in range(4)])
    w0, r1, r2, w3 = ids(ref, 0, 1, 2, 3)
    assert r[0] == ("preaccept", "SUCCESS", w0, ((), ()))
    # a READ witnesses WRITEs only
    assert r[1] == ("preaccept", "SUCCESS", r1, (((7, w0),), ()))
    assert r[2] == ("preaccept", "SUCCESS", r2, (((7, w0),), ()))
    # a WRITE witnesses both
    assert r[3][3] == (((7, w0), (7, r1), (7, r2)), ())


def test_transitive_elision_by_hand():
    specs = [spec(WRITE, 1001, [7]), spec(READ, 1002, [7]),
             spec(WRITE, 1003, [7]), spec(READ, 1004, [7]),
             spec(WRITE, 1005, [7])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", i) for i in range(4)])
    ref.run_window([("commit", i) for i in range(4)]
                   + [("apply", i) for i in range(4)])
    r = ref.run_window([("preaccept", 4)])
    w2, r3 = ids(ref, 2, 3)
    # committed entries below the last committed write (w2) are elided
    assert r[0][3] == (((7, w2), (7, r3)), ())
    assert ref.data() == {7: (0, 2)}


def test_accept_sees_commits_since_preaccept_by_hand():
    specs = [spec(WRITE, 1001, [7]), spec(WRITE, 1002, [7]),
             spec(WRITE, 1003, [7])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", i) for i in range(3)])
    w0, w1 = ids(ref, 0, 1)
    ref.run_window([("commit", 0), ("commit", 1)])
    r = ref.run_window([("accept", 2)])
    assert r == [("accept", "SUCCESS", (((7, w1),), ()))]
    assert ref.run_window([("commit", 2), ("commit", 2)]) == [
        ("commit", "SUCCESS"), ("commit", "REDUNDANT")]


def test_writes_only_the_rows_written_by_hand():
    specs = [spec(WRITE, 1001, [7, 8], writes=[8]), spec(READ, 1002, [7])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", 0), ("preaccept", 1)])
    ref.run_window([("commit", 0), ("apply", 0), ("commit", 1),
                    ("apply", 1)])
    assert ref.data() == {8: (0,)}


def test_served_scans_by_hand():
    specs = [spec(WRITE, 1001, [7]), spec(READ, 1002, [8]),
             spec(READ, 1003, [7, 9]), spec(WRITE, 1004, [9])]
    ref = ReferenceStore(specs)
    # 0 and 1 touch no key another op changed before them; 2 shares 7
    # with 0; 3 shares 9 with 2
    assert ref.served([("preaccept", i) for i in range(4)]) == 2
    # an Accept's scan counts; Commits and Applies scan nothing
    assert ref.served([("preaccept", 1), ("accept", 0), ("commit", 2),
                       ("apply", 2), ("accept", 3)]) == 3
    assert ref.served([("accept", 0), ("preaccept", 2)]) == 1


def test_waves_by_hand():
    specs = [spec(WRITE, 1001, [7]), spec(READ, 1002, [7]),
             spec(READ, 1003, [7, 8]), spec(WRITE, 1004, [8]),
             spec(WRITE, 1005, [9])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", i) for i in range(5)])
    ops = [("commit", i) for i in range(5)] + \
        [("apply", i) for i in (4, 3, 2, 1, 0)]
    ref.run_window(ops)
    # the READs follow the WRITE at 7 but not each other; the WRITE at 8
    # follows the READ at 8
    assert ref.waves(ops) == {1001: 0, 1002: 1, 1003: 1, 1004: 2, 1005: 0}
    assert ref.waves([("apply", 0)]) == {}


def test_execute_at_bumps_above_a_later_conflict():
    specs = [spec(WRITE, 1010, [7]), spec(WRITE, 1005, [7])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", 0)])
    r = ref.run_window([("preaccept", 1)])
    assert r[0][2] == (1, 1011, 0, 1)


def program_and_reference(config, mixd, seed, n_windows):
    from accord_bench.driver import LifecycleRunner, StoreNode, store_kit
    from accord_bench.run import _record_plans
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    t = Traffic(config, mixd, seed)
    kit = store_kit()
    node = StoreNode(kit)
    store = DeviceCommandStore(0, node, kit.Ranges.of(tuple(config["span"])),
                               device="cpu")
    runner = LifecycleRunner(store, node, t.txns)
    plans = _record_plans(store)
    ref = ReferenceStore(t.txns)
    wrong = 0
    for w in range(n_windows):
        ops = t.ops(w)
        hits, want_served = store.device_hits, ref.served(ops)
        plans.clear()
        got, want = runner.run_window(ops), ref.run_window(ops)
        wrong += sum(g != x for g, x in zip(got, want))
        wrong += store.device_hits - hits != want_served
        got_waves = {tid.hlc: wave for p in plans
                     for tid, (wave, _eat) in p.items()}
        wrong += got_waves != ref.waves(ops)
    return wrong, node.data_store.snapshot(), ref.data(), store


@pytest.mark.parametrize("config,window", [(YCSB, 64), (YCSB, 16),
                                           (TPCC, 48), (TPCC, 24)])
def test_reference_agrees_with_the_program(config, window):
    wrong, data, want, store = program_and_reference(
        config, mix(window=window), 41, 14)
    assert wrong == 0
    assert data == want
    assert store.device_hits > 0 and not store.device_disabled
