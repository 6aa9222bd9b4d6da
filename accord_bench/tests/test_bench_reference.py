"""The plain reference against hand-worked cases, and against the program
on the CPU at small sizes."""

import pytest

from accord_bench import generate
from accord_bench.generate import Traffic
from accord_bench.reference.store import (RANGE_DOMAIN, READ, WRITE,
                                          ReferenceStore, txn_id)

from accord_bench.tests import range_cell
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


# ------------------------------------------------------------- ranges --
def rspec(hlc, *ranges, node=1):
    """A range READ over `ranges`."""
    return (READ, RANGE_DOMAIN, hlc, node, tuple(ranges), ())


def test_range_txn_sits_in_the_range_index_only_by_hand():
    specs = [spec(WRITE, 1001, [7]), rspec(1002, (5, 10))]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", 0), ("preaccept", 1)])
    assert txn_id(specs[1]) == (1, 1002, 3, 1)
    assert ref.range_txns == [1]
    assert set(ref.keys) == {7} and list(ref.keys[7].uncommitted) == [0]
    ref.run_window([("commit", 0), ("commit", 1), ("apply", 0),
                    ("apply", 1)])
    assert ref.keys[7].committed == [(ref.eat[0], 0)]
    assert ref.applied == [0, 1] and ref.data() == {7: (0,)}


def test_range_txn_deps_are_the_key_tier_inside_its_ranges_by_hand():
    specs = [spec(WRITE, 1001, [3]), spec(WRITE, 1002, [7]),
             spec(READ, 1003, [7]), spec(WRITE, 1004, [12]),
             spec(WRITE, 1005, [7]), rspec(1006, (5, 13)),
             spec(WRITE, 1007, [8]), rspec(1008, (5, 13))]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", i) for i in range(5)])
    # 1 and 4 commit: 1 at key 7 is elided below the committed write 4
    ref.run_window([("commit", 1), ("apply", 1), ("commit", 4),
                    ("apply", 4)])
    r = ref.run_window([("preaccept", 5), ("preaccept", 6),
                        ("preaccept", 7)])
    w3, w4, r5, w6 = ids(ref, 3, 4, 5, 6)
    # a READ witnesses the WRITEs at keys 7 and 12, not the READ at 7 nor
    # the WRITE at 3 outside its range; 8 had no key yet
    assert r[0] == ("preaccept", "SUCCESS", r5, (((7, w4), (12, w3)), ()))
    # the WRITE at 8 created that key: a later scan of the range walks it
    assert r[2][3] == (((7, w4), (8, w6), (12, w3)), ())


def test_range_arm_elides_nothing_by_hand():
    specs = [rspec(1001, (0, 10)), spec(WRITE, 1002, [5]),
             spec(WRITE, 1003, [5])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", 0), ("preaccept", 1)])
    ref.run_window([("commit", 0), ("commit", 1), ("apply", 0),
                    ("apply", 1)])
    r = ref.run_window([("preaccept", 2)])
    r0, w1 = ids(ref, 0, 1)
    # the committed range READ below the committed WRITE stays a dep
    assert r[0][3] == (((5, w1),), ((0, 10, r0),))


def test_key_txn_deps_gain_the_ranges_that_hold_its_keys_by_hand():
    specs = [rspec(1001, (0, 10), (15, 18)), rspec(1002, (4, 6)),
             spec(WRITE, 1003, [2, 5, 20]), spec(READ, 1004, [5]),
             rspec(1005, (0, 30)), spec(WRITE, 1006, [16])]
    ref = ReferenceStore(specs)
    r = ref.run_window([("preaccept", i) for i in range(6)])
    r0, r1, w2, r4 = ids(ref, 0, 1, 2, 4)
    # each range that holds one of the keys, whole and once; not the
    # range of the same txn that holds none; the READ at 5 witnesses no
    # READ; 4 is above the WRITE's id
    assert r[2][3] == ((), ((0, 10, r0), (4, 6, r1)))
    assert r[3][3] == (((5, w2),), ())
    assert r[5][3] == ((), ((0, 30, r4), (15, 18, r0)))


def test_execute_at_takes_in_the_range_index_by_hand():
    # a key txn below a range txn that holds its key
    ref = ReferenceStore([rspec(1010, (0, 10)), spec(WRITE, 1005, [5])])
    r = ref.run_window([("preaccept", 0), ("preaccept", 1)])
    assert r[1][2] == (1, 1011, 0, 1)
    # a range txn below a key inside its ranges, or below a range it meets
    ref = ReferenceStore([spec(WRITE, 1010, [5]), rspec(1005, (0, 10)),
                          rspec(1003, (9, 12)), rspec(1004, (20, 30))])
    r = ref.run_window([("preaccept", i) for i in range(4)])
    assert r[1][2] == (1, 1011, 0, 1)
    assert r[2][2] == (1, 1012, 0, 1)
    assert r[3][2] == ref.ids[3]


def test_served_covers_the_range_arm_by_hand():
    specs = [spec(WRITE, 1001, [7]), rspec(1002, (5, 10)),
             spec(WRITE, 1003, [12]), rspec(1004, (10, 20)),
             spec(READ, 1005, [6])]
    ref = ReferenceStore(specs)
    ops = [("preaccept", i) for i in range(5)]
    # the key tier: 1 walks key 7, which 0 created earlier in the window;
    # 3 walks 12, created by 2; 0, 2 and 4 are served
    assert ref.served(ops) == 3
    assert ref.served([("preaccept", 1), ("preaccept", 0)]) == 2
    # the range arm: nothing while the index is empty at the flush, then
    # every scan
    assert ref.range_served(ops) == 0
    ref.run_window(ops)
    later = [("preaccept", 4), ("accept", 0), ("accept", 1), ("commit", 2)]
    assert ref.range_served(later) == 3


def test_range_txns_have_no_wave_by_hand():
    specs = [spec(WRITE, 1001, [7]), rspec(1002, (5, 10)),
             spec(WRITE, 1003, [7])]
    ref = ReferenceStore(specs)
    ref.run_window([("preaccept", i) for i in range(3)])
    ops = [("commit", i) for i in range(3)] + [("apply", i)
                                               for i in range(3)]
    ref.run_window(ops)
    assert ref.waves(ops) == {1001: 0, 1003: 1}
    assert ref.waves([("apply", 0), ("apply", 1)]) == {}


@pytest.mark.parametrize("window,seed", [(32, 2**31 + 41), (96, 5)])
def test_reference_agrees_with_the_program_on_ranges(window, seed, tmp_path,
                                                     monkeypatch):
    range_cell.write_key_model(tmp_path / "key_models")
    monkeypatch.setattr(generate, "HERE", tmp_path)
    wrong, data, want, store = program_and_reference(
        range_cell.CONFIG_DATA, mix(window=window), seed, 10)
    assert wrong == 0
    assert data == want
    assert store.device_range_hits > 0 and not store.device_disabled
    assert store.device_miss_causes["key_cover"] > 0
