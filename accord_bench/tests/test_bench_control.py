"""The control fails the check; the reference in the program's place
passes it."""

import pytest

from accord_bench import check
from accord_bench.control import SnapshotStore, judge_control
from accord_bench.reference.store import ReferenceStore
from accord_bench.tests.test_bench_generate import TPCC, YCSB, mix


@pytest.mark.parametrize("config,window,windows", [
    (YCSB, 64, 12), (TPCC, 32, 12), (YCSB, 32, 40)])
@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6, 2**31 + 7])
def test_control_is_not_correct(config, window, windows, seed):
    numbers = judge_control(config, mix(window=window), seed, windows,
                            SnapshotStore)
    assert numbers["replies_wrong"] > check.LIMITS["replies_wrong"]
    assert not check.is_correct(numbers)


@pytest.mark.parametrize("config,window", [(YCSB, 64), (TPCC, 32)])
def test_reference_in_the_programs_place_is_correct(config, window):
    numbers = judge_control(config, mix(window=window), 3, 12,
                            ReferenceStore)
    assert numbers == {k: 0 for k in check.LIMITS}


def test_waves_wrong_by_hand():
    assert check.waves_wrong({1: 0, 2: 1}, {1: 0, 2: 1}) == 0
    # a wave off, an Apply left out, one added
    assert check.waves_wrong({1: 1, 3: 0}, {1: 0, 2: 1}) == 3
    assert check.waves_wrong({}, {}) == 0


def test_writes_out_of_order_by_hand():
    assert check.out_of_order([(7, 1001), (8, 999), (7, 1003), (7, 1002),
                               (8, 1000)]) == 1
