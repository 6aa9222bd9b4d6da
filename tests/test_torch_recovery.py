"""The port's batched recovery scans against the JAX package, on the CPU.

The same seeded world is built by each package and mixed into the same
window of recovery probes (new transactions, then ids the world knows, as
tests/test_recovery_kernel.py mixes them).  The port's encoder must give the
JAX encoder's arrays, its ``batched_recovery_scans`` the JAX function's four
[B, E] masks, and its scalar scans (the raw enumeration of ``local/cfk.py``)
the JAX package's.  Every output is boolean or integer: the tolerance is ==.
"""

import numpy as np
import pytest

from accord_tpu.ops.recovery_kernel import RecoveryEncoder as JaxEncoder
from accord_tpu.ops.recovery_kernel import \
    batched_recovery_scans as jax_recovery_scans
from accord_tpu.utils.random_source import RandomSource as JaxRandom
from accord_tpu_torch import workload
from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                  batched_recovery_scans,
                                                  scalar_predicates)
from tests.test_ops import random_world as jax_random_world

SIZES = dict(n_keys=10, n_existing=70, n_probes=20)
# together these seeds make each of the four masks non-empty at least once
SEEDS = (900, 901, 903, 905)


def _jax_recovery_world(seed, n_keys, n_existing, n_probes):
    """workload.recovery_world, built by the JAX package."""
    n_batch = n_probes // 2
    cfks, batch = jax_random_world(JaxRandom(seed), n_keys=n_keys,
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


def _ids(ts):
    return [(t.epoch, t.hlc, t.flags, t.node) for t in ts]


def _port_masks(enc):
    return [m.numpy() for m in batched_recovery_scans(*enc.tensors("cpu"))]


@pytest.mark.parametrize("seed", SEEDS)
def test_recovery_scans_match_jax(seed):
    jax_cfks, jax_probes = _jax_recovery_world(seed, **SIZES)
    cfks, probes = workload.recovery_world(seed=seed, **SIZES)
    assert [_ids([t]) for t, _ in probes] == [_ids([t]) for t, _ in jax_probes]
    je, pe = JaxEncoder(jax_cfks, jax_probes), RecoveryEncoder(cfks, probes)
    for got, want in zip(pe.args()[:9], je.args()[:9]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert pe.rank_count == je.rank_count
    got = _port_masks(pe)
    want = [np.asarray(m) for m in jax_recovery_scans(*je.args())]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)

    # the port's scalar scans == the JAX package's, probe by probe, and the
    # masks folded and decoded == the port's scalar scans
    jax_by_key = {c.key.token: c for c in jax_cfks}
    for i, (probe, keys) in enumerate(probes):
        jprobe = jax_probes[i][0]
        for k in keys:
            pc = next(c for c in cfks if c.key == k)
            jc = jax_by_key[k.token]
            for raw in (True, False):
                assert _ids(pc.started_after_without_witnessing_ids(
                    probe, raw=raw)) == _ids(
                    jc.started_after_without_witnessing_ids(jprobe, raw=raw))
                assert _ids(pc.executes_after_without_witnessing_ids(
                    probe, raw=raw)) == _ids(
                    jc.executes_after_without_witnessing_ids(jprobe, raw=raw))
            assert _ids(pc.stable_started_before_and_witnessed(probe)) == \
                _ids(jc.stable_started_before_and_witnessed(jprobe))
            assert _ids(pc.accepted_started_before_without_witnessing(
                probe)) == _ids(
                jc.accepted_started_before_without_witnessing(jprobe))
        ra, rb, cw, anw = scalar_predicates(cfks, probe, keys)
        assert (bool(got[0][i].any()), bool(got[1][i].any())) == (ra, rb)
        assert pe.decode_ids(got[2][i]) == cw
        assert pe.decode_ids(got[3][i]) == anw
    # padded probe rows contribute nothing
    assert not any(m[len(probes):].any() for m in got)


def test_recovery_seeds_exercise_every_mask():
    """The seeds above are not vacuous: each of the four masks holds an
    entry on at least one of them."""
    sums = np.zeros(4, np.int64)
    for seed in SEEDS:
        enc = RecoveryEncoder(*workload.recovery_world(seed=seed, **SIZES))
        sums += [int(m.sum()) for m in _port_masks(enc)]
    assert (sums > 0).all(), sums


def test_recovery_empty_world():
    pe, je = RecoveryEncoder([], []), JaxEncoder([], [])
    for got, want in zip(pe.args()[:9], je.args()[:9]):
        assert np.array_equal(got, want)
    got = _port_masks(pe)
    assert all(g.shape == (128, 128) and not g.any() for g in got)
    assert all(np.array_equal(g, np.asarray(w)) for g, w in
               zip(got, jax_recovery_scans(*je.args())))


def test_recovery_window_matches_jax_at_full_size():
    """The card's recovery window (``workload.recovery_world()`` at its
    defaults: E = 32,896 entries, R = 19,313 ranks, 512 probes) built by
    each package: the same probes, encoded arrays and four masks, whose
    sums are [429, 403, 1, 0] on both."""
    jax_cfks, jax_probes = _jax_recovery_world(42, n_keys=1024,
                                               n_existing=16384,
                                               n_probes=512)
    cfks, probes = workload.recovery_world()
    assert [_ids([t]) for t, _ in probes] == [_ids([t]) for t, _ in jax_probes]
    je, pe = JaxEncoder(jax_cfks, jax_probes), RecoveryEncoder(cfks, probes)
    assert (pe.entry_rank.shape[0], pe.rank_count) == (32_896, 19_313)
    for got, want in zip(pe.args()[:9], je.args()[:9]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = _port_masks(pe)
    want = [np.asarray(m) for m in jax_recovery_scans(*je.args())]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert [int(m.sum()) for m in got] == [429, 403, 1, 0]
