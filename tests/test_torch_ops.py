"""The port's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version in accord_tpu_torch.ops (the CPU path, and the
oracle the CUDA kernels are held to on the card) must be == to its JAX
counterpart on the same numpy inputs.  Every output is integer or boolean,
so the tolerance throughout is exact equality.  The kernel wrappers of
ops/cuda_kernels.py must take the plain versions on CPU tensors without
counting a launch.
"""

import jax
import numpy as np
import pytest
import torch

from accord_tpu.ops import BatchEncoder as JaxEncoder
from accord_tpu.ops import batched_active_deps as jax_batched_active_deps
from accord_tpu.ops import execution_waves as jax_execution_waves
from accord_tpu.ops import in_batch_graph as jax_in_batch_graph
from accord_tpu.ops import waves_oracle as jax_waves_oracle
from accord_tpu.ops.deps_kernel import _successor_write_eat as jax_successor
from accord_tpu.utils.random_source import RandomSource as JaxRandom
from accord_tpu_torch.ops import cuda_kernels, deps_kernel, wavefront
from tests.test_ops import random_world as jax_random_world


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_window(cfks, batch):
    """The JAX package's encoding of a window: the nine numpy arrays in
    resolve_step order."""
    enc = JaxEncoder(cfks, batch)
    s, b = enc.state, enc.dbatch
    return (s.entry_rank, s.entry_eat_rank, s.entry_key, s.entry_status,
            s.entry_kind, b.txn_rank, b.txn_witness_mask, b.txn_kind,
            b.touches)


def _deps_args(w):
    """resolve_step order -> batched_active_deps order (drops txn_kind)."""
    return w[:7] + (w[8],)


def _random_dag(rng, n, p):
    rank = rng.permutation(n)
    return (rng.random((n, n)) < p) & (rank[None, :] < rank[:, None])


@pytest.mark.parametrize("seed", range(4))
def test_batched_active_deps_matches_jax(seed):
    w = _jax_window(*jax_random_world(JaxRandom(500 + seed)))
    mask_j, count_j = jax_batched_active_deps(*_deps_args(w))
    mask_t, count_t = deps_kernel.batched_active_deps(
        *map(_t, _deps_args(w)))
    assert mask_t.dtype == torch.bool and count_t.dtype == torch.int32
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert np.array_equal(count_t.numpy(), np.asarray(count_j))


@pytest.mark.parametrize("seed", range(3))
def test_successor_write_eat_matches_jax(seed):
    """The port's first-write-after lookup (a cumsum over the sorted writes)
    == the JAX segmented suffix-min scan, on unsorted keys with ties, -1
    pads and entries without a successor."""
    rng = np.random.default_rng(40 + seed)
    e = 512
    key = rng.integers(0, 9, e).astype(np.int32)
    eat = rng.integers(-1, 300, e).astype(np.int32)
    big = np.iinfo(np.int32).max
    write_eat = np.where(rng.random(e) < 0.4, eat, big).astype(np.int32)
    got = deps_kernel._successor_write_eat(_t(key), _t(eat), _t(write_eat))
    want = np.asarray(jax.jit(jax_successor)(key, eat, write_eat))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_batched_active_deps_large_k_matches_jax():
    """K above the Pallas tile's 16384 cap (where the JAX kernel hands off to
    its plain version): the port takes every K."""
    import bench
    cfks, batch = bench.build_world(n_keys=16500, n_existing=300,
                                    n_batch=100, seed=3)
    w = _jax_window(cfks, batch)
    assert w[8].shape[1] > 16384
    mask_j, count_j = jax_batched_active_deps(*_deps_args(w))
    mask_t, count_t = deps_kernel.batched_active_deps(
        *map(_t, _deps_args(w)))
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert np.array_equal(count_t.numpy(), np.asarray(count_j))


@pytest.mark.parametrize("seed", range(3))
def test_in_batch_graph_matches_jax(seed):
    _, batch = jax_random_world(JaxRandom(200 + seed), n_existing=0,
                                n_batch=40)
    w = _jax_window([], batch)
    args = (w[5], w[6], w[7], w[8])
    want = np.asarray(jax_in_batch_graph(*args))
    got = deps_kernel.in_batch_graph(*map(_t, args))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_execution_waves_matches_jax(seed):
    dep = _random_dag(np.random.default_rng(600 + seed), 128, 0.08)
    got = wavefront.execution_waves(_t(dep))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax_execution_waves(dep)))


def test_execution_waves_deep_chain_matches_jax():
    """The fixpoint's worst case (B iterations): a full chain plus sparse
    extra edges, as tests/test_pallas.py runs it."""
    rng = np.random.default_rng(7)
    n = 128
    dep = np.zeros((n, n), bool)
    dep[np.arange(1, n), np.arange(n - 1)] = True
    rank = np.arange(n)
    dep |= (rng.random((n, n)) < 0.02) & (rank[None, :] < rank[:, None])
    got = wavefront.execution_waves(_t(dep)).numpy()
    assert np.array_equal(got, np.asarray(jax_execution_waves(dep)))
    assert got.max() == n - 1


def test_execution_waves_large_b_matches_jax():
    """B = 1152, above the Pallas wavefront's 1024 cap."""
    n = 1152
    dep = np.zeros((n, n), bool)
    dep[1, 0] = dep[2, 1] = dep[n - 1, 2] = True
    got = wavefront.execution_waves(_t(dep)).numpy()
    assert np.array_equal(got, np.asarray(jax_execution_waves(dep)))
    assert list(got[:3]) == [0, 1, 2] and got[n - 1] == 3


def test_execution_waves_cycle_matches_jax():
    """Degenerate input: rows on a cycle never become ready and keep -1 once
    the B+1 iteration bound stops the loop, in both packages."""
    dep = np.zeros((6, 6), bool)
    dep[1, 0] = dep[2, 3] = dep[3, 2] = dep[4, 3] = True
    got = wavefront.execution_waves(_t(dep)).numpy()
    assert np.array_equal(got, np.asarray(jax_execution_waves(dep)))
    assert list(got) == [0, 1, -1, -1, -1, 0]


def test_waves_oracle_matches_jax():
    dep = _random_dag(np.random.default_rng(3), 64, 0.1)
    rows = [list(np.nonzero(r)[0]) for r in dep]
    assert wavefront.waves_oracle(rows) == jax_waves_oracle(rows)
    assert wavefront.waves_oracle(rows) == \
        wavefront.execution_waves(_t(dep)).tolist()


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers return the plain versions' results
    and launch nothing."""
    cuda_kernels.reset_launch_counts()
    w = tuple(map(_t, _jax_window(*jax_random_world(JaxRandom(9)))))
    got = cuda_kernels.batched_active_deps_cuda(*_deps_args(w))
    want = deps_kernel.batched_active_deps(*_deps_args(w))
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    dep = _t(_random_dag(np.random.default_rng(9), 64, 0.1))
    assert torch.equal(cuda_kernels.execution_waves_cuda(dep),
                       wavefront.execution_waves(dep))
    assert [k.launches for k in cuda_kernels.KERNELS] == [0, 0, 0, 0]


def test_wrappers_refuse_mixed_devices():
    dep = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels._cuda_device((dep, torch.zeros(4, device="meta")))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.execution_waves_cuda(dep.to("meta"))
