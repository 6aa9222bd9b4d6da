"""The wavefront's rank-ordered interface against the JAX package, on the
CPU.

``execution_waves_cuda(dep_bb, txn_rank)`` takes the rows' ranks so that K2
(csrc/wavefront.cu) can run its forward pass; the function is the same with
or without them, so on CPU tensors the wrapper takes the plain version and
must be == to the Pallas wavefront run in interpret mode, as
tests/test_pallas.py runs it, on DAGs over permuted ranks, with ties and
padded rows, and with cycles.  ``resolve_step``, which now hands the ranks
to the wavefront, must stay == to the JAX ``resolve_step`` on a window whose
rows are not in rank order.  Every output is integer or boolean: the
tolerance is ==.
"""

import numpy as np
import pytest
import torch

from accord_tpu.ops import BatchEncoder as JaxEncoder
from accord_tpu.ops import resolve_step as jax_resolve_step
from accord_tpu.ops.pallas_kernels import execution_waves_pallas
from accord_tpu.utils.random_source import RandomSource as JaxRandom
from accord_tpu_torch.ops import cuda_kernels, resolve_step
from accord_tpu_torch.ops.encode import window_to_tensors
from tests.test_ops import random_world as jax_random_world

STATE = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
         "entry_kind")
BATCH = ("txn_rank", "txn_witness_mask", "txn_kind", "touches")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain wavefront runs a dense matvec an iteration: one thread, so
    the cases do not crowd the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dag_case(name, n=96):
    """-> (dep [n, n] bool, txn_rank [n] int32)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties and padded rows":
        rank = rng.integers(-1, n // 3, n).astype(np.int32)
    else:
        rank = rng.permutation(n).astype(np.int32)
    dep = (rng.random((n, n)) < 0.1) & (rank[None, :] < rank[:, None]) \
        & (rank >= 0)[None, :] & (rank >= 0)[:, None]
    if name == "cycle":
        dep[np.argmin(rank), np.argmax(rank)] = True
    if name == "rows in rank order":
        order = np.argsort(rank, kind="stable")
        dep, rank = dep[order][:, order], rank[order]
    return dep, rank


@pytest.mark.parametrize("name", ["permuted ranks", "ties and padded rows",
                                  "cycle", "rows in rank order"])
def test_execution_waves_cuda_with_ranks_matches_pallas_interpret(name):
    dep, rank = _dag_case(name)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.execution_waves_cuda(torch.from_numpy(dep),
                                            torch.from_numpy(rank))
    want = np.asarray(execution_waves_pallas(dep, interpret=True))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, cuda_kernels.execution_waves_cuda(
        torch.from_numpy(dep)))
    assert cuda_kernels.WAVEFRONT.launches == 0
    assert (want == -1).any() == (name == "cycle")


def test_execution_waves_cuda_refuses_stats_on_cpu():
    dep, rank = _dag_case("permuted ranks", n=8)
    with pytest.raises(ValueError, match="counted by the kernel"):
        cuda_kernels.execution_waves_cuda(
            torch.from_numpy(dep), torch.from_numpy(rank),
            stats=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.execution_waves_cuda(torch.from_numpy(dep),
                                          torch.from_numpy(rank).to("meta"))


@pytest.mark.parametrize("seed", range(2))
def test_resolve_step_with_shuffled_window_matches_jax(seed):
    """A window whose rows are not in rank order (the batch shuffled before
    encoding): the port's step, which passes txn_rank to the wavefront, ==
    the JAX step on all four outputs."""
    cfks, batch = jax_random_world(JaxRandom(450 + seed), n_keys=16,
                                   n_existing=80, n_batch=40)
    perm = np.random.default_rng(seed).permutation(len(batch))
    je = JaxEncoder(cfks, [batch[i] for i in perm])
    args = tuple(getattr(je.state, f) for f in STATE) + \
        tuple(getattr(je.dbatch, f) for f in BATCH)
    assert (np.diff(je.dbatch.txn_rank[:len(batch)]) < 0).any()
    want = jax_resolve_step(*args)
    got = resolve_step(*window_to_tensors(args, None, "cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 0
