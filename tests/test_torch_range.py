"""The port's interval stabbing against the JAX package, on the CPU.

``range_stab_counts``, ``range_stab_mask`` and ``stab_counts_chunked`` on
seeded int32 intervals and queries: negatives, [0, 0) pads, touching bounds,
bounds at -2**31 and 2**31-1, and a ragged tail chunk (whose padded [0, 0)
queries must count as the JAX package counts them).  The rangestress lane's
total at a reduced size against a count by sorting.  K5's algorithm in
plain torch (``stab_counts_by_query_index``) on those inputs and on
``workload.range_index_cases``: inverted intervals and queries, [0, 0)
pads against [0, 0) queries, tied bounds, one hot bin, several query
tiles, N = 0, Q = 1, N = 1.  Tolerance: ==.
"""

import numpy as np
import pytest
import torch

from accord_tpu.ops import range_kernel as jax_range
from accord_tpu_torch import workload
from accord_tpu_torch.ops import cuda_kernels, range_kernel

# workload.range_cases, but the 70,001 x 4099 one, which is for the card
CASES = (0, 2, 3, 4, 5)


def _case(i):
    return workload.range_cases()[i]


@pytest.mark.parametrize("case", CASES)
def test_range_functions_match_jax(case):
    label, s, e, qs, qe = _case(case)
    t = [torch.from_numpy(a) for a in (s, e, qs, qe)]
    want_counts = np.asarray(jax_range.range_stab_counts(s, e, qs, qe))
    got_counts = range_kernel.range_stab_counts(*t)
    assert got_counts.dtype == torch.int32
    assert np.array_equal(got_counts.numpy(), want_counts), label
    assert np.array_equal(range_kernel.range_stab_mask(*t).numpy(),
                          np.asarray(jax_range.range_stab_mask(s, e, qs, qe)))
    # numpy intervals and queries, and intervals already on the device
    for starts, ends in ((s, e), (t[0], t[1])):
        got = range_kernel.stab_counts_chunked(starts, ends, qs, qe,
                                               chunk=256, device="cpu")
        want = jax_range.stab_counts_chunked(s, e, qs, qe, chunk=256)
        assert len(got) == len(want)
        for g, w in zip(got, want):   # the padded tail included
            assert np.array_equal(g.numpy(), np.asarray(w)), label
    if label == "[0, 0) pads":
        # a [0, 0) interval is hit by qs < 0 < qe; a [0, 0) query hits
        # s < 0 < e: the half-open semantics, not "fixed"
        pads = (s == 0) & (e == 0)
        hits_pad = (qs < 0) & (qe > 0)
        assert (got_counts.numpy()[hits_pad] >= pads.sum()).all()
        zero_q = (qs == 0) & (qe == 0)
        assert (got_counts.numpy()[zero_q] == ((s < 0) & (e > 0)).sum()).all()


def test_range_stab_counts_cuda_takes_plain_on_cpu():
    """On CPU tensors K5's wrapper runs the plain version and launches
    nothing."""
    _, s, e, qs, qe = _case(0)
    t = [torch.from_numpy(a) for a in (s, e, qs, qe)]
    before = cuda_kernels.RANGE_STAB.launches
    got = cuda_kernels.range_stab_counts_cuda(*t)
    assert cuda_kernels.RANGE_STAB.launches == before
    assert torch.equal(got, range_kernel.range_stab_counts(*t))


@pytest.mark.parametrize("cases,case", [("range", i) for i in CASES]
                         + [("index", i) for i in range(10)])
def test_stab_counts_by_query_index_matches_jax(cases, case):
    """The query index's identity, count = F + C, with its tie conventions
    (#{qe <= s}, #{qs < e}) and its two correction sets, == the JAX
    package's dense count; the dense plain version too."""
    label, s, e, qs, qe = (workload.range_cases() if cases == "range"
                           else workload.range_index_cases())[case]
    t = [torch.from_numpy(a) for a in (s, e, qs, qe)]
    want = np.asarray(jax_range.range_stab_counts(s, e, qs, qe))
    got = range_kernel.stab_counts_by_query_index(*t)
    assert got.dtype == torch.int32 and got.shape == (len(qs),)
    assert np.array_equal(got.numpy(), want), label
    assert np.array_equal(range_kernel.range_stab_counts(*t).numpy(),
                          want), label


def test_range_stab_cuda_wrappers_on_cpu_launch_nothing():
    """On every index case's CPU tensors K5's wrapper runs the plain version
    and launches nothing; its phase timer takes CUDA tensors only."""
    before = cuda_kernels.RANGE_STAB.launches
    for label, *arrays in workload.range_index_cases():
        t = [torch.from_numpy(a) for a in arrays]
        assert torch.equal(cuda_kernels.range_stab_counts_cuda(*t),
                           range_kernel.range_stab_counts(*t)), label
    assert cuda_kernels.RANGE_STAB.launches == before
    with pytest.raises(ValueError):
        cuda_kernels.range_stab_phases(*t)
    assert cuda_kernels.RANGE_STAB.launches == before


def test_rangestress_inputs_match_bench_and_sorting():
    """The lane's draws at a reduced size: the chunked plain counts == the
    count by sorting, query by query, and the host sample check of
    bench.py:491-498 holds."""
    s, e, qs, qe, sample = workload.rangestress_inputs(n_ranges=20_000,
                                                       n_txns=700)
    rng = np.random.default_rng(42)
    assert np.array_equal(s, rng.integers(0, 999_000_000, 20_000))
    got = torch.cat(range_kernel.stab_counts_chunked(s, e, qs, qe,
                                                     device="cpu"))[:700]
    want = range_kernel.stab_counts_sorted(s, e, qs, qe)
    assert np.array_equal(got.numpy(), want) and want.sum() > 0
    for qi in sample:
        assert got[qi] == np.count_nonzero((s < qe[qi]) & (e > qs[qi]))
