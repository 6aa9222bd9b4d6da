"""Batched interval stabbing: the device tier's RangeDeps search, in PyTorch.

The counterpart of ``accord_tpu/ops/range_kernel.py``.  The reference answers
"which range transactions intersect this range?" with CINTIA checkpoint lists
(accord/utils/CheckpointIntervalArrayBuilder.java, searched by
RangeDeps.forEach).  The device form is a dense broadcast compare: interval
[s, e) and query [qs, qe) intersect iff s < qe and e > qs, so a window of Q
queries against N intervals is one [Q, N] compare-and-reduce.

These are the plain versions.  In JAX, XLA fuses the count so the [Q, N]
tile never reaches memory; plain PyTorch materialises it, so on the card the
counts run in a hand-written kernel instead (K5, ``csrc/range_stab.cu``,
wrapper ``ops/cuda_kernels.py::range_stab_counts_cuda``), and
``stab_counts_chunked`` bounds the tile of the plain version.
``range_stab_mask`` writes its [Q, N] output anyway and stays plain torch
on either device.  ``stab_counts_by_query_index`` mirrors K5's algorithm
(index the queries, stream the intervals once, correct pairwise) in plain
torch, so its identity and tie conventions are checked on the CPU.

Half-open semantics on both sides, pads included, exactly as the JAX
package computes them: a [0, 0) interval is hit by a query with
qs < 0 < qe, and a [0, 0) query hits an interval with s < 0 < e.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from accord_tpu_torch.utils.backend import resolve_device


def range_stab_counts(starts: torch.Tensor, ends: torch.Tensor,
                      q_starts: torch.Tensor,
                      q_ends: torch.Tensor) -> torch.Tensor:
    """[N] interval bounds x [Q] query bounds (int32) -> [Q] int32 intersect
    counts."""
    hit = (starts[None, :] < q_ends[:, None]) \
        & (ends[None, :] > q_starts[:, None])
    return hit.sum(dim=1, dtype=torch.int32)


def range_stab_mask(starts: torch.Tensor, ends: torch.Tensor,
                    q_starts: torch.Tensor,
                    q_ends: torch.Tensor) -> torch.Tensor:
    """[Q, N] bool intersect mask, for windows small enough to decode into
    per-txn dependency lists."""
    return (starts[None, :] < q_ends[:, None]) \
        & (ends[None, :] > q_starts[:, None])


def _int32_on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def stab_counts_chunked(starts, ends, q_starts, q_ends, chunk: int = 256,
                        device=None) -> List[torch.Tensor]:
    """Counts for all queries with the plain version, chunked over the query
    axis -> a list of int32 [chunk] tensors (concatenate at the caller; the
    last is padded).  Every argument may be a numpy array or a tensor.  The
    intervals are moved to the device at most once: tensors already there
    are used as they are.  The device is that of `starts` when it is a
    tensor, else `device` (None means the CUDA card).  The tail chunk is
    padded with [0, 0) queries so every chunk has one shape."""
    dev = starts.device if isinstance(starts, torch.Tensor) \
        else resolve_device(device)
    s, e = _int32_on(starts, dev), _int32_on(ends, dev)
    qs_all, qe_all = _int32_on(q_starts, dev), _int32_on(q_ends, dev)
    out = []
    for i in range(0, qs_all.shape[0], chunk):
        qs, qe = qs_all[i:i + chunk], qe_all[i:i + chunk]
        if qs.shape[0] < chunk:  # pad the tail so every chunk shares a shape
            pad = torch.zeros(chunk - qs.shape[0], dtype=torch.int32,
                              device=dev)
            qs, qe = torch.cat([qs, pad]), torch.cat([qe, pad])
        out.append(range_stab_counts(s, e, qs, qe))
    return out


def stab_counts_sorted(starts: np.ndarray, ends: np.ndarray,
                       q_starts: np.ndarray, q_ends: np.ndarray) -> np.ndarray:
    """The counts by sorting, independent of the dense formulation, for
    intervals and queries with start < end -> int64 [Q]:
    N - #{s >= qe} - #{e <= qs} (no interval has both when s < e and
    qs < qe)."""
    starts, ends = np.asarray(starts), np.asarray(ends)
    q_starts, q_ends = np.asarray(q_starts), np.asarray(q_ends)
    if (starts >= ends).any() or (q_starts >= q_ends).any():
        raise ValueError("stab_counts_sorted takes non-empty intervals and "
                         "queries only")
    s_sorted, e_sorted = np.sort(starts), np.sort(ends)
    n = len(starts)
    at_or_after = n - np.searchsorted(s_sorted, q_ends, side="left")
    at_or_before = np.searchsorted(e_sorted, q_starts, side="right")
    return n - at_or_after - at_or_before


_TILE_ELEMS = 1 << 26   # the dense correction's [chunk, N] tile, at most


def _pairs_outside(starts: torch.Tensor, ends: torch.Tensor,
                   q_starts: torch.Tensor,
                   q_ends: torch.Tensor) -> torch.Tensor:
    """[Q] int64: #{i : s[i] >= qe and e[i] <= qs}, by the dense compare,
    in chunks of queries whose [chunk, N] tile holds at most _TILE_ELEMS."""
    chunk = max(1, _TILE_ELEMS // max(1, starts.shape[0]))
    return torch.cat([
        ((starts[None, :] >= q_ends[i:i + chunk, None])
         & (ends[None, :] <= q_starts[i:i + chunk, None])).sum(dim=1)
        for i in range(0, q_starts.shape[0], chunk)])


def stab_counts_by_query_index(starts: torch.Tensor, ends: torch.Tensor,
                               q_starts: torch.Tensor,
                               q_ends: torch.Tensor) -> torch.Tensor:
    """``range_stab_counts`` by K5's algorithm, in plain torch on either
    device: [N] interval bounds x [Q] query bounds (int32) -> [Q] int32.

    count(q) = F(q) + C(q), with
      F(q) = #{s < qe} - #{e <= qs}, from the sorted query bounds: each
             interval's position among them (#{qe <= s}, #{qs < e}) is one
             histogram bin, and a prefix sum over the bins is the count at
             every query, tied bounds alike;
      C(q) = #{s >= qe and e <= qs}, the pairs F counts wrongly.  With
             qs <= qe such a pair has e <= qs <= qe <= s, so only the
             intervals with s >= e (inverted, or empty like the [0, 0)
             pads) take part; an inverted query (qs > qe) is tested against
             every interval.  Both by the dense compare, on those sets only.
    """
    n, q = starts.shape[0], q_starts.shape[0]
    out = torch.zeros(q, dtype=torch.int64, device=q_starts.device)
    if n == 0 or q == 0:
        return out.to(torch.int32)
    qe_sorted, qe_order = torch.sort(q_ends)
    qs_sorted, qs_order = torch.sort(q_starts)
    at_a = torch.searchsorted(qe_sorted, starts, right=True)   # #{qe <= s}
    at_b = torch.searchsorted(qs_sorted, ends, right=False)    # #{qs < e}
    # bin q (the past-the-end bin never reaches a query's prefix sum)
    below_qe = torch.bincount(at_a, minlength=q + 1)[:q].cumsum(0)
    at_or_below_qs = torch.bincount(at_b, minlength=q + 1)[:q].cumsum(0)
    out[qe_order] += below_qe
    out[qs_order] -= at_or_below_qs
    upright = q_starts <= q_ends
    bad = starts >= ends
    if bad.any() and upright.any():
        out[upright] += _pairs_outside(starts[bad], ends[bad],
                                       q_starts[upright], q_ends[upright])
    if not upright.all():
        out[~upright] += _pairs_outside(starts, ends, q_starts[~upright],
                                        q_ends[~upright])
    return out.to(torch.int32)
