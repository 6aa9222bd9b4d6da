"""Key-set conflict windows — the plain PyTorch versions.

The counterpart of the per-window body of ``bench.py::_tpcc_resolve_core``
and of the cross-window gather in ``_tpcc_stack_fn``: windows of write-only
transactions, each row a set of up to P integer keys (-1 = padding), resolved
against the last committed writer of every key (the watermark-pruned state
of the TPC-C new-order replay, ``accord_tpu_torch/tpcc.py``).

* ``shared_keys``: the [B, B] "shares a key" matrix by a P x P compare;
* ``keyset_windows``: per window, the in-window conflict edges (shared &
  earlier & both rows valid: every write witnesses every write) and the
  deepest execution wave.  It is the function of the Pallas kernel
  ``keyset_windows_pallas`` (``accord_tpu/ops/pallas_kernels.py``), the CPU
  path of ``ops/cuda_kernels.py::keyset_windows_cuda``, and the oracle the
  CUDA kernel (``csrc/keyset_windows.cu``) is held ``==`` to on the card;
* ``cross_window_deps``: the deps on earlier windows, one per touched key
  whose last writer is known.  In the JAX package it lies outside any Pallas
  kernel, so it stays plain torch on the card too.

Every output is an integer: the tolerance everywhere is exact equality.
"""

from __future__ import annotations

import torch

from accord_tpu_torch.ops.deps_kernel import conflict_edges
from accord_tpu_torch.ops.encode import witness_mask
from accord_tpu_torch.ops.wavefront import execution_waves
from accord_tpu_torch.primitives.timestamp import TxnKind

WRITE_WITNESS_MASK = witness_mask(TxnKind.WRITE)


def shared_keys(txn_keys: torch.Tensor) -> torch.Tensor:
    """txn_keys [B, P] int (-1 pad) -> shared [B, B] bool: rows r and c hold
    a common valid key.  One [B, B, P] compare per key slot of r, so no
    [B, P, B, P] intermediate is built."""
    valid = txn_keys >= 0
    b = txn_keys.shape[0]
    shared = torch.zeros((b, b), dtype=torch.bool, device=txn_keys.device)
    for i in range(txn_keys.shape[1]):
        hit = (txn_keys[:, i, None, None] == txn_keys[None, :, :]) \
            & valid[None, :, :]
        shared |= hit.any(dim=2) & valid[:, i, None]
    return shared


def window_edges(txn_keys: torch.Tensor,
                 txn_rank: torch.Tensor) -> torch.Tensor:
    """One window's conflict edges dep_bb [B, B] bool (b depends on b'),
    exactly as ``bench.py:962-964`` builds them: every row carries the
    witness mask of a write and kind 1, which a write witnesses, so the
    edges are shared & earlier & both rows valid."""
    wit = torch.full_like(txn_rank, WRITE_WITNESS_MASK)
    kind = torch.ones_like(txn_rank)
    return conflict_edges(shared_keys(txn_keys), txn_rank, wit, kind)


def keyset_windows(txn_keys: torch.Tensor, txn_rank: torch.Tensor):
    """txn_keys [W, B, P] int32 (-1 pad), txn_rank [W, B] int32 (-1 pad) ->
    (in_window_edges [W] int32, max_wave [W] int32), as
    ``keyset_windows_pallas`` computes them.  Windows are resolved one at a
    time: no [W, B, B] tensor is built."""
    w = txn_keys.shape[0]
    edges = torch.zeros(w, dtype=torch.int32, device=txn_keys.device)
    max_wave = torch.zeros(w, dtype=torch.int32, device=txn_keys.device)
    for wi in range(w):
        dep_bb = window_edges(txn_keys[wi], txn_rank[wi])
        edges[wi] = dep_bb.sum(dtype=torch.int32)
        max_wave[wi] = execution_waves(dep_bb).max()
    return edges, max_wave


def cross_window_deps(prevs: torch.Tensor,
                      txn_keys: torch.Tensor) -> torch.Tensor:
    """prevs [W, K] int32 (each window's last writer per key, -1 = none),
    txn_keys [W, B, P] -> the number of (txn, key) deps on earlier windows,
    a 0-dim int32 tensor (``bench.py:991-1000`` at reps = 1)."""
    w = txn_keys.shape[0]
    valid = txn_keys >= 0
    idx = txn_keys.clamp(min=0).reshape(w, -1).to(torch.int64)
    pw = torch.gather(prevs, 1, idx).reshape(txn_keys.shape)
    return ((pw >= 0) & valid).sum(dtype=torch.int32)
