"""The single-device resolve step.

The counterpart of ``accord_tpu/ops/sharded.py::resolve_step`` and, on CUDA
tensors, of ``pallas_kernels.resolve_step_pallas``: the deps tile (K1), the
in-window conflict graph, and the wavefront (K2) for one flush window.  The
mesh-sharded step of the JAX module is not ported yet.
"""

from __future__ import annotations

from accord_tpu_torch.ops.cuda_kernels import (batched_active_deps_cuda,
                                               execution_waves_cuda)
from accord_tpu_torch.ops.deps_kernel import in_batch_graph


def resolve_step(entry_rank, entry_eat_rank, entry_key, entry_status,
                 entry_kind, txn_rank, txn_witness_mask, txn_kind, touches):
    """deps + in-window graph + waves -> (dep_mask[B, E] bool,
    dep_count[B] i32, dep_bb[B, B] bool, waves[B] i32).

    On CUDA tensors the deps tile and the wavefront run as the hand-written
    kernels and the graph as one f32 matmul; on CPU tensors every step runs
    its plain PyTorch version.  The wavefront is given the ranks, whose
    order makes the graph's edges point backwards: its forward pass."""
    dep_mask, dep_count = batched_active_deps_cuda(
        entry_rank, entry_eat_rank, entry_key, entry_status, entry_kind,
        txn_rank, txn_witness_mask, touches)
    dep_bb = in_batch_graph(txn_rank, txn_witness_mask, txn_kind, touches)
    waves = execution_waves_cuda(dep_bb, txn_rank)
    return dep_mask, dep_count, dep_bb, waves
