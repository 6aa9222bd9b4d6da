"""Device tier of the port: the flush-window resolve step in PyTorch.

The host encodes one flush window into dense int32 ranks (ops/encode.py);
the device computes the [B, E] dependency mask (ops/deps_kernel.py), the
in-window conflict graph, and the execution waves (ops/wavefront.py), fused
in ops/sharded.py::resolve_step; ops/sharded.py also splits a window over
key-range shards (ShardedEncoder, make_sharded_step), stacked on one device
or one shard a rank of a torch.distributed group.  On the card the mask and the waves run as
hand-written CUDA kernels (ops/cuda_kernels.py, sources in csrc/); the plain
PyTorch versions are the CPU path and the oracle the kernels are held == to.
The TPC-C replay's key-set windows (ops/keyset.py) and the rangestress
lane's interval stab counts (ops/range_kernel.py) run the same way, each
with its own kernel on the card.  The batched recovery scans
(ops/recovery_kernel.py) lie outside Pallas in the JAX package and stay
plain PyTorch on either device.

The kernel wrappers are resolved lazily (PEP 562), as the JAX package
resolves its Pallas entry points.  Nothing is built on import: each kernel
is compiled at its first launch on a CUDA tensor.
"""

from accord_tpu_torch.ops.encode import (BatchEncoder, DeviceBatch,
                                         DeviceState, scalar_deps_oracle,
                                         window_to_tensors)
from accord_tpu_torch.ops.deps_kernel import (batched_active_deps,
                                              conflict_edges, in_batch_graph)
from accord_tpu_torch.ops.wavefront import execution_waves, waves_oracle
from accord_tpu_torch.ops.keyset import (cross_window_deps, keyset_windows,
                                         shared_keys)
from accord_tpu_torch.ops.sharded import (ShardedEncoder,
                                          make_sharded_deps_step,
                                          make_sharded_step, resolve_step)
from accord_tpu_torch.ops.range_kernel import (range_stab_counts,
                                               range_stab_mask,
                                               stab_counts_chunked)
from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                  batched_recovery_scans)

_KERNEL_EXPORTS = ("batched_active_deps_cuda", "deps_tile_cuda",
                   "execution_waves_cuda", "keyset_windows_cuda",
                   "range_stab_counts_cuda")

# the kernel names are deliberately NOT in __all__: a star-import resolves
# every __all__ entry and would defeat the lazy lookup below
__all__ = [
    "BatchEncoder", "DeviceState", "DeviceBatch", "scalar_deps_oracle",
    "window_to_tensors", "batched_active_deps", "conflict_edges",
    "in_batch_graph", "execution_waves", "waves_oracle", "resolve_step",
    "ShardedEncoder", "make_sharded_step", "make_sharded_deps_step",
    "shared_keys", "keyset_windows", "cross_window_deps",
    "range_stab_counts", "range_stab_mask", "stab_counts_chunked",
    "RecoveryEncoder", "batched_recovery_scans",
]


def __getattr__(name):
    if name in _KERNEL_EXPORTS:
        from accord_tpu_torch.ops import cuda_kernels
        return getattr(cuda_kernels, name)
    raise AttributeError(name)
