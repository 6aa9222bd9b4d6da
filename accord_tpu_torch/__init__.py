"""accord_tpu_torch: the accord-tpu device tier in PyTorch, with hand-written
CUDA kernels for Hopper (H100).

The JAX package ``accord_tpu`` is the reference: this package imports none
of it (and never ``jax``), keeps its own copies of the host modules it needs,
and is held ``==`` to it by the tests.  It resolves one flush window — the
per-key conflict index plus a window of new transactions — into the
dependency mask, the in-window conflict graph and the execution waves
(``ops.sharded.resolve_step``); ``entry.entry`` is the flagship entry point.
The protocol store tier (``impl.device_store.DeviceCommandStore`` over
``local.store`` and the local state machine in ``local.commands``) serves
the protocol's deps, recovery and range queries from those kernels, one
flush window at a time.
"""
