"""Delayed command stores: the storage/executor nemesis.

Reference: accord-core test impl/basic/DelayedCommandStores.java:61-175 —
every store task goes through a simulated single-threaded executor with
randomized delays, plus a random isLoadedCheck that models async cache-miss
page-in of the PreLoadContext. Exercises every path that assumes store
operations complete inline: callbacks must tolerate arbitrary interleaving
of store execution with message delivery and timer events.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from accord_tpu_torch.local.store import CommandStore, PreLoadContext
from accord_tpu_torch.utils.random_source import RandomSource


class DelayedCommandStore(CommandStore):
    """CommandStore whose tasks run on a simulated executor: submissions
    queue; each drains after a randomized delay, sequentially (the store
    stays logically single-threaded — delays reorder store work relative to
    network/timer events, never relative to other tasks on the same store).

    `miss_prob` adds an extra page-in delay to a task whose PreLoadContext
    names commands/keys, modelling the async cache-miss path."""

    def __init__(self, store_id: int, node, ranges, *,
                 random: RandomSource,
                 min_delay_us: int = 50, max_delay_us: int = 2_000,
                 miss_prob: float = 0.2, miss_delay_us: int = 5_000,
                 **base_kw):
        # **base_kw flows to the next class in the MRO so the delay nemesis
        # composes over richer store tiers (device/mesh flush-window stores)
        super().__init__(store_id, node, ranges, **base_kw)
        self.random = random
        self.min_delay_us = min_delay_us
        self.max_delay_us = max_delay_us
        self.miss_prob = miss_prob
        self.miss_delay_us = miss_delay_us
        self._tasks = deque()
        self._draining = False
        self.tasks_run = 0
        self.misses_simulated = 0

    @classmethod
    def factory(cls, random: RandomSource, **kw):
        """One forked RandomSource per store keeps runs seed-deterministic."""
        return lambda i, node, ranges: cls(i, node, ranges,
                                           random=random.fork(), **kw)

    def _submit(self, context: PreLoadContext, fn, result) -> None:
        self._tasks.append((context, fn, result))
        if not self._draining:
            self._draining = True
            self._schedule_next()

    def _task_delay(self, context: PreLoadContext) -> int:
        delay = self.random.next_int(self.min_delay_us, self.max_delay_us)
        if (context.txn_ids or len(context.keys) > 0) \
                and self.random.next_float() < self.miss_prob:
            # async cache miss: the store must page the context in first
            self.misses_simulated += 1
            delay += self.random.next_int(1, self.miss_delay_us)
        return delay

    def _schedule_next(self) -> None:
        context = self._tasks[0][0]
        self.node.scheduler.once(self._task_delay(context) / 1e6, self._drain_one)

    def _drain_one(self) -> None:
        context, fn, result = self._tasks.popleft()
        self.tasks_run += 1
        try:
            super()._submit(context, fn, result)
        finally:
            if self._tasks:
                self._schedule_next()
            else:
                self._draining = False


def _device_bases():
    # lazy: pulls the torch device tier only when a device-tier burn
    # actually asks for the composition
    from accord_tpu_torch.impl.device_store import (DeviceCommandStore,
                                                    MeshDeviceCommandStore)
    return DeviceCommandStore, MeshDeviceCommandStore


def delayed_device_factory(random: RandomSource, *, mesh_store: bool = False,
                           flush_window_us: int = 0, verify: bool = False,
                           device=None, devices=None):
    """Store factory composing the delayed-executor nemesis over the batched
    device tier (reference analogue: DelayedCommandStores.java:61-175
    wrapping the real store): tasks queue on the simulated delayed executor
    with randomized delays + cache-miss page-ins, then drain into the device
    store's flush window, exercising the batch path under storage-latency
    chaos.  `mesh_store` selects the key-range-sharded tier, its shards
    stacked on `device` (None: the CUDA card, raising without one) or,
    with `devices` (a list, or "all"), spread over those cards in blocks
    of S/D shards."""
    if devices is not None and not mesh_store:
        raise ValueError("devices= spreads the mesh store's shards: pass "
                         "mesh_store=True")
    DeviceCommandStore, MeshDeviceCommandStore = _device_bases()

    class DelayedDeviceCommandStore(DelayedCommandStore, DeviceCommandStore):
        pass

    class DelayedMeshDeviceCommandStore(DelayedCommandStore,
                                        MeshDeviceCommandStore):
        pass

    cls = (DelayedMeshDeviceCommandStore if mesh_store
           else DelayedDeviceCommandStore)
    spread = {} if devices is None else {"devices": devices}
    return lambda i, node, ranges: cls(
        i, node, ranges, random=random.fork(),
        flush_window_us=flush_window_us, verify=verify, device=device,
        **spread)
