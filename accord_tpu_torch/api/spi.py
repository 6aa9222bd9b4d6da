"""Host integration interfaces (reference: accord/api/*.java — SURVEY.md §2.1)."""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Callable, Optional

from accord_tpu_torch.utils.async_chains import AsyncResult

if TYPE_CHECKING:
    from accord_tpu_torch.primitives.keys import Ranges
    from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
    from accord_tpu_torch.primitives.txn import Txn


class Agent(abc.ABC):
    """Host callback facade (reference api/Agent.java:51-119)."""

    def on_recover(self, node, success, fail) -> None:
        """Outcome of a locally-initiated recovery."""

    def on_inconsistent_timestamp(self, command, prev: "Timestamp",
                                  next_: "Timestamp") -> None:
        raise AssertionError(
            f"inconsistent timestamp: {prev} vs {next_} for {command}")

    def on_failed_bootstrap(self, phase: str, ranges: "Ranges",
                            retry: Callable[[], None], failure: BaseException) -> None:
        retry()

    def on_stale(self, stale_since: "Timestamp", ranges: "Ranges") -> None:
        """Replica has missed GC'd history for `ranges` and must re-bootstrap."""

    @abc.abstractmethod
    def on_uncaught_exception(self, failure: BaseException) -> None:
        ...

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def pre_accept_timeout(self) -> float:
        """Seconds a coordinator waits for PreAccept before invalidating."""
        return 1.0

    def expires_at(self, now: float) -> float:
        return now + self.pre_accept_timeout()

    @abc.abstractmethod
    def empty_txn(self, kind, keys_or_ranges) -> "Txn":
        """Factory for deps-only txns (sync points, bootstrap markers)."""

    def metrics_listener(self) -> "EventsListener":
        return EventsListener()


class MessageSink(abc.ABC):
    """Outbound network port (reference api/MessageSink.java:46-52)."""

    @abc.abstractmethod
    def send(self, to: int, request) -> None:
        ...

    @abc.abstractmethod
    def send_with_callback(self, to: int, request, callback, executor=None) -> None:
        """Register `callback` (Callback protocol: on_success/on_failure/
        on_callback_failure) for the reply; executor pins delivery thread
        affinity (a CommandStore in the reference)."""

    @abc.abstractmethod
    def reply(self, to: int, reply_context, reply) -> None:
        ...


class CallbackSink(MessageSink):
    """msg-id/callback bookkeeping shared by concrete sinks (sim NodeSink,
    host MaelstromSink). Entries are released BOTH on reply delivery and on
    RPC timeout — registration installs an unregister hook the node's safe
    callback fires when its timer expires, so a long-lived host under
    partitions does not pin dead coordination state forever.

    Also carries the ingest pipeline's coalescing-window machinery
    (accord_tpu_torch/pipeline/): between `batch_begin()` and `batch_flush()`,
    concrete sinks route every outbound request through `_capture` instead
    of the transport; the flush then emits ONE MultiPreAccept envelope per
    destination (single-request groups go out unwrapped via the sink's
    `_send_prepared`).  Windows nest (a batch dispatch inside a host loop
    tick): only the outermost flush actually sends."""

    def __init__(self):
        self._seq = 0
        self._callbacks: dict = {}
        self._batch: dict = None      # dest -> [(reply_context, request)]
        self._batch_depth = 0

    def _register(self, callback) -> int:
        self._seq += 1
        msg_id = self._seq
        self._callbacks[msg_id] = callback
        try:
            callback.sink_unregister = (
                lambda: self._callbacks.pop(msg_id, None))
        except AttributeError:
            pass  # slotted callbacks just stay until delivery
        return msg_id

    def deliver_reply(self, msg_id: int, from_id: int, reply) -> None:
        callback = self._callbacks.pop(msg_id, None)
        if callback is not None:
            callback.deliver(reply)

    # ------------------------------------------------- coalescing windows --
    def batch_begin(self) -> None:
        """Open (or deepen) a coalescing window: outbound requests are
        captured per destination until the matching batch_flush."""
        if self._batch_depth == 0:
            self._batch = {}
        self._batch_depth += 1

    def batch_flush(self) -> None:
        """Close one window level; on closing the outermost level, emit one
        envelope per destination (unwrapped when a group holds a single
        request — no reason to pay envelope framing for a lone message)."""
        if self._batch_depth == 0:
            return
        self._batch_depth -= 1
        if self._batch_depth > 0:
            return
        groups, self._batch = self._batch, None
        if not groups:
            return
        from accord_tpu_torch.messages.multi import MultiPreAccept
        for to, parts in groups.items():
            if len(parts) == 1:
                self._send_prepared(to, parts[0][0], parts[0][1])
            else:
                self.send(to, MultiPreAccept(parts))

    def _capture(self, to: int, reply_context, request) -> bool:
        """Concrete sinks call this first in send/send_with_callback; True
        means the request was captured into the open window (the callback,
        if any, is already registered — `reply_context` is its transport
        token) and must not be sent now."""
        if self._batch is None:
            return False
        self._batch.setdefault(to, []).append((reply_context, request))
        return True

    def _send_prepared(self, to: int, reply_context, request) -> None:
        """Transport-specific raw send of a request whose callback (when
        present) is ALREADY registered under `reply_context`.  Concrete
        sinks override; the fallback wraps in a single-part envelope, which
        is always correct."""
        from accord_tpu_torch.messages.multi import MultiPreAccept
        self.send(to, MultiPreAccept([(reply_context, request)]))


class EpochReady:
    """Four-phase epoch readiness (reference api/ConfigurationService.EpochReady):
    metadata -> coordination -> data -> reads, each an AsyncResult."""

    __slots__ = ("epoch", "metadata", "coordination", "data", "reads")

    def __init__(self, epoch: int, metadata: AsyncResult = None,
                 coordination: AsyncResult = None, data: AsyncResult = None,
                 reads: AsyncResult = None):
        from accord_tpu_torch.utils.async_chains import success
        self.epoch = epoch
        self.metadata = metadata or success()
        self.coordination = coordination or success()
        self.data = data or success()
        self.reads = reads or success()

    @classmethod
    def done(cls, epoch: int) -> "EpochReady":
        return cls(epoch)


class ConfigurationService(abc.ABC):
    """Epoch/topology feed (reference api/ConfigurationService.java)."""

    @abc.abstractmethod
    def current_topology(self):
        ...

    @abc.abstractmethod
    def get_topology_for_epoch(self, epoch: int):
        ...

    @abc.abstractmethod
    def fetch_topology_for_epoch(self, epoch: int) -> None:
        """Ask the host to fetch an unknown epoch; listeners fire on arrival."""

    @abc.abstractmethod
    def acknowledge_epoch(self, ready: EpochReady, start_sync: bool = True) -> None:
        ...

    @abc.abstractmethod
    def register_listener(self, listener) -> None:
        """listener.on_topology_update(topology, start_sync) -> AsyncResult"""


class DataStore(abc.ABC):
    """Storage port incl. the bootstrap fetch protocol
    (reference api/DataStore.java:39-113)."""

    class FetchResult(AsyncResult):
        """AsyncResult[Ranges] of successfully fetched ranges;
        abort(ranges) asks the implementation to stop fetching ranges that
        stopped mattering (DataStore.FetchResult, DataStore.java:103-113)."""

        abort_hook = None  # set by the driving coordinator

        def abort(self, ranges: "Ranges") -> None:
            if self.abort_hook is not None:
                self.abort_hook(ranges)

    class FetchRanges(abc.ABC):
        """Callbacks the fetch implementation invokes as ranges progress
        (DataStore.FetchRanges, DataStore.java:74-99): `starting` when a
        source is contacted (its token's `started(max_applied)` fires on
        snapshot confirmation and returns an abort handle), `fetched` as
        sub-ranges land (repeatable, any subdivision), `fail` when a
        sub-range exhausted its sources."""

        @abc.abstractmethod
        def starting(self, ranges: "Ranges"):
            """Returns a StartingRangeFetch token with started()/cancel()."""

        @abc.abstractmethod
        def fetched(self, ranges: "Ranges") -> None:
            ...

        @abc.abstractmethod
        def fail(self, ranges: "Ranges", failure: BaseException) -> None:
            ...

    def fetch(self, node, safe_store, ranges: "Ranges", sync_point,
              fetch_ranges: "DataStore.FetchRanges") -> "DataStore.FetchResult":
        """Copy `ranges` from peers up to `sync_point` (the bootstrap fence).
        Default: the generic ranged FetchCoordinator over the FetchSnapshot
        wire protocol with per-shard source failover — stores with bespoke
        movement (file streaming, object storage) override."""
        from accord_tpu_torch.impl.fetch_coordinator import FetchCoordinator
        return FetchCoordinator(node, ranges, sync_point, fetch_ranges,
                                self).start().result

    # -- snapshot transfer primitives (bootstrap; DataStore.java fetch
    #    implementations move data in host-defined snapshot units) --
    def snapshot_ranges(self, ranges: "Ranges"):
        """Opaque snapshot of everything stored within `ranges`."""
        raise NotImplementedError

    def install_snapshot(self, snapshot) -> None:
        """Merge a peer's snapshot (idempotent; newest-write wins per key)."""
        raise NotImplementedError


class ProgressLog(abc.ABC):
    """Per-CommandStore liveness driver (reference api/ProgressLog.java:30-59).

    The local state machine notifies phase entry/exit; the implementation owns
    timeouts and escalates to recovery (accord_tpu_torch.impl.progress_log)."""

    def update(self, store, txn_id: "TxnId", command) -> None:
        """Command state changed."""

    def waiting(self, blocked_by: "TxnId", store, blocked_until: str,
                route, participants) -> None:
        """A local command is blocked on `blocked_by` reaching `blocked_until`
        ('HasRoute'|'Committed'|'Applied')."""

    def durable(self, command) -> None:
        ...

    def clear(self, txn_id: "TxnId") -> None:
        ...


class Scheduler(abc.ABC):
    """Timer port (reference api/Scheduler.java:26-59)."""

    class Scheduled:
        def cancel(self) -> None:  # pragma: no cover - interface default
            ...

    @abc.abstractmethod
    def once(self, delay_s: float, fn: Callable[[], None]) -> "Scheduler.Scheduled":
        ...

    @abc.abstractmethod
    def recurring(self, delay_s: float, fn: Callable[[], None]) -> "Scheduler.Scheduled":
        ...

    @abc.abstractmethod
    def now(self, fn: Callable[[], None]) -> None:
        ...


class TopologySorter(abc.ABC):
    """Replica contact-preference ordering (reference api/TopologySorter.java)."""

    @abc.abstractmethod
    def compare(self, a: int, b: int, shards) -> int:
        ...

    def sort(self, nodes, shards) -> list:
        import functools
        return sorted(nodes, key=functools.cmp_to_key(
            lambda a, b: self.compare(a, b, shards)))


class EventsListener:
    """Metric hooks (reference api/EventsListener.java:28-68). All optional."""

    def on_committed(self, command) -> None: ...
    def on_stable(self, command) -> None: ...
    def on_executed(self, command) -> None: ...
    def on_applied(self, command, apply_start_ns: int = 0) -> None: ...
    def on_fast_path_taken(self, txn_id, deps=None) -> None: ...
    def on_slow_path_taken(self, txn_id, deps=None) -> None: ...
    def on_recover(self, txn_id, outcome=None) -> None: ...
    def on_preempted(self, txn_id) -> None: ...
    def on_timeout(self, txn_id) -> None: ...
    def on_invalidated(self, txn_id) -> None: ...
    def on_progress_log_size_change(self, txn_id, delta: int) -> None: ...


class LocalConfig:
    """Tunables (reference config/LocalConfig.java:23-30)."""

    progress_log_schedule_delay_s: float = 0.2
    epoch_await_timeout_s: float = 30.0
    command_store_shard_count: int = 8
    # RPC reply timeout = agent.pre_accept_timeout() * this
    rpc_timeout_multiplier: float = 10.0
    # recovery/invalidation futures are force-failed after
    # rpc_timeout * this of INACTIVITY (the deadline re-arms on observable
    # progress — replies received; see Node._arm_coordination_watchdog)
    coordination_watchdog_multiplier: float = 6.0
    # ...but never live longer than watchdog_timeout * this overall, so a
    # livelocked-but-chatty coordination still fails in bounded time
    coordination_watchdog_hard_cap_multiplier: float = 10.0
    bootstrap_retry_delay_s: float = 1.0
    # bootstrap robustness (local/bootstrap.py, impl/fetch_coordinator.py):
    # per-source snapshot-fetch timeout, bounded attempt count with
    # exponential backoff (delay = retry_delay * 2^(attempt-1), capped)
    bootstrap_fetch_timeout_s: float = 10.0
    bootstrap_max_retries: int = 8
    bootstrap_retry_delay_cap_s: float = 30.0
    durability_shard_cycle_s: float = 30.0
    durability_global_cycle_every: int = 4

    @classmethod
    def default(cls) -> "LocalConfig":
        """Defaults with the host env knobs applied
        (ACCORD_BOOTSTRAP_TIMEOUT_US / ACCORD_BOOTSTRAP_RETRIES)."""
        import os
        cfg = cls()
        try:
            us = int(os.environ.get("ACCORD_BOOTSTRAP_TIMEOUT_US", "0"))
            if us > 0:
                cfg.bootstrap_fetch_timeout_s = us / 1e6
        except ValueError:
            pass
        try:
            retries = int(os.environ.get("ACCORD_BOOTSTRAP_RETRIES", "0"))
            if retries > 0:
                cfg.bootstrap_max_retries = retries
        except ValueError:
            pass
        return cfg
