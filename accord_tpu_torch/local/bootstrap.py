"""Bootstrap: live acquisition of newly-owned ranges.

Reference: accord/local/Bootstrap.java:81-483 — each attempt fences the
ranges with an ExclusiveSyncPoint (everything ordered below it is frozen into
the source snapshot; everything above flows through normal replication to the
new owner), copies the data via the DataStore fetch protocol, then marks the
ranges safe to read and records `bootstrapped_at` in RedundantBefore so deps
below the fence are treated as already-satisfied locally.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.api.spi import DataStore
from accord_tpu_torch.coordinate.errors import Timeout
from accord_tpu_torch.coordinate.syncpoint import CoordinateSyncPoint, SyncPoint
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import TxnKind
from accord_tpu_torch.utils.async_chains import AsyncResult


class _AttemptFetchRanges(DataStore.FetchRanges):
    """Bootstrap's view of fetch progress (the FetchRanges callbacks of
    DataStore.java:74-99): accumulate fetched coverage as sub-ranges land so
    a later attempt only re-fetches what is still missing."""

    def __init__(self, attempt: "Bootstrap"):
        self.attempt = attempt

    def starting(self, ranges: Ranges):
        return None  # the default coordinator manages its own tokens

    def fetched(self, ranges: Ranges) -> None:
        self.attempt.covered = self.attempt.covered.union(ranges)

    def fail(self, ranges: Ranges, failure: BaseException) -> None:
        pass  # the attempt-level future failing drives the retry


class Bootstrap:
    """One bootstrap attempt chain for `ranges` (Bootstrap.Attempt): fence,
    then DataStore.fetch (the ranged FetchCoordinator with per-shard source
    failover), then the conflict-watermark fence and safe-to-read flip.
    Retries itself (fresh fence, missing ranges only) on failure — the
    reference defers the retry policy to Agent.onFailedBootstrap."""

    def __init__(self, node, ranges: Ranges, epoch: int,
                 result: Optional[AsyncResult] = None, attempt: int = 1):
        self.node = node
        self.RETRY_DELAY_S = node.config.bootstrap_retry_delay_s
        self.ranges = ranges
        self.epoch = epoch
        self.result = result if result is not None else AsyncResult()
        self.attempt = attempt
        self.max_retries = node.config.bootstrap_max_retries
        self.sp: Optional[SyncPoint] = None
        self.covered = Ranges.EMPTY
        self.fetch_result: Optional[DataStore.FetchResult] = None
        self.max_applied = None
        self.done = False

    def start(self) -> "Bootstrap":
        self.node.obs.flight.record("bootstrap_begin", None,
                                    (self.epoch, self.attempt))
        CoordinateSyncPoint.coordinate(
            self.node, TxnKind.EXCLUSIVE_SYNC_POINT, self.ranges,
            await_applied=False).add_callback(self._on_fence)
        return self

    def _retry(self) -> None:
        if self.done:
            return
        if self.attempt >= self.max_retries:
            # bounded: exhausting the budget fails the epoch-level result
            # (the caller's start_sync stays honest — no sync-complete
            # broadcast for data we never acquired)
            self.node.obs.flight.record(
                "bootstrap_done", None, (self.epoch, self.attempt, "failed"))
            self.result.try_failure(Timeout(
                f"bootstrap of {self.ranges.subtract(self.covered)!r} for "
                f"epoch {self.epoch} failed after {self.attempt} attempts"))
            return
        delay = min(self.RETRY_DELAY_S * (2 ** (self.attempt - 1)),
                    self.node.config.bootstrap_retry_delay_cap_s)
        self.node.scheduler.once(
            delay,
            lambda: Bootstrap(self.node, self.ranges.subtract(self.covered),
                              self.epoch, self.result,
                              attempt=self.attempt + 1).start()
            if not self.result.is_done else None)

    def abort(self, ranges: Ranges) -> None:
        """The ranges moved away under a newer topology: stop fetching them
        (FetchResult.abort passthrough)."""
        if self.fetch_result is not None:
            self.fetch_result.abort(ranges)

    # ------------------------------------------------------------- fence --
    def _on_fence(self, sp: Optional[SyncPoint], failure) -> None:
        if failure is not None:
            self._retry()
            return
        self.sp = sp
        self.fetch_result = self.node.data_store.fetch(
            self.node, None, self.ranges.subtract(self.covered), sp,
            _AttemptFetchRanges(self))
        self.fetch_result.add_callback(self._on_fetched)

    def _on_fetched(self, fetched: Optional[Ranges], failure) -> None:
        if self.done:
            return
        self.max_applied = getattr(self.fetch_result, "max_applied", None)
        if failure is not None:
            # finalize what DID land (watermarks + safe-to-read for the
            # covered sub-ranges — leaving them un-flipped would wedge reads
            # on data we installed), then retry the remainder under a fresh
            # fence
            self._retry()
            self.done = True
            if not self.covered.is_empty:
                self._fetch_max_conflict(complete=False)
            return
        self._finish()

    # ------------------------------------------------------------- finish --
    def _finish(self) -> None:
        if self.done:
            return
        self.done = True
        self._fetch_max_conflict(complete=True)

    def _fetch_max_conflict(self, complete: bool) -> None:
        """Before declaring ranges readable, learn the highest conflict any
        quorum witnessed for them (reference Bootstrap.java:234
        FetchMaxConflict): raising our HLC and MaxConflicts above it keeps
        every timestamp we mint for the new ranges after the handoff point.

        Always finalizes the FETCHED coverage only (self.covered): after a
        partial fetch the failed remainder is retried by a new attempt, and
        after an abort the dropped sub-ranges hold no data — flipping either
        safe-to-read would serve history we do not have."""
        from accord_tpu_torch.coordinate.fetch import fetch_max_conflict
        from accord_tpu_torch.primitives.keys import Route
        finalize = self.covered
        if finalize.is_empty:
            if complete:
                self.result.try_success(Ranges.EMPTY)
            return
        fetch_max_conflict(self.node, Route.probe(finalize),
                           finalize).add_callback(
            lambda mc, f: self._on_max_conflict(finalize, complete, mc, f))

    def _on_max_conflict(self, finalize: Ranges, complete: bool,
                         max_conflict, failure) -> None:
        if failure is not None:
            self.node.scheduler.once(
                self.RETRY_DELAY_S,
                lambda: self._fetch_max_conflict(complete))
            return
        from accord_tpu_torch.local import commands as C
        from accord_tpu_torch.local.store import PreLoadContext
        from accord_tpu_torch.primitives.timestamp import NONE as TS_NONE

        if self.max_applied is not None:
            # source-supplied bound (StartingRangeFetch.started(maxApplied)):
            # raise our clocks above everything the snapshot contains even if
            # the global probe raced below it
            self.node.on_remote_timestamp(self.max_applied)
        if max_conflict > TS_NONE:
            self.node.on_remote_timestamp(max_conflict)
        for store in self.node.command_stores.intersecting(finalize):
            owned = finalize.slice(store.ranges)
            if owned.is_empty:
                continue
            store.redundant_before.set_bootstrapped_at(owned, self.sp.txn_id)
            if max_conflict > TS_NONE:
                store.max_conflicts.update(owned, max_conflict)
            store.mark_safe_to_read(owned)
            # deps below the fence are now satisfied by the snapshot:
            # re-evaluate everything blocked on them
            store.execute(PreLoadContext.empty(), C.re_evaluate_waiting)
        self._journal_checkpoint(
            finalize, max_conflict if max_conflict > TS_NONE else None)
        if complete:
            self.node.obs.flight.record(
                "bootstrap_done", None, (self.epoch, self.attempt, "ok"))
            self.result.try_success(finalize)

    def _journal_checkpoint(self, finalize: Ranges, max_conflict) -> None:
        """WAL progress record for the finalized coverage: a crash after
        this point resumes from here (BootstrapCheckpoint replay reinstalls
        the snapshot + watermarks) instead of re-fetching the ranges."""
        node = self.node
        if node.journal is None or getattr(node, "replaying", False):
            return
        from accord_tpu_torch.messages.admin import BootstrapCheckpoint
        snapshot = node.data_store.snapshot_ranges(finalize) \
            if hasattr(node.data_store, "snapshot_ranges") else {}
        node.journal.record(node.id, BootstrapCheckpoint(
            self.epoch, self.sp.txn_id, finalize, snapshot,
            max_conflict=max_conflict, max_applied=self.max_applied))
        node.obs.flight.record(
            "bootstrap_checkpoint", None,
            (self.epoch, self.attempt, len(finalize)))
