"""FetchCoordinator: the ranged bootstrap-fetch engine behind DataStore.fetch.

Reference: accord/impl/AbstractFetchCoordinator.java driving FETCH_DATA_REQ,
against the api/DataStore.java:39-113 callback contract — per-range
progress (`FetchRanges.starting/fetched/fail`), source confirmation with an
optional max-applied bound (`StartingRangeFetch.started(maxApplied)`),
cancellation tokens (`AbortFetch`), and a `FetchResult` future that can
abort sub-ranges that stopped mattering (e.g. the topology moved them away
mid-bootstrap).

Shape of the protocol here: one FetchSnapshot request per (source, sub-range);
the source replies after the fence ExclusiveSyncPoint applied locally, with a
snapshot and its max applied executeAt for the covered keys.  Failed or
partial sub-ranges fail over to the next replica of their shard; when every
replica of a shard has been tried unsuccessfully the sub-range is reported
via `FetchRanges.fail` and the attempt's future fails (the caller — Bootstrap
— schedules a fresh attempt, reference Agent.onFailedBootstrap)."""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from accord_tpu_torch.api.spi import DataStore
from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.epoch import FetchSnapshot, FetchSnapshotOk
from accord_tpu_torch.primitives.keys import Ranges


class _Starting:
    """StartingRangeFetch token (DataStore.java:41-61): created when we
    contact a source; `started(max_applied)` hands back an abort handle once
    the source confirmed its snapshot.  Forwards to the caller's own token
    (the return of FetchRanges.starting) so custom FetchRanges
    implementations observe per-source confirmation too."""

    __slots__ = ("coordinator", "ranges", "source", "aborted", "caller_token")

    def __init__(self, coordinator: "FetchCoordinator", ranges: Ranges,
                 source: int, caller_token=None):
        self.coordinator = coordinator
        self.ranges = ranges
        self.source = source
        self.aborted = False
        self.caller_token = caller_token

    def started(self, max_applied=None) -> "_Starting":
        if max_applied is not None:
            self.coordinator._observe_max_applied(max_applied)
        if self.caller_token is not None:
            self.caller_token.started(max_applied)
        return self  # the AbortFetch handle

    def cancel(self) -> None:
        """Abort before any data moved."""
        self.aborted = True
        if self.caller_token is not None:
            self.caller_token.cancel()

    def abort(self) -> None:
        """Abort after data may have moved (AbortFetch.abort)."""
        self.aborted = True
        if self.caller_token is not None \
                and hasattr(self.caller_token, "abort"):
            self.caller_token.abort()


class FetchCoordinator(Callback):
    def __init__(self, node, ranges: Ranges, sync_point, fetch_ranges,
                 data_store, timeout_s: Optional[float] = None):
        self.node = node
        self.ranges = ranges
        self.sync_point = sync_point
        self.fetch_ranges = fetch_ranges  # DataStore.FetchRanges callbacks
        self.data_store = data_store
        # per-source snapshot-fetch timeout (ACCORD_BOOTSTRAP_TIMEOUT_US via
        # LocalConfig): a wedged source fails over to the next replica
        # instead of stalling the whole attempt
        self.timeout_s = (timeout_s if timeout_s is not None
                          else node.config.bootstrap_fetch_timeout_s)
        self.result = DataStore.FetchResult()
        self.result.abort_hook = self.abort
        self.covered = Ranges.EMPTY
        self.failed = Ranges.EMPTY
        self.aborted = Ranges.EMPTY
        self.max_applied = None
        # source -> (requested sub-range, StartingRangeFetch token)
        self.inflight: Dict[int, Tuple[Ranges, _Starting]] = {}
        self.tried: Set[Tuple[int, object]] = set()
        self.done = False

    # ------------------------------------------------------------- driving --
    def start(self) -> "FetchCoordinator":
        self._fetch_missing()
        return self

    def _missing(self) -> Ranges:
        out = self.ranges.subtract(self.covered).subtract(self.aborted)
        return out.subtract(self.failed)

    def _fetch_missing(self) -> None:
        if self.done:
            return
        missing = self._missing()
        if missing.is_empty:
            self._maybe_finish()
            return
        topology = self.node.topology.for_epoch(self.sync_point.txn_id.epoch)
        requested = False
        for shard in topology.for_selection(missing).shards:
            want = Ranges([shard.range]).slice(missing)
            want = want.subtract(self._inflight_ranges())
            if want.is_empty:
                continue
            if not any(n != self.node.id for n in shard.nodes):
                # we are the only replica: nothing to copy for this shard
                self.covered = self.covered.union(want)
                self.fetch_ranges.fetched(want)
                continue
            source = self._pick_source(shard)
            if source is None:
                if any(n != self.node.id and n in self.inflight
                       for n in shard.nodes):
                    # replicas merely busy serving other sub-ranges: revisit
                    # when an in-flight request settles (on_success/failure
                    # re-run _fetch_missing) — NOT a permanent failure
                    continue
                # every replica tried for this shard: report failure upward;
                # the caller schedules a fresh attempt
                self.failed = self.failed.union(want)
                self.fetch_ranges.fail(
                    want, TimeoutError(f"all sources tried for {want}"))
                continue
            requested = True
            token = _Starting(self, want, source,
                              self.fetch_ranges.starting(want))
            self.inflight[source] = (want, token)
            self.node.send(source,
                           FetchSnapshot(self.sync_point.txn_id, want),
                           callback=self, timeout_s=self.timeout_s)
        if not requested and not self.inflight:
            self._maybe_finish()

    def _inflight_ranges(self) -> Ranges:
        out = Ranges.EMPTY
        for want, _tok in self.inflight.values():
            out = out.union(want)
        return out

    def _pick_source(self, shard) -> Optional[int]:
        # draining peers (scale-in, messages/admin.DrainBegin) are last
        # resort: prefer replicas that will still own the data tomorrow,
        # but a drainer beats failing the sub-range outright
        draining = getattr(self.node, "draining_peers", ())
        candidates = [n for n in shard.nodes
                      if n != self.node.id and n not in self.inflight
                      and (n, shard.range.start) not in self.tried]
        for pool in (True, False):
            for n in candidates:
                if (n not in draining) is pool:
                    self.tried.add((n, shard.range.start))
                    return n
        return None

    def _observe_max_applied(self, max_applied) -> None:
        if self.max_applied is None or max_applied > self.max_applied:
            self.max_applied = max_applied

    # ------------------------------------------------------------- replies --
    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        want, token = self.inflight.pop(from_id, (None, None))
        if isinstance(reply, FetchSnapshotOk) and token is not None \
                and not token.aborted:
            token.started(reply.max_applied)
            self.data_store.install_snapshot(reply.snapshot)
            # never credit/report sub-ranges aborted while in flight — the
            # caller dropped them and must not see them bootstrapped
            got = reply.ranges.subtract(self.aborted)
            self.covered = self.covered.union(got)
            if not got.is_empty:
                self.fetch_ranges.fetched(got)
        elif token is not None and not token.aborted:
            # nack (fence not applied there yet, or not a replica): no data
            # moved — cancel so caller-side token tracking closes out
            token.cancel()
        self._fetch_missing()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        want, token = self.inflight.pop(from_id, (None, None))
        if token is not None:
            token.cancel()
        self._fetch_missing()

    # -------------------------------------------------------------- finish --
    def abort(self, ranges: Ranges) -> None:
        """FetchResult.abort(ranges): these ranges stopped mattering (e.g.
        moved away by a newer topology) — drop them from the attempt and
        abort any in-flight source whose request is now fully irrelevant."""
        if self.done:
            return
        self.aborted = self.aborted.union(ranges)
        for source, (want, token) in list(self.inflight.items()):
            if want.subtract(self.aborted).is_empty:
                token.abort()
                self.inflight.pop(source, None)
        self._fetch_missing()

    def _maybe_finish(self) -> None:
        if self.done or self.inflight:
            return
        if not self._missing().is_empty:
            return
        self.done = True
        self.result.max_applied = self.max_applied
        if not self.failed.is_empty:
            self.result.try_failure(
                TimeoutError(f"fetch failed for {self.failed}"))
        else:
            self.result.try_success(self.covered)
