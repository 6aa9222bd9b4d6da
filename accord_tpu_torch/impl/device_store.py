"""DeviceCommandStore: the batched deps kernel on the protocol path.

A CommandStore that implements the SafeCommandStore active-conflict query by
*batching* — incoming operations accumulate in a flush window; one kernel
call computes every declared deps scan for the whole window (on the card the
deps tile K1, ops/cuda_kernels.batched_active_deps_cuda; on the CPU its
plain version, ops/deps_kernel.batched_active_deps — the device formulation
of CommandsForKey.mapReduceActive, reference
accord/local/CommandsForKey.java:614-650); operations then execute serially,
serving their scans from the precomputed masks.

The counterpart of ``accord_tpu/impl/device_store.py``: the same protocol,
counters and gates, with every device call on the port's ops, on the
store's ``device`` (None means the CUDA card; the tests pass "cpu").

Equivalence contract: results must be bit-identical to the scalar path.  Two
mechanisms enforce it:

  * snapshot validation — each CommandsForKey carries a version counter; a
    precomputed probe is served only if every key it covers is unchanged
    since the snapshot, with one exception: a single bump whose mutator is
    the querying txn itself (its own preaccept/accept registration, which
    the scan excludes anyway).  Anything else — an earlier op in the same
    window mutating a shared key, a truncation, an unmanaged notification —
    falls back to the scalar scan.  Correctness never depends on the device
    result being fresh.
  * verify mode — every served scan is cross-checked against the scalar scan
    inline and asserted identical; the burn equivalence tests run with this
    on, so a whole hostile-cluster run certifies bit-identity at every query.

The range-command arm (RangeDeps tier) is device-served too: each window
stabs the live range-command index with every declared probe in one [Q, N]
mask (ops/range_kernel.range_stab_mask, plain torch as the JAX package's is
XLA), version-gated on CommandStore.range_version — any register/cleanup
mutation since the snapshot falls back to the scalar walk — with the
activity filter and overlap computation re-run live over the pruned
candidates.  The recovery scans run the same way (ops/recovery_kernel.py).
And execution ordering is device-planned: windows holding several Applies
are scheduled by the wavefront (K2 on the card, ops/cuda_kernels.
execution_waves_cuda) in Kahn-layer order, with the scalar WaitingOn
machinery still gating every transition (see _plan_waves).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.local.store import (CommandStore, PreLoadContext,
                                          SafeCommandStore)
from accord_tpu_torch.obs.profiler import profiler_from_env, span
from accord_tpu_torch.obs.registry import Registry
from accord_tpu_torch.obs.views import (CounterDict, MetricView,
                                        bind_metric_views)
from accord_tpu_torch.ops.cuda_kernels import (batched_active_deps_cuda,
                                               execution_waves_cuda)
from accord_tpu_torch.ops.deps_kernel import in_batch_graph
from accord_tpu_torch.ops.encode import (PAD, BatchEncoder, _pad_to,
                                         window_to_tensors, witness_mask)
from accord_tpu_torch.ops.range_kernel import range_stab_mask
from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                  batched_recovery_scans)
from accord_tpu_torch.ops.sharded import (ShardedEncoder, dep_mask_to_host,
                                          make_sharded_deps_step,
                                          shard_to_devices)
from accord_tpu_torch.ops.wavefront import waves_oracle
from accord_tpu_torch.primitives.keys import Key, Ranges
from accord_tpu_torch.primitives.timestamp import KindSet, Timestamp, TxnId
from accord_tpu_torch.utils.backend import resolve_device, resolve_spread

_INT32 = np.iinfo(np.int32)


def _fits_int32(*arrays) -> bool:
    return all(a.min() >= _INT32.min and a.max() <= _INT32.max
               for a in arrays)


def _bound_ranks(*arrays):
    """`arrays` of int64 bounds as int32 ranks among all their values: the
    same order, so every comparison between them is unchanged."""
    values = np.unique(np.concatenate(arrays))
    return tuple(np.searchsorted(values, a).astype(np.int32) for a in arrays)


class _Probe:
    """One precomputed active-scan: deps per key at (before, kinds), plus the
    snapshot versions that gate serving it."""

    __slots__ = ("before", "kinds", "keyed", "key_set", "versions",
                 "committed_versions")

    def __init__(self, before: Timestamp, kinds: KindSet,
                 keyed: Dict[Key, List[TxnId]], key_set: Set[Key],
                 versions: Dict[Key, int], committed_versions: Dict[Key, int]):
        self.before = before
        self.kinds = kinds
        self.keyed = keyed
        self.key_set = key_set
        self.versions = versions
        self.committed_versions = committed_versions


class _RangeProbe:
    """One precomputed range-command stab (ops/range_kernel.py): the
    kernel-pruned candidate set of range txns geometrically intersecting
    the probe's participants.  Serving re-runs ONLY the scalar activity
    filter and overlap computation over the candidates (cost proportional
    to matches, not to the live range-command population).  Version-gated
    on CommandStore.range_version (any register/cleanup mutation since the
    snapshot falls back to the scalar walk)."""

    __slots__ = ("before", "kinds", "mode", "owned_repr", "candidates",
                 "version", "log_len")

    def __init__(self, before: Timestamp, kinds: KindSet, mode: str,
                 owned_repr, candidates: Tuple[TxnId, ...], version: int,
                 log_len: int = 0):
        self.before = before
        self.kinds = kinds
        self.mode = mode            # "keys" | "ranges"
        self.owned_repr = owned_repr
        self.candidates = candidates
        self.version = version
        self.log_len = log_len      # range_log length at snapshot


class _RecoveryProbe:
    """One precomputed recovery-scan set (the four mapReduceFull predicates
    of BeginRecovery, ops/recovery_kernel.py) for one probe txn: per-key id
    lists, servable over any subset of the covered keys.  Version gating is
    EXACT (no self-bump tolerance): a first-witness registration inserts the
    probe into other entries' missing[], which changes the scalar answers."""

    __slots__ = ("txn_id", "rejects_a", "rejects_b", "witness", "no_witness",
                 "key_set", "versions")

    def __init__(self, txn_id: TxnId, rejects_a, rejects_b, witness,
                 no_witness, key_set: Set[Key], versions: Dict[Key, int]):
        self.txn_id = txn_id
        self.rejects_a = rejects_a        # {key: [ids]} — any() => reject
        self.rejects_b = rejects_b
        self.witness = witness
        self.no_witness = no_witness
        self.key_set = key_set
        self.versions = versions


# trivially-servable recovery probe for participants with no CFK state:
# every predicate tier is empty, nothing to scan
_EMPTY_RECOVERY = _RecoveryProbe(None, {}, {}, {}, {}, set(), {})


class DeviceSafeCommandStore(SafeCommandStore):
    def map_reduce_active(self, participants, before: Timestamp,
                          kinds: KindSet, fn, on_range_dep=None,
                          exclude: Optional[TxnId] = None) -> None:
        store: DeviceCommandStore = self.store
        probe = store._precomputed.get((before, kinds))
        is_range = isinstance(participants, Ranges)
        owned = self._owned_participants(participants)
        # range-domain participants: the per-key tier is the CFK walk over
        # keys inside the ranges — the probe precomputed exactly that set
        # at snapshot time (see _collect_deps_probes); any key born since
        # fails the cover check below and falls back to scalar
        keys = self._owned_cfk_keys(owned) if is_range else owned
        if probe is None:
            if len(keys) == 0:
                # nothing in the per-key tier to scan (the collection skips
                # empty-owned probes for the same reason): served trivially,
                # only the range-conflict arm remains
                store.device_hits += 1
                self._map_range_conflicts(owned, is_range, before, kinds,
                                          fn, on_range_dep)
                return
            store.device_misses += 1
            store.device_miss_causes["no_probe"] += 1
            return super().map_reduce_active(participants, before, kinds, fn,
                                             on_range_dep, exclude)
        if not all(k in probe.key_set and self._version_ok(k, probe, exclude)
                   for k in keys):
            store.device_misses += 1
            store.device_miss_causes[
                "version" if all(k in probe.key_set for k in keys)
                else "key_cover"] += 1
            return super().map_reduce_active(participants, before, kinds, fn,
                                             on_range_dep, exclude)
        store.device_hits += 1
        if store.verify:
            self._verify_against_scalar(keys, before, kinds, exclude, probe)
        served = 0
        for key in keys:
            for dep in probe.keyed.get(key, ()):
                if dep != exclude:
                    fn(key, dep)
                    served += 1
        store.device_served_deps += served
        self._map_range_conflicts(owned, is_range, before, kinds, fn,
                                  on_range_dep)

    # ------------------------------------------------- range-conflict arm --
    def _map_range_conflicts(self, owned, is_range: bool, before: Timestamp,
                             kinds: KindSet, fn, on_range_dep) -> None:
        """Serve the range-command arm from the window's batched stab
        (ops/range_kernel.py) when a version-valid probe covers the query;
        the activity filter and overlap computation re-run live over the
        kernel-pruned candidates only."""
        store: DeviceCommandStore = self.store
        if not store.range_commands:
            return  # scalar walk over an empty index is a no-op
        probe = store._precomputed_ranges.get((before, kinds))
        ok = probe is not None
        if ok:
            if is_range:
                ok = probe.mode == "ranges" and probe.owned_repr == tuple(
                    (r.start, r.end) for r in owned)
            else:
                ok = probe.mode == "keys" and all(
                    k.token in probe.owned_repr for k in owned)
        if not ok:
            store.device_range_misses += 1
            return super()._map_range_conflicts(owned, is_range, before,
                                                kinds, fn, on_range_dep)
        if probe.version != store.range_version:
            if store.range_log is None:
                # delta unavailable (tier disabled mid-window): stale probe
                # is unservable
                store.device_range_misses += 1
                return super()._map_range_conflicts(owned, is_range, before,
                                                    kinds, fn, on_range_dep)
            # the index mutated since the snapshot.  Deletions are safe —
            # the live activity/overlap filters below drop them — and every
            # addition or re-registration since the snapshot is in the
            # append-only range_log suffix: union it into the candidate
            # set (the geometric prune is lost only for the delta, whose
            # non-intersecting entries the overlap filter discards).
            # Refresh the probe IN PLACE so repeat serves in this window
            # take the version-match fast path.
            delta = store.range_log[probe.log_len:]
            if delta:
                seen_c = set(probe.candidates)
                probe.candidates = probe.candidates + tuple(
                    d for d in dict.fromkeys(delta) if d not in seen_c)
            probe.version = store.range_version
            probe.log_len = len(store.range_log)
        candidates = probe.candidates
        store.device_range_hits += 1
        served = []
        for txn_id in candidates:
            if not self._active_range_conflict(txn_id, before, kinds):
                continue
            ranges = store.range_commands.get(txn_id)
            if ranges is None:
                continue  # cleaned up since the snapshot: no conflict
            if is_range:
                overlap = ranges.intersection(owned)
            else:
                overlap = Ranges([r for r in ranges
                                  if any(r.contains(k) for k in owned)])
            if overlap.is_empty:
                continue
            if on_range_dep is not None:
                served.append(("r", overlap, txn_id))
            else:
                for key in (self._owned_cfk_keys(overlap) if is_range
                            else [k for k in owned if overlap.contains(k)]):
                    served.append(("k", key, txn_id))
        if store.verify:
            self._verify_range_arm(owned, is_range, before, kinds,
                                   on_range_dep is not None, served)
        for tag, a, txn_id in served:
            if tag == "r":
                on_range_dep(a, txn_id)
            else:
                fn(a, txn_id)

    def _verify_range_arm(self, owned, is_range, before, kinds,
                          has_range_sink, served) -> None:
        want = []
        super()._map_range_conflicts(
            owned, is_range, before, kinds,
            lambda k, t: want.append(("k", k, t)),
            (lambda o, t: want.append(("r", o, t)))
            if has_range_sink else None)

        def norm(items):
            return sorted(
                (tag, tuple((r.start, r.end) for r in a) if tag == "r"
                 else a.token, t) for tag, a, t in items)

        if norm(served) != norm(want):
            err = AssertionError(
                f"device range arm diverges from scalar at "
                f"(before={before!r}): device={norm(served)} "
                f"scalar={norm(want)}")
            try:
                self.store.agent.on_uncaught_exception(err)
            except Exception:
                pass
            raise err

    # ---------------------------------------------- recovery scans (keys) --
    def _recovery_servable(self, txn_id: TxnId, participants):
        """The precomputed recovery probe and the owned KEY list, when every
        queried key is covered and exactly at its snapshot version.  An
        empty key list (no CFK state inside the participants — collection
        skips such probes too) serves trivially, matching the deps arm."""
        store: DeviceCommandStore = self.store
        owned = self._owned_participants(participants)
        keys = (self._owned_cfk_keys(owned) if isinstance(owned, Ranges)
                else list(owned))
        if not keys:
            return _EMPTY_RECOVERY, []
        probe = store._precomputed_recovery.get(txn_id)
        if probe is None:
            return None, None
        for k in keys:
            cfk = store.cfks.get(k)
            v = cfk.version if cfk is not None else 0
            if k not in probe.key_set or v != probe.versions.get(k, 0):
                return None, None
        return probe, keys

    def _serve_recovery(self, which: str, txn_id: TxnId, participants,
                        scalar_fn):
        probe, keys = self._recovery_servable(txn_id, participants)
        if probe is None:
            self.store.device_recovery_misses += 1
            return None
        self.store.device_recovery_hits += 1
        keyed = getattr(probe, which)
        if self.store.verify:
            want: Dict[Key, List[TxnId]] = {}
            scalar_fn(want)
            got = {k: keyed[k] for k in keys if keyed.get(k)}
            want = {k: sorted(v) for k, v in want.items() if v}
            if got != want:
                err = AssertionError(
                    f"device recovery scan '{which}' diverges for {txn_id}: "
                    f"device={got} scalar={want}")
                try:
                    self.store.agent.on_uncaught_exception(err)
                except Exception:
                    pass
                raise err
        return {k: keyed[k] for k in keys if keyed.get(k)}

    def _decipher_fast_path_keys(self, txn_id: TxnId, participants):
        # the batched masks enumerate RAW candidates; the elision
        # classifier (CommandsForKey.omission_covers) is a host-side
        # post-step shared with the scalar path — including its third
        # verdict (unresolved covers the coordinator must await)
        def scalar_collect(out):
            for cfk in self._participant_cfks(participants):
                found = cfk.started_after_without_witnessing_ids(txn_id,
                                                                 raw=True)
                if found:
                    out.setdefault(cfk.key, []).extend(found)

        served_a = self._serve_recovery("rejects_a", txn_id, participants,
                                        scalar_collect)
        if served_a is None:
            return super()._decipher_fast_path_keys(txn_id, participants)

        def scalar_collect_b(out):
            for cfk in self._participant_cfks(participants):
                found = cfk.executes_after_without_witnessing_ids(txn_id,
                                                                 raw=True)
                if found:
                    out.setdefault(cfk.key, []).extend(found)

        served_b = self._serve_recovery("rejects_b", txn_id, participants,
                                        scalar_collect_b)
        if served_b is None:
            return super()._decipher_fast_path_keys(txn_id, participants)
        return self._classify_omission_maps((served_a, served_b), txn_id)

    def _earlier_committed_witness_keys(self, txn_id, participants,
                                        builder) -> None:
        def scalar_collect(out):
            for cfk in self._participant_cfks(participants):
                ids = cfk.stable_started_before_and_witnessed(txn_id)
                if ids:
                    out.setdefault(cfk.key, []).extend(ids)

        served = self._serve_recovery("witness", txn_id, participants,
                                      scalar_collect)
        if served is None:
            return super()._earlier_committed_witness_keys(
                txn_id, participants, builder)
        for k, ids in served.items():
            for t in ids:
                builder.add(k, t)

    def _earlier_accepted_no_witness_keys(self, txn_id, participants,
                                          builder) -> None:
        def scalar_collect(out):
            for cfk in self._participant_cfks(participants):
                ids = cfk.accepted_started_before_without_witnessing(txn_id)
                if ids:
                    out.setdefault(cfk.key, []).extend(ids)

        served = self._serve_recovery("no_witness", txn_id, participants,
                                      scalar_collect)
        if served is None:
            return super()._earlier_accepted_no_witness_keys(
                txn_id, participants, builder)
        for k, ids in served.items():
            for t in ids:
                builder.add(k, t)

    def _version_ok(self, key: Key, probe: _Probe,
                    exclude: Optional[TxnId]) -> bool:
        cfk = self.store.cfks.get(key)
        v = cfk.version if cfk is not None else 0
        snap = probe.versions.get(key, 0)
        if v == snap:
            return True
        # sole mutation since the snapshot = the querying txn's own
        # registration, which its scan excludes (deps_kernel `earlier` for
        # preaccept; commands.calculate_deps' dep != txn_id filter otherwise).
        # The committed view must be untouched: committing/invalidating the
        # querier moves the transitive-elision bound, which changes OTHER
        # entries' visibility — self-exclusion does not cover that.
        return (v == snap + 1 and exclude is not None
                and cfk is not None and cfk.last_mutator == exclude
                and cfk.committed_version
                == probe.committed_versions.get(key, 0))

    def _verify_against_scalar(self, owned, before, kinds, exclude,
                               probe: _Probe) -> None:
        got: Dict[Key, List[TxnId]] = {}

        def collect(k, t):
            if t != exclude:
                got.setdefault(k, []).append(t)

        # key tier only — the range arm has its own probe machinery and
        # verify pass (_map_range_conflicts / _verify_range_arm)
        for key in owned:
            cfk = self.store.cfks.get(key)
            if cfk is not None:
                cfk.map_reduce_active(before, kinds,
                                      lambda t, k=key: collect(k, t))
        for key in owned:
            want = sorted(got.get(key, []))
            served = [d for d in probe.keyed.get(key, ()) if d != exclude]
            if served != want:
                err = AssertionError(
                    f"device deps diverge from scalar at {key}: "
                    f"device={served} scalar={want}")
                # raise through the agent too: op-level failures become
                # FailureReplies (a routine nack), which must not mask a
                # broken equivalence contract in the burn
                try:
                    self.store.agent.on_uncaught_exception(err)
                except Exception:
                    pass
                raise err


class DeviceCommandStore(CommandStore):
    """CommandStore with flush-window batching onto the device tier.

    `_submit` defers operations; a zero-delay (or `flush_window_us`-delayed)
    scheduler event drains the window: one batched kernel call precomputes
    every declared deps probe, then the operations run serially.

    The `device_*` counters live in the node's metrics registry (obs/) —
    the attribute names below are read-through views (obs/views.MetricView)
    so the burn/measure harnesses and the `+=` call sites are unchanged.
    """

    device_hits = MetricView("accord_device_hits_total")
    device_misses = MetricView("accord_device_misses_total")
    device_batches = MetricView("accord_device_kernel_batches_total")
    device_batched_probes = MetricView("accord_device_batched_probes_total")
    device_max_batch = MetricView("accord_device_max_batch", kind="gauge")
    # flush-window accounting: every drained window, plus the
    # cross-transaction fusion the ingest pipeline exists to create
    device_flush_windows = MetricView("accord_device_flush_windows_total")
    device_cross_txn_windows = MetricView(
        "accord_device_cross_txn_windows_total")
    device_window_txn_max = MetricView("accord_device_window_txn_max",
                                       kind="gauge")
    device_recovery_hits = MetricView("accord_device_recovery_hits_total")
    device_recovery_misses = MetricView(
        "accord_device_recovery_misses_total")
    device_wave_batches = MetricView("accord_device_wave_batches_total")
    device_wave_planned = MetricView("accord_device_wave_planned_total")
    device_wave_executed = MetricView("accord_device_wave_executed_total")
    device_wave_max_depth = MetricView("accord_device_wave_max_depth",
                                       kind="gauge")
    device_range_hits = MetricView("accord_device_range_hits_total")
    device_range_misses = MetricView("accord_device_range_misses_total")
    device_range_batches = MetricView("accord_device_range_batches_total")
    device_range_candidates = MetricView(
        "accord_device_range_candidates_total")
    # distinct encoded-shape buckets.  In the JAX package each is one XLA
    # compile (jit caches per shape tuple); the port compiles each kernel
    # once for every shape, so here the counter counts shapes, not compiles
    device_compile_shapes = MetricView("accord_device_compile_shapes_total")
    # what a flush hands the device: the deps encoder's index entries (E
    # of each deps flush, summed), and the deps served from its probes
    # (added once a device hit)
    device_encoded_entries = MetricView(
        "accord_device_encoded_entries_total")
    device_served_deps = MetricView("accord_device_served_deps_total")

    def __init__(self, store_id: int, node, ranges, *,
                 flush_window_us: int = 0, verify: bool = False,
                 plan_waves: bool = True, device=None):
        super().__init__(store_id, node, ranges)
        # where the window's tensors live: None means the CUDA card, and
        # raises without one (utils/backend.resolve_device)
        self.device = resolve_device(device)
        self.flush_window_us = flush_window_us
        self.verify = verify
        self.plan_waves = plan_waves  # A/B toggle (measure_device.py)
        self._window: List[Tuple[PreLoadContext, object, object]] = []
        self._flush_scheduled = False
        # >0 while a batch envelope (messages/multi.MultiPreAccept) is
        # applying its parts: deliveries accumulate without scheduling a
        # flush, so the WHOLE envelope resolves as one fused probe window
        # regardless of flush_window_us (the ingest pipeline's contract)
        self._flush_hold = 0
        self._precomputed: Dict[Tuple[Timestamp, KindSet], _Probe] = {}
        self._precomputed_recovery: Dict[TxnId, _RecoveryProbe] = {}
        self._precomputed_ranges: Dict[Tuple[Timestamp, KindSet],
                                       _RangeProbe] = {}
        # (range_version, ids, intervals, dev_starts, dev_ends) — the
        # encoded range index, reused across windows until a mutation
        self._range_index_cache = None
        registry = getattr(getattr(node, "obs", None), "registry", None)
        if registry is None:  # bare-store harnesses without a full Node
            registry = Registry()
        bind_metric_views(self, registry, store=store_id)
        # kernel-level profiler (obs/profiler.py): fenced per-kernel laps,
        # sampled 1-in-N under ACCORD_PROFILE=N (off by default; the
        # always-on shape ledger is a set lookup).  Fencing is the host
        # copy (.cpu()) each device lap ends with.
        self.profiler = profiler_from_env(registry)
        # miss-cause breakdown for the deps arm (hit-rate diagnosis):
        # no_probe (nothing precomputed at this (before, kinds)), version
        # (gate tripped), key_cover (probe didn't cover a queried key)
        self.device_miss_causes = CounterDict(
            registry, "accord_device_miss_causes_total",
            ("no_probe", "version", "key_cover"), label="cause",
            store=store_id)
        self._h_window_txns = registry.histogram(
            "accord_device_window_txns", store=store_id)
        # bytes of the tensors the deps and wave arms send to the device
        # and read back, one add a flush
        self.device_copy_bytes = CounterDict(
            registry, "accord_device_copy_bytes_total", ("h2d", "d2h"),
            label="dir", store=store_id)
        # each deps flush's encoder tier: the native core's pass, or the
        # Python tier where the core did not load
        self.device_encode_windows = CounterDict(
            registry, "accord_device_encode_windows_total",
            ("native", "python"), label="tier", store=store_id)
        # each planned window's wave depth (device_wave_max_depth its max)
        self.device_wave_depths = registry.histogram(
            "accord_device_wave_depth", store=store_id)
        self._seen_shapes = set()  # encoded-shape buckets (compile count)
        # set when the device backend dies mid-run (e.g. a lost card): the
        # store keeps serving every scan through the scalar
        # path instead of crashing the node
        self.device_disabled = False
        # enable the range-registration delta log (local/store.py); the
        # flush boundary clears it together with the probes it serves
        self.range_log = []

    @classmethod
    def factory(cls, flush_window_us: int = 0, verify: bool = False,
                plan_waves: bool = True, device=None):
        return lambda i, node, ranges: cls(i, node, ranges,
                                           flush_window_us=flush_window_us,
                                           verify=verify,
                                           plan_waves=plan_waves,
                                           device=device)

    def _make_safe(self, context: PreLoadContext) -> SafeCommandStore:
        return DeviceSafeCommandStore(self, context)

    def _submit(self, context: PreLoadContext, fn, result) -> None:
        if self.device_disabled:
            # degraded store: no batched precompute will ever run, so skip
            # the dead flush-window deferral entirely
            super()._submit(context, fn, result)
            return
        self._window.append((context, fn, result))
        if not self._flush_scheduled and self._flush_hold == 0:
            self._flush_scheduled = True
            if self.flush_window_us > 0:
                self.node.scheduler.once(self.flush_window_us / 1e6,
                                         self._flush)
            else:
                self.node.scheduler.now(self._flush)

    def _note_compile_shape(self, *shapes, kernel: str = "deps") -> None:
        """Count the first sighting of an encoded-shape bucket, as the JAX
        store counts its compiles.  The port's kernels are compiled once and
        take every shape, so this counts shapes, not compiles; the same
        buckets key the profiler's shape ledger."""
        self.profiler.note_retrace(kernel, shapes)
        if shapes not in self._seen_shapes:
            self._seen_shapes.add(shapes)
            self.device_compile_shapes += 1

    # ----------------------------------------------- envelope window pins --
    def hold_flush(self) -> None:
        """Pin the flush window open (batch envelope applying its parts)."""
        self._flush_hold += 1

    def release_flush(self) -> None:
        self._flush_hold -= 1
        if self._flush_hold == 0 and self._window \
                and not self._flush_scheduled:
            # flush the pinned accumulation now — the envelope already
            # bounded the window; adding the flush delay on top would tax
            # latency twice
            self._flush_scheduled = True
            self.node.scheduler.now(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if self._flush_hold > 0:
            # a pre-hold timer fired mid-envelope: defer — release_flush
            # reschedules with the full envelope accumulated
            return
        window, self._window = self._window, []
        if not window:
            return
        with span("accord.flush"):
            self._run_window(window)

    def _run_window(self, window) -> None:
        """Precompute a drained window's probes and plan, then serve its
        operations in order."""
        window_txns: Set[TxnId] = set()
        for context, _fn, _result in window:
            window_txns.update(context.txn_ids)
        self.device_flush_windows += 1
        self._h_window_txns.observe(len(window_txns))
        if len(window_txns) > 1:
            self.device_cross_txn_windows += 1
        self.device_window_txn_max = max(self.device_window_txn_max,
                                         len(window_txns))
        prof = self.profiler
        prof.window_begin()
        plan = None
        if not self.device_disabled:
            try:
                self._precompute(window)
                self._precompute_recovery(window)
                self._precompute_ranges(window)
                if self.plan_waves:
                    plan = self._plan_waves(window)
            except Exception as exc:  # noqa: BLE001 — mid-run backend death
                if self.verify:
                    # equivalence-certification mode must not silently
                    # degrade to a scalar-only run that still reports OK:
                    # a kernel/encoder regression surfaces here
                    raise
                # a dying device backend must not take the replica down:
                # disable the device tier for this store and serve every
                # scan through the scalar path from here on (recorded via
                # the agent so harnesses can assert on backend incidents)
                self.device_disabled = True
                self._precomputed = {}
                self._precomputed_recovery = {}
                self._precomputed_ranges = {}
                self.range_log = None  # no consumer remains; stop logging
                self.agent.on_handled_exception(exc)
        prof.window_end()
        if plan is not None:
            window = self._schedule_window(window, plan)
        try:
            for context, fn, result in window:
                super()._submit(context, fn, result)
        finally:
            self._precomputed = {}
            self._precomputed_recovery = {}
            self._precomputed_ranges = {}
            if self.range_log is not None:
                # probes are gone; rebase the delta log so it stays bounded
                self.range_log.clear()
            if plan is not None:
                self._account_wave_execution(plan)

    def _collect_deps_probes(self, window
                             ) -> List[Tuple[Timestamp, KindSet, List[Key]]]:
        probes: List[Tuple[Timestamp, KindSet, List[Key]]] = []
        seen: Set[Tuple[Timestamp, KindSet]] = set()
        for context, _fn, _result in window:
            for before, kinds, keys in context.deps_probes:
                if (before, kinds) in seen:
                    continue
                owned = self._snapshot_probe_keys(keys)
                if len(owned) == 0:
                    continue
                seen.add((before, kinds))
                probes.append((before, kinds, owned))
        return probes

    def _snapshot_probe_keys(self, keys) -> List[Key]:
        """The owned KEY list a probe covers, at snapshot time.  A Ranges
        probe (sync point / range txn) materializes to the CFK keys inside
        the ranges — its per-key tier is exactly that walk; the geometric
        range-command arm still goes to the stab tier.  A key born after
        this snapshot fails the serve-time cover gate and falls back to
        scalar."""
        owned = keys.slice(self.ranges) if not self.ranges.is_empty else keys
        if isinstance(owned, Ranges):
            return self.cfk_keys_in(owned)
        return list(owned)

    def _probe_snapshots(self, probes):
        touched = sorted({k for _, _, ks in probes for k in ks})
        cfks = [self.cfks[k] for k in touched if k in self.cfks]
        versions = {k: (self.cfks[k].version if k in self.cfks else 0)
                    for k in touched}
        committed_versions = {
            k: (self.cfks[k].committed_version if k in self.cfks else 0)
            for k in touched}
        return cfks, versions, committed_versions

    def _install_probes(self, probes, keyed, versions,
                        committed_versions) -> None:
        self.device_batches += 1
        self.device_batched_probes += len(probes)
        self.device_max_batch = max(self.device_max_batch, len(probes))
        for (before, kinds, ks), m in zip(probes, keyed):
            self._precomputed[(before, kinds)] = _Probe(
                before, kinds, m, set(ks), versions, committed_versions)

    def _precompute(self, window) -> None:
        self._precomputed = {}
        probes = self._collect_deps_probes(window)
        if not probes:
            return

        # each profiler lap ends at a host copy (.cpu()) — the copy IS the
        # fence, so "device" measures the kernel, not dispatch overlap; the
        # spans split the laps: deps_encode = snapshot + encode + upload,
        # deps_kernel = launch + download, deps_decode = decode
        t = self.profiler.begin()
        with span("accord.deps.snapshot"):
            cfks, versions, committed_versions = self._probe_snapshots(
                probes)
        with span("accord.deps.encode"):
            enc = BatchEncoder.for_probes(cfks, probes)
        s, b = enc.state, enc.dbatch
        with span("accord.deps.upload"):
            placed = window_to_tensors(s, b, self.device)
        t = self.profiler.lap(t, "deps_encode")
        with span("accord.deps.launch"):
            self._note_compile_shape(s.entry_rank.shape, b.touches.shape)
            # K1 on the card; its plain version on CPU tensors.  The deps
            # step takes the window's tensors less txn_kind, the eighth
            dep_mask, _count = batched_active_deps_cuda(*placed[:7],
                                                        placed[8])
        with span("accord.deps.download"):
            mask_host = dep_mask.cpu().numpy()
        t = self.profiler.lap(t, "deps_kernel")
        with span("accord.deps.decode"):
            keyed = enc.decode_key_deps(mask_host)
        self.profiler.lap(t, "deps_decode")
        self._count_deps_flush(placed, mask_host, enc.state.num_entries,
                               enc.tier)
        with span("accord.deps.install"):
            self._install_probes(probes, keyed, versions, committed_versions)

    def _count_deps_flush(self, placed, mask_host, entries: int,
                          tier: str) -> None:
        """One deps flush's counters: the bytes of the tensors it sent to
        the device and of the mask it read back, the entries encoded and
        the encoder's tier (``native`` or ``python``)."""
        self.device_copy_bytes["h2d"] += sum(a.nbytes for a in placed)
        self.device_copy_bytes["d2h"] += mask_host.nbytes
        self.device_encoded_entries += entries
        self.device_encode_windows[tier] += 1

    def _precompute_recovery(self, window) -> None:
        """Batch every declared recovery probe (BeginRecovery's four
        mapReduceFull predicates) into one kernel call."""
        self._precomputed_recovery = {}
        probes: List[Tuple[TxnId, List[Key]]] = []
        seen: Set[TxnId] = set()
        for context, _fn, _result in window:
            for txn_id, keys in context.recovery_probes:
                if txn_id in seen:
                    continue
                owned = self._snapshot_probe_keys(keys)
                if len(owned) == 0:
                    continue
                seen.add(txn_id)
                probes.append((txn_id, owned))
        if not probes:
            return
        with span("accord.recovery"):
            self._recovery_window(probes)

    def _recovery_window(self, probes) -> None:
        t = self.profiler.begin()
        touched = sorted({k for _, ks in probes for k in ks})
        cfks = [self.cfks[k] for k in touched if k in self.cfks]
        versions = {k: (self.cfks[k].version if k in self.cfks else 0)
                    for k in touched}
        enc = RecoveryEncoder(cfks, probes)
        args = enc.args()
        tensors = enc.tensors(self.device)
        t = self.profiler.lap(t, "recovery_encode")
        self._note_compile_shape(
            *(getattr(a, "shape", None) for a in args), kernel="recovery")
        ra, rb, cw, anw = (m.cpu().numpy()
                           for m in batched_recovery_scans(*tensors))
        t = self.profiler.lap(t, "recovery_kernel")
        self.device_batches += 1
        self.device_batched_probes += len(probes)
        for i, (txn_id, ks) in enumerate(probes):
            self._precomputed_recovery[txn_id] = _RecoveryProbe(
                txn_id, enc.decode_keyed(ra[i]), enc.decode_keyed(rb[i]),
                enc.decode_keyed(cw[i]), enc.decode_keyed(anw[i]),
                set(ks), versions)
        self.profiler.lap(t, "recovery_decode")

    def _precompute_ranges(self, window) -> None:
        """Stab the live range-command index with every declared probe's
        participants in one [Q, N] kernel call (ops/range_kernel.py; the
        reference's per-query CINTIA checkpoint walk, RangeDeps.java:63-120
        + SearchableRangeList.java:79, redesigned as a dense broadcast
        compare).  Key-domain participants stab as unit intervals
        [token, token+1); range-domain as their spans."""
        self._precomputed_ranges = {}
        if not self.range_commands:
            return
        probes = []
        seen: Set[Tuple[Timestamp, KindSet]] = set()
        for context, _fn, _result in window:
            for before, kinds, participants in context.deps_probes:
                if (before, kinds) in seen:
                    continue
                owned = participants.slice(self.ranges) \
                    if not self.ranges.is_empty else participants
                if isinstance(owned, Ranges):
                    if owned.is_empty:
                        continue
                    spans = [(r.start, r.end) for r in owned]
                    mode, owned_repr = "ranges", tuple(spans)
                else:
                    if len(owned) == 0:
                        continue
                    spans = [(k.token, k.token + 1) for k in owned]
                    mode, owned_repr = "keys", frozenset(
                        k.token for k in owned)
                seen.add((before, kinds))
                probes.append((before, kinds, mode, owned_repr, spans))
        if not probes:
            return
        with span("accord.range"):
            self._range_window(probes)

    def _range_window(self, probes) -> None:
        # the encoded interval index is cached on range_version: a steady
        # workload over a rarely-mutated index re-uses the bound tensors on
        # the store's device and pays only for the query side
        cache = self._range_index_cache
        if cache is not None and cache[0] == self.range_version:
            _, ids, intervals, bounds, dev_starts, dev_ends = cache
        else:
            ids = list(self.range_commands.keys())
            intervals = []
            for idx, t in enumerate(ids):
                for r in self.range_commands[t]:
                    intervals.append((r.start, r.end, idx))
            if not intervals:
                self._range_index_cache = None
                return
            n_pad = _pad_to(len(intervals), 128)
            starts = np.zeros(n_pad, np.int64)
            ends = np.zeros(n_pad, np.int64)  # empty [0,0) pads never match
            for i, (s, e, _idx) in enumerate(intervals):
                starts[i], ends[i] = s, e
            bounds = (starts, ends)
            dev_starts = dev_ends = None
            if _fits_int32(starts, ends):
                dev_starts = torch.from_numpy(starts.astype(np.int32)).to(
                    self.device)
                dev_ends = torch.from_numpy(ends.astype(np.int32)).to(
                    self.device)
            self._range_index_cache = (self.range_version, ids, intervals,
                                       bounds, dev_starts, dev_ends)
        if not intervals:
            return
        t = self.profiler.begin()
        all_spans = [sp for _, _, _, _, spans in probes for sp in spans]
        q_pad = _pad_to(len(all_spans), 128)
        qs = np.zeros(q_pad, np.int64)
        qe = np.zeros(q_pad, np.int64)
        for i, (s, e) in enumerate(all_spans):
            qs[i], qe[i] = s, e
        if dev_starts is not None and _fits_int32(qs, qe):
            dev_qs = torch.from_numpy(qs.astype(np.int32)).to(self.device)
            dev_qe = torch.from_numpy(qe.astype(np.int32)).to(self.device)
        else:
            # a bound outside int32 (the real-socket host's token span ends
            # at 2**31, one past it): the stab test only compares bounds,
            # so every bound of the call goes as its rank among them all
            dev_starts, dev_ends, dev_qs, dev_qe = (
                torch.from_numpy(a).to(self.device)
                for a in _bound_ranks(*bounds, qs, qe))
        t = self.profiler.lap(t, "range_encode")
        self._note_compile_shape(tuple(dev_starts.shape), (q_pad,),
                                 kernel="range")
        mask = range_stab_mask(dev_starts, dev_ends, dev_qs,
                               dev_qe).cpu().numpy()
        t = self.profiler.lap(t, "range_kernel")
        self.device_range_batches += 1
        version = self.range_version
        row = 0
        for before, kinds, mode, owned_repr, spans in probes:
            cand: Set[TxnId] = set()
            for _ in spans:
                for j in np.nonzero(mask[row][:len(intervals)])[0]:
                    cand.add(ids[intervals[j][2]])
                row += 1
            self.device_range_candidates += len(cand)
            self._precomputed_ranges[(before, kinds)] = _RangeProbe(
                before, kinds, mode, owned_repr, tuple(sorted(cand)),
                version, log_len=len(self.range_log))
        self.profiler.lap(t, "range_decode")

    # ------------------------------------------------ wavefront scheduling --
    def _plan_waves(self, window):
        """Plan the window's Apply order with the wavefront kernel.

        The scalar path resolves execution order one command at a time:
        each applied dependency walks its listeners and re-tests WaitingOn
        (reference Commands.maybeExecute :656 / NotifyWaitingOn :1011).
        When several Applies land in one flush window, the device instead
        computes the window's conflict DAG (ops.deps_kernel.in_batch_graph:
        shared-key ∧ earlier-executeAt ∧ witnesses, one matmul) and
        Kahn-layers it (K2, ops.cuda_kernels.execution_waves_cuda, given
        the ranks so it takes its forward pass); the window's
        Applies then run in wave order, so each one finds its in-window
        dependencies already applied and executes immediately instead of
        parking in WaitingOn and being re-driven by the listener cascade.

        Correctness NEVER depends on the plan: it only reorders message
        application (legal under the protocol's arbitrary-delivery model —
        the sim's nemeses reorder far more aggressively), and the scalar
        WaitingOn machinery still gates every transition.  The plan's
        *accuracy* is certified in verify mode: the device wave assignment
        is asserted equal to the host oracle (ops.wavefront.waves_oracle)
        on an identically-defined host-derived graph.

        Returns {txn_id: (wave, execute_at)} or None when the window holds
        fewer than two plannable Applies."""
        probes = []
        seen: Set[TxnId] = set()
        for context, _fn, _result in window:
            for txn_id, execute_at, keys in context.execute_probes:
                if txn_id in seen:
                    continue
                seen.add(txn_id)
                cmd = self.commands.get(txn_id)
                if cmd is not None and cmd.save_status >= SaveStatus.APPLYING:
                    continue  # redundant re-delivery: nothing to schedule
                owned = keys.slice(self.ranges) \
                    if not self.ranges.is_empty else keys
                if len(owned) == 0:
                    continue
                probes.append((txn_id, execute_at,
                               [k.token for k in owned]))
        if len(probes) < 2:
            return None

        # wavefront_encode = encode + upload, wavefront_kernel = launch +
        # download
        t_prof = self.profiler.begin()
        n = len(probes)
        with span("accord.waves.encode"):
            tokens = sorted({t for _, _, toks in probes for t in toks})
            tindex = {t: i for i, t in enumerate(tokens)}
            order = sorted(range(n), key=lambda i: probes[i][1])
            b = _pad_to(n, 128)
            kpad = _pad_to(len(tokens), 128)
            txn_rank = np.full(b, -1, np.int32)
            txn_wmask = np.zeros(b, np.int32)
            txn_kind = np.zeros(b, np.int32)
            touches = np.zeros((b, kpad), bool)
            for rank, i in enumerate(order):
                txn_id, _eat, toks = probes[i]
                txn_rank[i] = rank
                txn_wmask[i] = witness_mask(txn_id.kind)
                txn_kind[i] = int(txn_id.kind)
                for t in toks:
                    touches[i, tindex[t]] = True
        with span("accord.waves.upload"):
            placed = [torch.from_numpy(a).to(self.device)
                      for a in (txn_rank, txn_wmask, txn_kind, touches)]
        t_prof = self.profiler.lap(t_prof, "wavefront_encode")
        with span("accord.waves.launch"):
            self._note_compile_shape((b,), (b, kpad), kernel="wavefront")
            dev_rank, dev_wmask, dev_kind, dev_touches = placed
            dep_bb = in_batch_graph(dev_rank, dev_wmask, dev_kind,
                                    dev_touches)
            # K2 on the card; its plain version on CPU tensors
            dev_waves = execution_waves_cuda(dep_bb, dev_rank)
        with span("accord.waves.download"):
            waves_host = dev_waves.cpu().numpy()
        self.profiler.lap(t_prof, "wavefront_kernel")
        waves = waves_host[:n]
        if self.verify:
            self._verify_waves(probes, txn_rank, txn_wmask, txn_kind, waves)
        self.device_copy_bytes["h2d"] += sum(a.nbytes for a in placed)
        self.device_copy_bytes["d2h"] += waves_host.nbytes
        depth = int(waves.max()) + 1
        self.device_wave_depths.observe(depth)
        self.device_wave_batches += 1
        self.device_wave_planned += n
        self.device_wave_max_depth = max(self.device_wave_max_depth, depth)
        return {probes[i][0]: (int(waves[i]), probes[i][1])
                for i in range(n)}

    def _verify_waves(self, probes, txn_rank, txn_wmask, txn_kind, waves):
        """Oracle-check the device wave assignment against the host
        layering of the identically-defined conflict graph."""
        n = len(probes)
        toksets = [set(toks) for _, _, toks in probes]
        rows = []
        for i in range(n):
            deps = [j for j in range(n)
                    if txn_rank[j] < txn_rank[i]
                    and (toksets[i] & toksets[j])
                    and ((txn_wmask[i] >> txn_kind[j]) & 1)]
            rows.append(deps)
        want = waves_oracle(rows)
        got = [int(w) for w in waves]
        if got != want:
            err = AssertionError(
                f"device waves diverge from host oracle: device={got} "
                f"host={want}")
            try:
                self.agent.on_uncaught_exception(err)
            except Exception:
                pass
            raise err

    def _schedule_window(self, window, plan):
        """Reorder the window: unplanned operations first in arrival order,
        then the planned Applies by (wave, executeAt, arrival)."""
        planned = []
        rest = []
        for idx, item in enumerate(window):
            context = item[0]
            key = None
            for txn_id, _eat, _keys in context.execute_probes:
                if txn_id in plan:
                    key = plan[txn_id]
                    break
            if key is None:
                rest.append(item)
            else:
                planned.append((key[0], key[1], idx, item))
        planned.sort(key=lambda x: (x[0], x[1], x[2]))
        return rest + [item for _, _, _, item in planned]

    def _account_wave_execution(self, plan) -> None:
        # plan membership implies the txn had NOT executed when the window
        # was planned (_plan_waves filters already-APPLYING re-deliveries),
        # so reaching APPLYING now means this window's schedule ran it
        for txn_id in plan:
            cmd = self.commands.get(txn_id)
            if cmd is not None \
                    and cmd.save_status >= SaveStatus.APPLYING:
                self.device_wave_executed += 1


class MeshDeviceCommandStore(DeviceCommandStore):
    """DeviceCommandStore whose batched deps precompute runs the sharded
    deps step (ops/sharded.make_sharded_deps_step: per-shard deps masks over
    key-range blocks with the counts summed — the layout of the reference's
    CommandStores shard fan-out, CommandStores.java:78).  With `devices`
    None the port stacks the S shards on the store's device: on the card
    one K1 launch pair a window for all S, on the CPU the plain version
    shard by shard.  With a list of D devices (or "all"), the counterpart
    of the JAX store over a ``jax.sharding.Mesh`` of every visible device:
    each window's arrays go from the host straight to the cards in blocks
    of S/D shards, each card runs one K6 and one stacked K1 launch on its
    block, NCCL sums the counts, and each card's mask plane comes straight
    back to the host.  The store's own `device` is then devices[0], where
    its recovery, range and wave arms run.

    The protocol semantics are identical to DeviceCommandStore — same
    probe declarations, same serving, same version gates, same inline
    verification — only the kernel executing the window's deps scans is
    the sharded step.  The form with one shard a rank of a
    ``torch.distributed`` group serves no store."""

    def __init__(self, store_id: int, node, ranges, *,
                 flush_window_us: int = 0, verify: bool = False,
                 n_shards: int = 8, device=None, devices=None):
        device, devices = resolve_spread(device, devices)
        super().__init__(store_id, node, ranges,
                         flush_window_us=flush_window_us, verify=verify,
                         device=device)
        self._mesh_shards = n_shards
        self.devices = devices
        self._sharded_step = make_sharded_deps_step(n_shards,
                                                    devices=devices)

    @classmethod
    def factory(cls, n_shards: int = 8, flush_window_us: int = 0,
                verify: bool = False, device=None, devices=None):
        return lambda i, node, ranges: cls(
            i, node, ranges, flush_window_us=flush_window_us, verify=verify,
            n_shards=n_shards, device=device, devices=devices)

    def _precompute(self, window) -> None:
        self._precomputed = {}
        probes = self._collect_deps_probes(window)
        if not probes:
            return

        t = self.profiler.begin()
        with span("accord.deps.snapshot"):
            cfks, versions, committed_versions = self._probe_snapshots(
                probes)
        with span("accord.deps.encode"):
            # PAD-granular shape bucketing (not the encoder's default
            # pad=8), as the JAX store buckets the shapes of its shared
            # jitted step
            enc = ShardedEncoder.for_probes(
                cfks, probes, n_shards=self._mesh_shards, pad=PAD)
            args = enc.args()
        deps_args = args[:7] + args[8:]
        with span("accord.deps.upload"):
            if self.devices is None:
                placed = window_to_tensors(args, device=self.device)
                placed = placed[:7] + placed[8:]
            else:
                placed = shard_to_devices(deps_args, self._mesh_shards,
                                          self.devices)
        t = self.profiler.lap(t, "sharded_encode")
        with span("accord.deps.launch"):
            self._note_compile_shape(*(getattr(a, "shape", None)
                                       for a in args[:7]), kernel="sharded")
            if self.devices is None:
                dep_mask, _count = self._sharded_step(*placed)
            else:
                dep_mask, _count = self._sharded_step.run(placed)
        with span("accord.deps.download"):
            mask_host = dep_mask_to_host(dep_mask)
        t = self.profiler.lap(t, "sharded_kernel")
        with span("accord.deps.decode"):
            keyed = enc.decode_key_deps(mask_host)
        self.profiler.lap(t, "sharded_decode")
        self._count_deps_flush(
            placed if self.devices is None
            else [a for block in placed for a in block], mask_host,
            sum(len(es) for es in enc.entries_per), "python")
        with span("accord.deps.install"):
            self._install_probes(probes, keyed, versions, committed_versions)
