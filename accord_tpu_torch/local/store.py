"""CommandStore / SafeCommandStore / CommandStores: the sharded replica state.

Reference: accord/local/CommandStore.java:80-727 (single-threaded metadata
shard), SafeCommandStore.java:56+ (the transactional view and conflict query
API), CommandStores.java:78-726 (range-sharded fan-out with map-reduce),
ShardDistributor.EvenSplit (ShardDistributor.java:33-46), PreLoadContext
(PreLoadContext.java:42).

Intra-node parallelism model is the reference's: the node's owned keyspace is
split over N logically single-threaded CommandStore shards; every operation
declares what it touches (PreLoadContext) and runs on each intersecting shard
via `execute`, with replies reduced across shards.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple, TYPE_CHECKING

from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus, TimestampsForKey, Unmanaged
from accord_tpu_torch.local.command import Command
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.local.watermarks import DurableBefore, MaxConflicts, RedundantBefore
from accord_tpu_torch.obs.profiler import span
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import (EMPTY_KEYS, Key, Keys, Range, Ranges,
                                        RoutingKey, _SortedKeyList)
from accord_tpu_torch.primitives.timestamp import KindSet, Timestamp, TxnId
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult

if TYPE_CHECKING:
    from accord_tpu_torch.api.spi import Agent, DataStore, ProgressLog


class PreLoadContext:
    """Declares the TxnIds/keys an operation touches so async store
    implementations can page them in (PreLoadContext.java:42). The in-memory
    store ignores it; the simulator uses it to model cache-miss delays.

    `deps_probes` — optional (before, KindSet, keys) tuples declaring the
    active-conflict scans the operation will run, letting a batched device
    store precompute them for the whole flush window in one kernel call."""

    __slots__ = ("txn_ids", "keys", "deps_probes", "recovery_probes",
                 "execute_probes")

    def __init__(self, txn_ids: Sequence[TxnId] = (), keys=None,
                 deps_probes: Sequence = (), recovery_probes: Sequence = (),
                 execute_probes: Sequence = ()):
        self.txn_ids = tuple(txn_ids)
        self.keys = keys if keys is not None else EMPTY_KEYS
        self.deps_probes = tuple(deps_probes)
        # (txn_id, Keys) of BeginRecovery's mapReduceFull predicate scans —
        # the batched device store precomputes them per flush window
        self.recovery_probes = tuple(recovery_probes)
        # (txn_id, execute_at, Keys) of executions this operation delivers
        # (Apply messages): the batched device store plans the window's
        # apply order with the wavefront kernel (ops/wavefront.py)
        self.execute_probes = tuple(execute_probes)

    @classmethod
    def empty(cls) -> "PreLoadContext":
        return cls()

    @classmethod
    def for_txn(cls, txn_id: TxnId, keys=None,
                deps_probes: Sequence = (),
                recovery_probes: Sequence = (),
                execute_probes: Sequence = ()) -> "PreLoadContext":
        return cls((txn_id,), keys, deps_probes, recovery_probes,
                   execute_probes)


class SafeCommandStore:
    """The view handed to operations executing on a shard
    (SafeCommandStore.java:56). Provides command access, CFK registration, and
    the conflict query API (mapReduceActive / recovery scans)."""

    def __init__(self, store: "CommandStore", context: PreLoadContext):
        self.store = store
        self.context = context

    # -- command access --
    def get(self, txn_id: TxnId) -> Command:
        return self.store._get_or_create(txn_id)

    def if_present(self, txn_id: TxnId) -> Optional[Command]:
        return self.store.commands.get(txn_id)

    def if_initialised(self, txn_id: TxnId) -> Optional[Command]:
        c = self.store.commands.get(txn_id)
        return c if c is not None and c.save_status != SaveStatus.NOT_DEFINED \
            else None

    # -- environment --
    @property
    def ranges(self) -> Ranges:
        return self.store.ranges

    @property
    def agent(self) -> "Agent":
        return self.store.agent

    @property
    def data_store(self) -> "DataStore":
        return self.store.data_store

    @property
    def progress_log(self) -> "ProgressLog":
        return self.store.progress_log

    @property
    def node(self):
        return self.store.node

    def time_now(self) -> Timestamp:
        return self.store.unique_now()

    # -- CFK maintenance --
    def cfk(self, key: Key) -> CommandsForKey:
        return self.store._cfk(key)

    def tfk(self, key: Key) -> TimestampsForKey:
        return self.store._tfk(key)

    def is_safe_to_read(self, selection) -> bool:
        """Is the data for `selection` (Keys or Ranges, already owned-sliced)
        locally complete? (reference SafeToRead epochs)"""
        safe = self.store.safe_to_read
        if isinstance(selection, Ranges):
            return selection.subtract(safe).is_empty
        return all(safe.contains(k) for k in selection)

    def owned_keys_of(self, command: Command) -> Keys:
        """The command's participating data keys owned by this store. For
        range-domain commands, the keys with local conflict state inside the
        owned ranges (range txns have no enumerable key set of their own)."""
        if command.partial_txn is not None and isinstance(command.partial_txn.keys, Keys):
            # identity-memoized: register() recomputes this slice on every
            # transition of the same command over the same immutable
            # (keys, ranges) pair — both are replaced wholesale on change
            keys, ranges = command.partial_txn.keys, self.ranges
            memo = command.owned_keys_memo
            if memo is not None and memo[0] is keys and memo[1] is ranges:
                return memo[2]
            owned = keys.slice(ranges)
            command.owned_keys_memo = (keys, ranges, owned)
            return owned
        if command.txn_id.is_range_domain:
            ranges = None
            if command.partial_txn is not None:
                ranges = command.partial_txn.keys
            elif command.route is not None and not command.route.is_key_domain:
                ranges = command.route.ranges
            if ranges is None:
                return Keys(())
            owned = self._owned_participants(ranges)
            return Keys(self._owned_cfk_keys(owned))
        if command.route is not None and command.route.is_key_domain:
            return Keys([Key(k.token) for k in command.route.keys]).slice(self.ranges)
        return Keys(())

    def register(self, command: Command, status: InternalStatus) -> None:
        """Reflect a command transition into every owned CFK
        (SafeCommandStore registration / CommandsForKey.update). When the
        transition carries deps (ACCEPTED+), each key's CFK receives the
        command's dependency ids AT THAT KEY so it can maintain the
        missing[] divergence encoding."""
        if command.txn_id.is_range_domain:
            return  # range txns are tracked via rangeCommands, not per-key CFK
        key_deps = None
        if status.has_info:
            deps = command.stable_deps if command.stable_deps is not None \
                else command.partial_deps
            key_deps = deps.key_deps if deps is not None else None
        prof = self.store.cpuprof
        txn_id, execute_at = command.txn_id, command.execute_at
        # cfk stage fence (obs/cpuprof.py): ONE batched fence brackets the
        # whole per-key registration walk (not a fence re-entry per key);
        # fired Unmanaged callbacks still run OUTSIDE the fence (they are
        # execution work, not index maintenance) and keep their per-key
        # interleaving — the fence is suspended around them and resumed
        cfks = self.store.cfks
        # owned-key routing resolves OUTSIDE the fence: the cfk stage
        # measures conflict-index maintenance, not key-set slicing
        keys = self.owned_keys_of(command)
        t = prof.stage_begin() if prof is not None and prof.active else None
        # one span over the walk; the spans of fired callbacks nest in it
        with span("accord.op.index"):
            for key in keys:
                dep_ids = key_deps.txn_ids_for_key(key) \
                    if key_deps is not None else None
                cfk = cfks.get(key)
                if cfk is None:
                    cfk = self.store._cfk(key)
                fired = cfk.update(txn_id, status, execute_at,
                                   dep_ids=dep_ids)
                if fired:
                    if t is not None:
                        prof.stage_end(t, "cfk")
                        t = None
                    for u in fired:
                        u.callback(self)
                    if prof is not None and prof.active:
                        t = prof.stage_begin()
        if t is not None:
            prof.stage_end(t, "cfk")

    def register_range_txn(self, command: Command, ranges: Ranges) -> None:
        self.store.range_version += 1
        # append-only registration log: lets a device range probe taken at
        # an older version serve by unioning the additions since its
        # snapshot (deletions are dropped by the live activity filter)
        if self.store.range_log is not None:
            self.store.range_log.append(command.txn_id)
        self.store.range_commands[command.txn_id] = ranges.slice(self.ranges) \
            if not self.ranges.is_empty else ranges

    # -- conflict queries --
    def _owned_participants(self, participants):
        """Slice a Keys/Ranges selection to this store's ranges."""
        if self.ranges.is_empty:
            return participants
        return participants.slice(self.ranges)

    def _owned_cfk_keys(self, ranges: Ranges) -> List[Key]:
        """Data keys with conflict state inside `ranges` (the per-key walk a
        range txn makes over CommandsForKey, CommandsForKey.java range-txn
        registration).  Served by the store's maintained sorted key index —
        two bisects per range instead of a full-dict scan per query."""
        return self.store.cfk_keys_in(ranges)

    def _active_range_conflict(self, txn_id: TxnId, before: Timestamp,
                               kinds: KindSet) -> bool:
        cmd = self.store.commands.get(txn_id)
        if cmd is None or cmd.save_status == SaveStatus.INVALIDATED \
                or cmd.save_status == SaveStatus.ERASED:
            return False
        # TRUNCATED_APPLY (majority-durable, outcome retained) remains a
        # conflict: a lower-id straggler must still witness it so lagging
        # replicas order their writes after it; only ERASE (universal tier,
        # shard fence installed) removes it from witnessing entirely
        return txn_id < before and txn_id.kind in kinds

    def map_reduce_active(self, participants, before: Timestamp,
                          kinds: KindSet,
                          fn: Callable[[Key, TxnId], None],
                          on_range_dep: Callable[[Ranges, TxnId], None] = None,
                          exclude: Optional[TxnId] = None) -> None:
        """Active-conflict scan — the deps calculation
        (SafeCommandStore.mapReduceActive -> CommandsForKey.mapReduceActive).

        `participants` is Keys (key-domain txn) or Ranges (range-domain /
        sync point). Key-domain conflicts are reported per key via `fn`;
        range-domain conflicts via `on_range_dep(overlap_ranges, dep_id)`
        (they become RangeDeps entries, reference Deps.Builder domain split).

        `exclude` — the querying txn's own id, which the caller filters from
        the result anyway (calculate_deps). The scalar scan ignores it; the
        device store uses it to recognise that the only CFK mutation since
        its snapshot was the querier's own registration.
        """
        is_range = isinstance(participants, Ranges)
        owned = self._owned_participants(participants)
        keys = self._owned_cfk_keys(owned) if is_range else owned

        for key in keys:
            cfk = self.store.cfks.get(key)
            if cfk is not None:
                cfk.map_reduce_active(before, kinds,
                                      lambda t, k=key: fn(k, t))
        self._map_range_conflicts(owned, is_range, before, kinds, fn,
                                  on_range_dep)

    def _map_range_conflicts(self, owned, is_range: bool, before: Timestamp,
                             kinds: KindSet, fn, on_range_dep) -> None:
        """Range-domain txns intersecting the participants are conflicts too.
        Split out so the device store can serve the per-key tier from its
        batched kernel while keeping this tier on the live scalar scan."""
        for txn_id, ranges in self.store.range_commands.items():
            if not self._active_range_conflict(txn_id, before, kinds):
                continue
            if is_range:
                overlap = ranges.intersection(owned)
            else:
                overlap = Ranges([r for r in ranges
                                  if any(r.contains(k) for k in owned)])
            if overlap.is_empty:
                continue
            if on_range_dep is not None:
                on_range_dep(overlap, txn_id)
            else:
                for key in (self._owned_cfk_keys(overlap) if is_range
                            else [k for k in owned if overlap.contains(k)]):
                    fn(key, txn_id)

    def max_conflict(self, participants) -> Optional[Timestamp]:
        return self.store.max_conflicts.get(participants)

    def update_max_conflicts(self, participants, ts: Timestamp) -> None:
        self.store.max_conflicts.update(participants, ts)

    def _witnessed_by(self, by: TxnId, target: TxnId) -> bool:
        """Does `by`'s dependency set include `target`?"""
        cmd = self.store.commands.get(by)
        if cmd is None:
            return False
        for deps in (cmd.stable_deps, cmd.partial_deps):
            if deps is not None and deps.contains(target):
                return True
        return False

    # recovery predicates (BeginRecovery.java:104-190 via mapReduceFull)
    def _participant_cfks(self, participants):
        owned = self._owned_participants(participants)
        keys = (self._owned_cfk_keys(owned) if isinstance(owned, Ranges)
                else owned)
        for key in keys:
            cfk = self.store.cfks.get(key)
            if cfk is not None:
                yield cfk

    def _conflicting_range_cmds(self, txn_id: TxnId, participants):
        """(dep_cmd, overlap Ranges) for every live range-domain command whose
        registered ranges intersect `participants`, excluding txn_id itself."""
        owned = self._owned_participants(participants)
        is_range = isinstance(owned, Ranges)
        for dep_id, ranges in self.store.range_commands.items():
            if dep_id == txn_id:
                continue
            cmd = self.store.commands.get(dep_id)
            if cmd is None:
                continue
            if is_range:
                overlap = ranges.intersection(owned)
            else:
                overlap = Ranges([r for r in ranges
                                  if any(r.contains(k) for k in owned)])
            if not overlap.is_empty:
                yield cmd, overlap

    # The recovery predicates split into a key tier (CommandsForKey scans —
    # overridable by the batched device store) and a range tier (the
    # range-command walk, always live).

    def rejects_fast_path(self, txn_id: TxnId, participants) -> bool:
        return self.decipher_fast_path(txn_id, participants)[0]

    def decipher_fast_path(self, txn_id: TxnId, participants
                           ) -> Tuple[bool, "Deps"]:
        """(rejects, unresolved_covers): the fast-path reject predicates
        with the elision classifier's third verdict surfaced.  `rejects`
        is definite evidence; `unresolved_covers` are key-associated write
        deps whose commit status must resolve before omission evidence at
        this replica can be read either way (CommandsForKey.
        omission_covers) — the recovery coordinator awaits their commit
        and retries, exactly like earlier-accepted-no-witness deps
        (Recover.java:322-336)."""
        rejects, unresolved = self._decipher_fast_path_keys(txn_id,
                                                            participants)
        if not rejects and self._rejects_fast_path_ranges(txn_id,
                                                          participants):
            rejects = True
        if rejects or not unresolved:
            return rejects, Deps.NONE
        from accord_tpu_torch.primitives.deps import KeyDeps
        builder = KeyDeps.builder()
        for key, cover in unresolved:
            builder.add(key, cover)
        return False, Deps(builder.build(), None)

    def _cover_resolver(self):
        """Resolve a cover candidate against the store-wide command
        registry (the per-key view conflates invalidated with
        truncated-applied and drops pruned entries wholesale)."""
        commands = self.store.commands

        def resolve(w: TxnId):
            cmd = commands.get(w)
            if cmd is None:
                return None  # never materialised here / erased: CFK decides
            if cmd.is_invalidated:
                return ("invalid", None)
            if cmd.execute_at is not None \
                    and cmd.has_been(SaveStatus.PRE_COMMITTED):
                return ("committed", cmd.execute_at)
            if cmd.is_truncated:
                return None  # applied-and-shed: executeAt unobservable
            return ("undecided", None)

        return resolve

    def _decipher_fast_path_keys(self, txn_id: TxnId, participants
                                 ) -> Tuple[bool, List[Tuple[Key, TxnId]]]:
        served_a: Dict[Key, List[TxnId]] = {}
        served_b: Dict[Key, List[TxnId]] = {}
        for cfk in self._participant_cfks(participants):
            raw = cfk.started_after_without_witnessing_ids(txn_id, raw=True)
            if raw:
                served_a[cfk.key] = raw
            raw = cfk.executes_after_without_witnessing_ids(txn_id, raw=True)
            if raw:
                served_b[cfk.key] = raw
        return self._classify_omission_maps((served_a, served_b), txn_id)

    def _classify_omission_maps(self, served_maps, txn_id: TxnId
                                ) -> Tuple[bool, List[Tuple[Key, TxnId]]]:
        """The shared host-side classification step over {key: raw
        candidate ids} maps — ONE implementation for the scalar and
        device-served paths, so the soundness-critical evidence /
        elided / unresolved triage cannot diverge between them."""
        resolve = self._cover_resolver()
        unresolved: List[Tuple[Key, TxnId]] = []
        for mapping in served_maps:
            for key, ids in mapping.items():
                evidence, covers = self.cfk(key).classify_omissions(
                    list(ids), txn_id, resolve)
                if evidence:
                    return True, []
                unresolved.extend((key, w) for w in covers)
        return False, unresolved

    def _rejects_fast_path_ranges(self, txn_id: TxnId, participants) -> bool:
        wb = lambda t: self._witnessed_by(t, txn_id)
        for cmd, _ in self._conflicting_range_cmds(txn_id, participants):
            if not cmd.txn_id.witnesses(txn_id) or wb(cmd.txn_id) \
                    or cmd.is_invalidated or cmd.is_truncated:
                continue
            if cmd.txn_id > txn_id and cmd.has_been(SaveStatus.ACCEPTED):
                return True
            if cmd.has_been(SaveStatus.STABLE) and cmd.execute_at is not None \
                    and cmd.execute_at > txn_id:
                return True
        return False

    def earlier_committed_witness(self, txn_id: TxnId, participants) -> Deps:
        """Key/range-associated, so recovery can await on the dep's own shards
        (reference returns Deps, BeginRecovery.java:344)."""
        from accord_tpu_torch.primitives.deps import KeyDeps
        builder = KeyDeps.builder()
        self._earlier_committed_witness_keys(txn_id, participants, builder)
        return Deps(builder.build(),
                    self._earlier_committed_witness_ranges(txn_id,
                                                           participants))

    def _earlier_committed_witness_keys(self, txn_id, participants,
                                        builder) -> None:
        for cfk in self._participant_cfks(participants):
            for t in cfk.stable_started_before_and_witnessed(txn_id):
                builder.add(cfk.key, t)

    def _earlier_committed_witness_ranges(self, txn_id, participants):
        from accord_tpu_torch.primitives.deps import RangeDeps
        wb = lambda t: self._witnessed_by(t, txn_id)
        rbuilder = RangeDeps.builder()
        for cmd, overlap in self._conflicting_range_cmds(txn_id, participants):
            if cmd.txn_id < txn_id and cmd.has_been(SaveStatus.STABLE) \
                    and not cmd.is_invalidated and not cmd.is_truncated \
                    and wb(cmd.txn_id):
                for r in overlap:
                    rbuilder.add(r, cmd.txn_id)
        return rbuilder.build()

    def earlier_accepted_no_witness(self, txn_id: TxnId, participants) -> Deps:
        from accord_tpu_torch.primitives.deps import KeyDeps
        builder = KeyDeps.builder()
        self._earlier_accepted_no_witness_keys(txn_id, participants, builder)
        return Deps(builder.build(),
                    self._earlier_accepted_no_witness_ranges(txn_id,
                                                             participants))

    def _earlier_accepted_no_witness_keys(self, txn_id, participants,
                                          builder) -> None:
        for cfk in self._participant_cfks(participants):
            for t in cfk.accepted_started_before_without_witnessing(txn_id):
                builder.add(cfk.key, t)

    def _earlier_accepted_no_witness_ranges(self, txn_id, participants):
        from accord_tpu_torch.primitives.deps import RangeDeps
        wb = lambda t: self._witnessed_by(t, txn_id)
        rbuilder = RangeDeps.builder()
        for cmd, overlap in self._conflicting_range_cmds(txn_id, participants):
            if cmd.txn_id < txn_id \
                    and cmd.save_status == SaveStatus.ACCEPTED \
                    and cmd.execute_at is not None \
                    and cmd.execute_at > txn_id \
                    and txn_id.witnesses(cmd.txn_id) \
                    and not wb(cmd.txn_id):
                for r in overlap:
                    rbuilder.add(r, cmd.txn_id)
        return rbuilder.build()


class CommandStore:
    """One logically single-threaded metadata shard (CommandStore.java:80).

    `execute(context, fn)` is the only entry point for mutations; the base
    implementation runs inline (synchronous in-memory store). Subclasses
    (accord_tpu_torch.impl / the simulator's DelayedCommandStore) override
    `_submit` to add executor hops, async-load delays, and thread checks.
    """

    def __init__(self, store_id: int, node, ranges: Ranges):
        self.id = store_id
        self.node = node
        self.ranges = ranges
        # ranges whose data is locally complete (initial ownership, or
        # bootstrap finished); reads outside it nack so the coordinator
        # retries a caught-up replica (the reference SafeToRead epochs)
        self.safe_to_read: Ranges = ranges
        self.commands: Dict[TxnId, Command] = {}
        self.cfks: Dict[Key, CommandsForKey] = {}
        # sorted index over cfks (tokens + keys in lockstep): CFKs are only
        # ever created (never dropped — pruning empties them in place), so
        # _cfk() maintains it exactly and range-bounded key queries bisect
        # instead of scanning the whole dict (cfk_keys_in)
        self._cfk_tokens: List[int] = []
        self._cfk_keys: List[Key] = []
        self.tfks: Dict[Key, TimestampsForKey] = {}
        self.range_commands: Dict[TxnId, Ranges] = {}
        # bumped on any range_commands mutation (register/cleanup): the
        # device store's batched range-stab probes are version-gated on it
        self.range_version = 0
        # append-only log of range-txn registrations (incl. re-registered
        # ids): a device probe serves across version bumps by unioning the
        # log suffix past its snapshot into its candidate set.  None on
        # stores with no consumer (the device store enables it and clears
        # it at every flush-window boundary, so it stays bounded)
        self.range_log: Optional[List[TxnId]] = None
        self.max_conflicts = MaxConflicts()
        self.redundant_before = RedundantBefore()
        self.durable_before = DurableBefore()
        # listener-notification drain queue (see commands._notify_listeners)
        from collections import deque
        self.notify_queue = deque()
        # txn_id -> keys with an armed per-key execution gate; swept by the
        # progress log (commands.sweep_key_gates) to keep chasing blockers
        self.gated: Dict[TxnId, set] = {}
        self.notifying = False
        # per-txn count of failed catch-ups where every peer had truncated
        # the deps (Propagate INSUFFICIENT): drives staleness escalation
        self.insufficient_catchups: Dict[TxnId, int] = {}
        # the owning node's protocol-CPU profiler (obs/cpuprof.py), cached
        # so the per-key CFK fences in register/calculate_deps cost one
        # attribute check when profiling is off; None on bare-store
        # harnesses whose node stub carries no obs facade
        obs = getattr(node, "obs", None)
        self.cpuprof = getattr(obs, "cpuprof", None)
        # the flight ring, cached for the same reason as cpuprof: status
        # transitions record per command transition and must not re-walk
        # the node->obs->flight attribute chain each time
        self._flight = getattr(obs, "flight", None)
        # bounded-memory paging tier (local/paging.py): only when a
        # resident budget is configured does `commands` become the
        # fault-on-access mapping — unset budget keeps the PLAIN dict
        # above, so paging off is bit-identical to the pre-paging store
        from accord_tpu_torch.local.paging import pager_from_env
        self.pager = pager_from_env(self)
        if self.pager is not None:
            self.commands = self.pager.commands

    # -- environment plumbing --
    @property
    def agent(self):
        return self.node.agent

    @property
    def flight(self):
        """The owning node's flight recorder (obs/flight.py); None on
        bare-store harnesses whose node stub carries no obs facade."""
        return self._flight

    @property
    def data_store(self):
        return self.node.data_store

    @property
    def progress_log(self):
        return self.node.progress_log_for(self)

    def unique_now(self) -> Timestamp:
        return self.node.unique_now()

    # -- state access (only from within execute) --
    def _get_or_create(self, txn_id: TxnId) -> Command:
        cmd = self.commands.get(txn_id)
        if cmd is None:
            cmd = self.commands[txn_id] = Command(txn_id)
        return cmd

    def _cfk(self, key: Key) -> CommandsForKey:
        cfk = self.cfks.get(key)
        if cfk is None:
            cfk = self.cfks[key] = CommandsForKey(key)
            # an evicted-empty CFK (local/paging.py) left its key in the
            # sorted index: restore its residual watermarks instead of
            # double-inserting the index entry
            if self.pager is not None \
                    and self.pager.restore_cfk(key, cfk):
                return cfk
            i = bisect_left(self._cfk_tokens, key.token)
            self._cfk_tokens.insert(i, key.token)
            self._cfk_keys.insert(i, key)
        return cfk

    def cfk_keys_in(self, ranges: Ranges) -> List[Key]:
        """Sorted CFK keys inside `ranges`: two bisects per range over the
        maintained index.  Ranges are normalized (sorted, disjoint), so the
        concatenated slices are exactly
        ``sorted(k for k in cfks if ranges.contains(k))``."""
        toks = self._cfk_tokens
        keys = self._cfk_keys
        out: List[Key] = []
        for r in ranges:
            lo = bisect_left(toks, r.start)
            hi = bisect_left(toks, r.end, lo)
            if lo < hi:
                out.extend(keys[lo:hi])
        return out

    def _tfk(self, key: Key) -> TimestampsForKey:
        tfk = self.tfks.get(key)
        if tfk is None:
            tfk = self.tfks[key] = TimestampsForKey(key)
        return tfk

    # -- execution --
    def execute(self, context: PreLoadContext,
                fn: Callable[[SafeCommandStore], None]) -> None:
        self._submit(context, fn, None)

    def submit(self, context: PreLoadContext,
               fn: Callable[[SafeCommandStore], object]) -> AsyncResult:
        result: AsyncResult = AsyncResult()
        self._submit(context, fn, result)
        return result

    # the store whose task is currently running — the single-threaded-shard
    # affinity check of the reference (CommandStore.current(),
    # CommandStore.java:228; enforced by the Debug store variant)
    _current: Optional["CommandStore"] = None

    @classmethod
    def current(cls) -> Optional["CommandStore"]:
        return cls._current

    def _make_safe(self, context: PreLoadContext) -> SafeCommandStore:
        """The view handed to operations; subclasses may specialise it."""
        return SafeCommandStore(self, context)

    def _submit(self, context: PreLoadContext, fn, result: Optional[AsyncResult]
                ) -> None:
        """Base: run inline. Overridden by async/simulated stores.

        Outcome delivery happens AFTER _current/released are restored so
        success and failure callbacks see identical (post-task) state — a
        failure callback must trip the Debug leak checks exactly like a
        success callback would."""
        value = error = None
        prev = CommandStore._current
        safe = None
        try:
            CommandStore._current = self
            safe = self._make_safe(context)
            value = fn(safe)
        except BaseException as e:  # noqa: BLE001
            error = e
        finally:
            CommandStore._current = prev
            if safe is not None:
                safe.released = True  # leak detection (Debug variant checks)
        if error is not None:
            if result is not None:
                result.set_failure(error)
            else:
                self.agent.on_uncaught_exception(error)
        elif result is not None:
            result.set_success(value)
        # paging-tier evictions are deferred to the TOP-LEVEL operation
        # boundary (after outcome delivery): nested submits and callbacks
        # running under this frame never see a command evicted from under
        # a live reference
        if prev is None and self.pager is not None:
            self.pager.on_op_boundary()

    # -- flush-window pinning (batch envelopes) --
    # A MultiPreAccept envelope (messages/multi.py) pins every store's
    # flush window while its parts apply, so a batching store resolves the
    # whole envelope as ONE fused window.  The base store runs inline and
    # has no window: no-ops.  (DeviceCommandStore implements them.)
    def hold_flush(self) -> None:
        pass

    def release_flush(self) -> None:
        pass

    def update_ranges(self, ranges: Ranges, unsafe: Ranges = None) -> None:
        """Add the current epoch's assignment. Serving ranges only GROW (the
        reference's per-epoch RangesForEpoch, CommandStore.java:96): old-epoch
        messages — recovery of era transactions, fetches of their outcomes —
        must still reach the command state this store accumulated while it
        owned them. Routing for new epochs is the sender's job (scope
        computation against the current topology). `unsafe` = node-level
        newly-acquired ranges pending bootstrap."""
        self.ranges = self.ranges.union(ranges)
        fresh = ranges.subtract(unsafe) if unsafe is not None else ranges
        self.safe_to_read = self.safe_to_read.union(fresh)

    def mark_safe_to_read(self, ranges: Ranges) -> None:
        self.safe_to_read = self.safe_to_read.union(
            ranges.slice(self.ranges) if not self.ranges.is_empty else ranges)

    def __repr__(self):
        return f"CommandStore#{self.id}({self.ranges!r})"


class EvenSplit:
    """ShardDistributor.EvenSplit: split owned token span evenly over N shards
    (ShardDistributor.java:33-46)."""

    def __init__(self, count: int):
        invariants.check_argument(count > 0, "need at least one shard")
        self.count = count

    def split(self, ranges: Ranges) -> List[Ranges]:
        total = sum(r.end - r.start for r in ranges)
        if total == 0 or self.count == 1:
            return [ranges] + [Ranges.EMPTY] * (self.count - 1)
        out: List[Ranges] = []
        per = total / self.count
        flat: List[Range] = list(ranges)
        acc: List[Range] = []
        acc_len = 0
        target = per
        taken = 0
        for r in flat:
            start = r.start
            while start < r.end:
                remaining_here = r.end - start
                need = target - (taken + acc_len)
                if remaining_here <= need or len(out) == self.count - 1:
                    acc.append(Range(start, r.end))
                    acc_len += r.end - start
                    start = r.end
                else:
                    take = max(1, int(need))
                    acc.append(Range(start, start + take))
                    acc_len += take
                    start += take
                    taken += acc_len
                    out.append(Ranges(acc, _normalized=True))
                    acc, acc_len = [], 0
                    target = per * (len(out) + 1)
        out.append(Ranges(acc))
        while len(out) < self.count:
            out.append(Ranges.EMPTY)
        return out[:self.count]


class EmptyFanout(RuntimeError):
    """A fanned-out request found no intersecting store on this node."""


def _flatten_reply(result: AsyncResult) -> AsyncResult:
    """Requests may return a Reply or an AsyncResult[Reply]; flatten."""
    from accord_tpu_torch.utils.async_chains import success
    return result.flat_map(
        lambda v: v if isinstance(v, AsyncResult) else success(v))


class CommandStores:
    """The node's shard manager (CommandStores.java:78): owns N CommandStores
    over an EvenSplit of the node's ranges; fans operations out over
    intersecting shards and chains the reduce."""

    # True on the worker-runtime tier (shard/supervisor.WorkerCommandStores):
    # stores live in per-shard processes and `all()` has nothing to walk —
    # callers that need node-wide store folds (audit digests, census) must
    # go through the supervisor's fan-out instead
    remote = False

    def __init__(self, node, num_shards: int = 1,
                 store_factory: Callable[[int, object, Ranges], CommandStore] = None):
        self.node = node
        self.num_shards = num_shards
        self.store_factory = store_factory or CommandStore
        self.stores: List[CommandStore] = []
        self._splitter = EvenSplit(num_shards)

    def initialize(self, ranges: Ranges) -> None:
        splits = self._splitter.split(ranges)
        self.stores = [self.store_factory(i, self.node, splits[i])
                       for i in range(self.num_shards)]

    def update_topology(self, ranges: Ranges) -> Ranges:
        """Re-split on topology change; returns ranges newly added to this node
        (which require bootstrap). Reference CommandStores.updateTopology
        (:401-481) — our EvenSplit re-splits in place; stores keep their
        existing state and simply gain/lose ranges."""
        if not self.stores:
            self.initialize(ranges)
            return ranges
        old = Ranges.EMPTY
        for s in self.stores:
            old = old.union(s.ranges)
        added = ranges.subtract(old)
        splits = self._splitter.split(ranges)
        for i, s in enumerate(self.stores):
            s.update_ranges(splits[i], unsafe=added)
        return added

    def all(self) -> List[CommandStore]:
        return list(self.stores)

    def intersecting(self, participants) -> List[CommandStore]:
        if participants is None:
            return self.all()
        out = []
        for s in self.stores:
            if s.ranges.is_empty:
                continue
            if isinstance(participants, _SortedKeyList):
                if participants.intersects_ranges(s.ranges):
                    out.append(s)
            elif isinstance(participants, Ranges):
                if s.ranges.intersects(participants):
                    out.append(s)
            else:
                raise TypeError(type(participants))
        return out

    def shard_of(self, participants) -> int:
        """Index of the first shard a participant set lands on (admission
        accounting: per-(tenant, shard) QoS buckets key on this)."""
        for i, s in enumerate(self.stores):
            if s.ranges.is_empty:
                continue
            if isinstance(participants, _SortedKeyList):
                if participants.intersects_ranges(s.ranges):
                    return i
            elif isinstance(participants, Ranges):
                if s.ranges.intersects(participants):
                    return i
        return 0

    def map_reduce_request(self, request, consume) -> None:
        """Fan a TxnRequest out over intersecting command stores and chain
        the reduce (CommandStores.mapReduceConsume, :546-640), delivering
        (value, failure) to `consume` exactly once.  The worker runtime
        overrides this to ship the same request over per-shard pipes."""
        participants = request.participants()
        probe = request.deps_probe()
        rprobe = request.recovery_probe()
        xprobe = request.execute_probe()
        context = PreLoadContext.for_txn(
            request.txn_id, deps_probes=(probe,) if probe is not None else (),
            recovery_probes=(rprobe,) if rprobe is not None else (),
            execute_probes=(xprobe,) if xprobe is not None else ())
        stores = self.intersecting(participants)
        if not stores:
            consume(None, EmptyFanout("no intersecting store"))
            return
        if len(stores) == 1:
            raw = stores[0].submit(context, request.apply)
            if raw._done and raw._failure is None \
                    and not isinstance(raw._value, AsyncResult):
                # synchronous single-shard dispatch (the host-tier common
                # case): the reply is already in hand — skip the
                # flatten/all_of chain machinery entirely
                consume(raw._value, None)
                return
            pending: List[AsyncResult] = [_flatten_reply(raw)]
        else:
            pending = [_flatten_reply(s.submit(context, request.apply))
                       for s in stores]
        from accord_tpu_torch.utils import async_chains

        def finish(values, failure):
            if failure is not None:
                consume(None, failure)
                return
            acc = values[0]
            for v in values[1:]:
                acc = request.reduce(acc, v)
            consume(acc, None)

        async_chains.all_of(pending).add_callback(finish)

    def for_each(self, context: PreLoadContext, participants,
                 fn: Callable[[SafeCommandStore], None]) -> None:
        for s in self.intersecting(participants):
            s.execute(context, fn)

    def map_reduce(self, context: PreLoadContext, participants,
                   map_fn: Callable[[SafeCommandStore], object],
                   reduce_fn: Callable[[object, object], object]) -> AsyncResult:
        """Fan out over intersecting shards; chain the reduce
        (CommandStores.mapReduceConsume, :546-640)."""
        stores = self.intersecting(participants)
        if not stores:
            from accord_tpu_torch.utils.async_chains import success
            return success(None)
        results = [s.submit(context, map_fn) for s in stores]
        from accord_tpu_torch.utils import async_chains
        return async_chains.reduce(results, reduce_fn)


# rebind the flight-recorder hook in local.command (which cannot import this
# module — store.py imports Command above): status transitions resolve the
# store they run inside via CommandStore.current()
from accord_tpu_torch.local import command as _command_module  # noqa: E402

_command_module._current_store = CommandStore.current
