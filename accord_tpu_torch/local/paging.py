"""Evictable paging tier: bounded-memory command store over the spill store.

Reference: accord's pluggable storage layer (accord/api/*, PAPER.md §1) —
the reference makes command storage an interface precisely so real hosts
page command state to disk instead of holding millions of Commands
resident.  This module is that tier for our CommandStore: quiescent
commands spill to `journal/fault_index.SpillStore` frames and fault back on
access BEHIND the existing access paths, so the protocol never observes a
missing command.

Residency policy
----------------
`ACCORD_RESIDENT_CMDS` (commands per CommandStore) and/or
`ACCORD_RESIDENT_BYTES` (estimated payload bytes per CommandStore, divided
by the running average spill-frame size) bound the resident tier; unset or
0 means unbounded — `pager_from_env` then returns None and the store keeps
a PLAIN dict, so paging off is bit-identical to the pre-paging code, not
merely equivalent.

Eviction eligibility — a command may leave memory only when nothing can
still mutate or synchronously reference it:

  * terminal save status (APPLIED / INVALIDATED / TRUNCATED_APPLY /
    ERASED) — the quiescent set the census tracks;
  * no listeners and no transient listeners;
  * no armed per-key execution gate (store.gated);
  * key-domain only (range commands stay resident: the range-conflict
    scans walk `range_commands` against live Command state).

Within the eligible set, cleanup's bounds order the victims: commands
below the shard-applied `RedundantBefore` fence or already
majority-durable evict first (cleanup would truncate them anyway), the
rest only when the budget still overflows.  Age-since-quiescence is
approximated by dict insertion order (oldest first — the census age
signal's cheap stand-in) with a second-chance set: a refaulted command
survives one sweep before it is eligible again (clock/LRU second chance).

Evictions are DEFERRED to operation boundaries: `CommandStore._submit`
calls `on_op_boundary()` only when returning to the top level (nested
submits skip it), so no live SafeCommandStore can hold a reference to a
command evicted under it.

Faults are single-frame point reads (the fault index maps TxnId to an
exact segment offset).  A fault REMOVES the spill entry: the resident copy
becomes the single source of truth and a later re-eviction re-spills the
then-current state — which is what makes refault-then-truncate ordering
safe by construction (the truncation mutates the resident copy; the stale
frame is already dead).

Cold CommandsForKey entries page too: an EMPTY cfk (fully pruned, no
pending waits) is dropped from `store.cfks`, leaving its key in the
store's sorted key index and a residual (redundant_before, version,
committed_version) here; `CommandStore._cfk` restores the residual on next
touch without re-inserting the index entry.

Audit/census contract: for every spilled command the pager retains the
audit metadata the resident husk would have reported — (entry_class,
audit scope, census class, durability, quiescent-uncleaned flag) — so
cross-replica digests, drill-downs, and `accord_census_*` see identical
state whether a command is resident or spilled, and eviction is
count-neutral for the leak detector.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple

from accord_tpu_torch.local.status import Durability, SaveStatus

# the quiescent terminal statuses (superset of the census's
# _QUIESCENT_UNCLEANED: truncated/erased husks are also evictable)
_EVICTABLE = frozenset((SaveStatus.APPLIED, SaveStatus.INVALIDATED,
                        SaveStatus.TRUNCATED_APPLY, SaveStatus.ERASED))

# sweep down to budget - budget/8 so sweeps amortize to O(1) per op
_HYSTERESIS_SHIFT = 3


def pager_from_env(store) -> Optional["Pager"]:
    """A Pager when a resident budget is configured, else None (the store
    then keeps its plain dict — zero indirection when paging is off)."""
    cmds = _env_int("ACCORD_RESIDENT_CMDS")
    byts = _env_int("ACCORD_RESIDENT_BYTES")
    if cmds <= 0 and byts <= 0:
        return None
    return Pager(store, max_cmds=cmds, max_bytes=byts)


def _env_int(name: str) -> int:
    try:
        return int(os.environ.get(name, "0") or "0")
    except ValueError:
        return 0


class PagedCommands(dict):
    """The store's `commands` mapping with fault-on-access.

    Iteration / len / values cover the RESIDENT tier only (cleanup sweeps,
    census, and the audit walk handle the spilled tier explicitly via the
    pager); membership and item access cover BOTH tiers, so every protocol
    path — all of which reach commands via get()/[]/in — transparently
    faults spilled state back in."""

    __slots__ = ("pager",)

    def __init__(self, pager: "Pager"):
        super().__init__()
        self.pager = pager

    def get(self, key, default=None):
        v = dict.get(self, key)
        if v is not None:
            self.pager.hits += 1
            return v
        pager = self.pager
        pager.misses += 1
        if key in pager.spilled:
            return pager.fault(key)
        return default

    def __getitem__(self, key):
        try:
            v = dict.__getitem__(self, key)
        except KeyError:
            self.pager.misses += 1
            if key in self.pager.spilled:
                return self.pager.fault(key)
            raise
        self.pager.hits += 1
        return v

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self.pager.spilled

    def pop(self, key, *default):
        # the single removal path (ephemeral reads): fault first so the
        # spill entry cannot survive its command
        if not dict.__contains__(self, key) and key in self.pager.spilled:
            self.pager.fault(key)
        return dict.pop(self, key, *default)

    def setdefault(self, key, default=None):
        v = self.get(key)
        if v is None:
            dict.__setitem__(self, key, default)
            return default
        return v


class Pager:
    """Residency policy + spill/fault machinery for ONE CommandStore."""

    def __init__(self, store, max_cmds: int = 0, max_bytes: int = 0):
        self.store = store
        self.max_cmds = max_cmds
        self.max_bytes = max_bytes
        self.commands = PagedCommands(self)
        # TxnId -> (seg, off) mirror of the SpillStore index; also the
        # "is spilled" membership test before the store is even created
        self.spilled: Dict = {}
        # TxnId -> (entry_class, audit_scope, census_class, durability
        #           name, quiescent_uncleaned) captured at spill time —
        # byte-for-byte what the resident husk would report to the audit
        # walk and the census
        self.meta: Dict = {}
        # evicted-empty CFK residuals: Key -> (redundant_before, version,
        # committed_version)
        self.cfk_residuals: Dict = {}
        # second-chance set: faulted since the last sweep
        self.referenced: set = set()
        # incrementally maintained census aggregates (a sweep must stay
        # O(stores), not O(spilled))
        self.spilled_by_class: Dict[str, int] = {}
        self.spilled_uncleaned = 0
        # counters (exported by the census as accord_pager_* gauges)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.refaults = 0
        self.cfk_evictions = 0
        self.cfk_restores = 0
        self.resident_high_water = 0
        self._spill_store = None
        self._spill_dir: Optional[str] = None

    # ----------------------------------------------------------- budget --
    def budget(self) -> int:
        """Effective resident-command budget: the command cap and/or the
        byte cap divided by the running average spill-frame size."""
        b = self.max_cmds if self.max_cmds > 0 else 0
        if self.max_bytes > 0:
            avg = 512
            s = self._spill_store
            if s is not None and s.frames_written:
                avg = max(64, s.disk_bytes // s.frames_written)
            by = max(1, self.max_bytes // avg)
            b = by if b <= 0 else min(b, by)
        return b

    def spill_store(self):
        """Lazily created on first eviction: under the node WAL's directory
        when one exists (journal-backed), else a scratch tempdir.  Always a
        fresh per-incarnation store — WAL replay re-derives residency."""
        if self._spill_store is None:
            from accord_tpu_torch.journal.fault_index import SpillStore
            journal = getattr(self.store.node, "journal", None)
            base = getattr(journal, "directory", None)
            if base is None:
                base = tempfile.mkdtemp(prefix="accord-spill-")
            directory = os.path.join(base, f"spill-{self.store.id}")
            self._spill_dir = directory
            self._spill_store = SpillStore(directory, fresh=True,
                                           flight=self.store._flight)
        return self._spill_store

    # ------------------------------------------------------------ fault --
    def fault(self, txn_id):
        """Bring one spilled command back resident (single-frame read).
        The frame goes dead; the resident copy is now the only truth."""
        cmd = self._spill_store.fault(txn_id)
        del self.spilled[txn_id]
        del self.meta[txn_id]
        self._note_unspilled(cmd.save_status)
        dict.__setitem__(self.commands, txn_id, cmd)
        self.refaults += 1
        self.referenced.add(txn_id)
        n = len(self.commands)
        if n > self.resident_high_water:
            self.resident_high_water = n
        flight = self.store._flight
        if flight is not None:
            flight.record("cmd_fault", str(txn_id),
                          (self.store.id, cmd.save_status.name))
        return cmd

    # --------------------------------------------------------- eviction --
    def on_op_boundary(self) -> None:
        """Called by CommandStore._submit when returning to the top level
        (after outcome delivery): the only point evictions run."""
        n = len(self.commands)
        if n > self.resident_high_water:
            self.resident_high_water = n
        budget = self.budget()
        if budget <= 0:
            return
        if n > budget:
            low = max(1, budget - (budget >> _HYSTERESIS_SHIFT))
            self._sweep(n - low)
        # the CFK shell count gets the same budget but its own trigger: a
        # quiesced store (commands under budget) must still shed the
        # million cold per-key shells cleanup just emptied
        if len(self.store.cfks) > budget:
            self._sweep_cfks(budget)

    def _sweep(self, want: int) -> None:
        store = self.store
        gated = store.gated
        range_cmds = store.range_commands
        fence = None
        if not store.ranges.is_empty:
            fence = store.redundant_before.min_shard_applied_before(
                store.ranges)
        bounded = []   # below cleanup fence / majority-durable: evict first
        rest = []
        referenced = self.referenced
        for txn_id, cmd in list(self.commands.items()):
            if cmd.save_status not in _EVICTABLE:
                continue
            if cmd.listeners or cmd.transient_listeners:
                continue
            if txn_id in gated or txn_id in range_cmds \
                    or txn_id.is_range_domain:
                continue
            if txn_id in referenced:
                referenced.discard(txn_id)  # second chance: survive once
                continue
            if (fence is not None and txn_id < fence) \
                    or cmd.durability >= Durability.MAJORITY:
                bounded.append((txn_id, cmd))
            else:
                rest.append((txn_id, cmd))
        evicted = 0
        for txn_id, cmd in bounded:
            if evicted >= want:
                break
            self._evict(txn_id, cmd)
            evicted += 1
        for txn_id, cmd in rest:
            if evicted >= want:
                break
            self._evict(txn_id, cmd)
            evicted += 1

    def _evict(self, txn_id, cmd) -> None:
        from accord_tpu_torch.local.audit import (_QUIESCENT_UNCLEANED,
                                            _STATUS_CLASS, _audit_scope,
                                            entry_class)
        st = cmd.save_status
        cls = _STATUS_CLASS.get(st, "other")
        uncleaned = st in _QUIESCENT_UNCLEANED
        self.meta[txn_id] = (entry_class(cmd), _audit_scope(cmd), cls,
                             cmd.durability.name, uncleaned)
        self.spilled[txn_id] = self.spill_store().spill(cmd)
        self.spilled_by_class[cls] = self.spilled_by_class.get(cls, 0) + 1
        if uncleaned:
            self.spilled_uncleaned += 1
        dict.__delitem__(self.commands, txn_id)
        self.evictions += 1
        flight = self.store._flight
        if flight is not None:
            flight.record("cmd_evict", str(txn_id),
                          (self.store.id, st.name))

    def _note_unspilled(self, save_status) -> None:
        from accord_tpu_torch.local.audit import (_QUIESCENT_UNCLEANED,
                                            _STATUS_CLASS)
        cls = _STATUS_CLASS.get(save_status, "other")
        n = self.spilled_by_class.get(cls, 0) - 1
        if n > 0:
            self.spilled_by_class[cls] = n
        else:
            self.spilled_by_class.pop(cls, None)
        if save_status in _QUIESCENT_UNCLEANED:
            self.spilled_uncleaned -= 1

    # ------------------------------------------------------------- CFKs --
    def _sweep_cfks(self, budget: int) -> None:
        """Page out EMPTY CommandsForKey shells (fully pruned, no pending
        waits) once their count exceeds the same budget: the object is
        dropped, its key stays in the store's sorted index, and a tiny
        residual preserves the pruning watermarks for restoration."""
        store = self.store
        cfks = store.cfks
        n = len(cfks)
        if n <= budget:
            return
        low = max(1, budget - (budget >> _HYSTERESIS_SHIFT))
        want = n - low
        victims = []
        for key, cfk in cfks.items():
            if len(victims) >= want:
                break
            if cfk.size() != 0 or cfk._wait_heap:
                continue
            if cfk._block_heap and cfk._min_block_point() is not None:
                # a LIVE block point pins the shell; _min_block_point also
                # lazily drains heap debris left by prune_redundant, so a
                # fully-pruned shell comes back None with an empty heap
                continue
            victims.append((key, cfk))
        for key, cfk in victims:
            self.cfk_residuals[key] = (cfk.redundant_before, cfk.version,
                                       cfk.committed_version)
            del cfks[key]
            self.cfk_evictions += 1

    def restore_cfk(self, key, cfk) -> bool:
        """Re-arm a freshly created CFK from an eviction residual; True
        when `key` was evicted (its sorted-index entry already exists, so
        `_cfk` must NOT insert it again)."""
        residual = self.cfk_residuals.pop(key, None)
        if residual is None:
            return False
        cfk.redundant_before, cfk.version, cfk.committed_version = residual
        self.cfk_restores += 1
        return True

    # ------------------------------------------------------------ stats --
    def stats(self) -> Dict[str, int]:
        s = self._spill_store
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "refaults": self.refaults,
            "resident": len(self.commands),
            "resident_high_water": self.resident_high_water,
            "spilled": len(self.spilled),
            "cfk_evictions": self.cfk_evictions,
            "cfk_restores": self.cfk_restores,
            "spill_disk_bytes": s.disk_bytes if s is not None else 0,
            "spill_compactions": s.compactions if s is not None else 0,
        }

    def close(self) -> None:
        if self._spill_store is not None:
            self._spill_store.close(final_checkpoint=False)


def node_paging_stats(node) -> Optional[Dict[str, int]]:
    """Summed pager stats across a node's command stores, or None when
    paging is off (no store has a pager)."""
    total: Optional[Dict[str, int]] = None
    for store in node.command_stores.all():
        pager = getattr(store, "pager", None)
        if pager is None:
            continue
        s = pager.stats()
        if total is None:
            total = dict(s)
        else:
            for k, v in s.items():
                total[k] += v
    return total
