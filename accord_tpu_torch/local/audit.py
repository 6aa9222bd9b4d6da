"""Live replica-state auditor: cross-replica range digests, drill-down
divergence forensics, and the state-lifecycle census.

No reference counterpart — the reference verifies correctness offline (the
deterministic sim's burn checkers + Elle); a production host serving real
traffic needs ONLINE verification: a replica that silently diverges (bad
replay, codec bug, cleanup error, bit rot) must be caught by the cluster
itself, not by a sim seed that happens to reproduce it.

Two always-on surfaces, one `Auditor` per node:

DIGESTS — for every shard this node replicates, fold the decided command
state per audited range into one order-insensitive 128-bit digest (XOR of
per-transaction leaves over canonical wire packings) and compare it with
every peer replica via the read-only AUDIT_DIGEST verbs.  The window is
bounded by NEGOTIATED watermarks so replicas at different cleanup /
truncation / bootstrap points still agree:

    lo = max over replicas of (bootstrapped_at | stale fence)   — below it
         a replica's history is legitimately a snapshot-shaped hole
    hi = min over replicas of the universal-durable floor       — below it
         EVERY replica is certified applied-or-invalidated, so the decided
         set in [lo, hi) is fixed and identical across replicas

Within the window only "committed" decisions (real executeAt) are folded;
INVALIDATED and truncated-with-unknown-decision entries are excluded from
the digest (their presence is legitimately asymmetric) but reported by the
drill-down, where invalidated-vs-committed IS a hard divergence.  On a
digest mismatch the auditor bisects the window by txn-id midpoint with
further digest requests until it is enumerable, fetches per-transaction
entries (AUDIT_ENTRIES), and classifies them (obs/audit.py): the first
divergent transaction, its kind, and the disagreeing replicas are recorded
(flight kind `audit_divergence`, trace id = the txn repr) so the stitched
cross-replica flight timeline names the exact history.

CENSUS — a periodic sweep over the command stores and CommandsForKey
exporting resident-count/byte gauges by status and durability class,
age-since-quiescence quantiles, and the cleanup/durability watermarks
(`RedundantBefore` / `DurableBefore` floors + their distance from the HLC)
as per-node gauges; a leak detector (obs/audit.LeakDetector) alarms when
quiescent-but-uncleaned state grows monotonically — the residency data the
ROADMAP's journal-backed bounded-memory command store needs.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List, Optional, Tuple

from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.messages.audit import (AuditDigest, AuditDigestOk,
                                       AuditEntries, AuditEntriesOk)
from accord_tpu_torch.messages.base import FunctionCallback
from accord_tpu_torch.obs.audit import LeakDetector, classify_entry_sets
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp, TXNID_NONE

_LEAF_VERSION = b"accord-audit-v1"


# ------------------------------------------------------------ digest walk --

def entry_leaf(txn_id, execute_at) -> int:
    """128-bit leaf for one decided transaction, over the canonical wire
    packings (Timestamp.pack is the $T/$I wire form) — replicas hash the
    DECISION (txn_id, executeAt), never local progress, so APPLIED here and
    ERASED there fold identically."""
    a = txn_id.pack()
    b = execute_at.pack()
    blob = b"%s|%d:%d:%d|%d:%d:%d" % (_LEAF_VERSION, a[0], a[1], a[2],
                                      b[0], b[1], b[2])
    return int.from_bytes(hashlib.blake2b(blob, digest_size=16).digest(),
                          "big")


def _audit_scope(cmd):
    """The command's participants as known locally (route fallback)."""
    if cmd.partial_txn is not None:
        return cmd.partial_txn.keys
    if cmd.route is not None:
        return cmd.route.participants()
    return None


def _in_ranges(parts, ranges: Ranges) -> bool:
    if parts is None:
        return False
    if isinstance(parts, Ranges):
        return ranges.intersects(parts)
    return any(ranges.contains(k) for k in parts)


def _owns_min_token(owned: Ranges, parts, ranges: Ranges) -> bool:
    """Worker-runtime dedup (shard/): does `owned` cover the MINIMAL token
    of `parts` ∩ `ranges`?  The in-process walk dedups a cross-store txn
    with a `seen` set, but per-shard worker processes cannot share one —
    instead every worker applies this filter, and since exactly one worker
    owns any given token, each txn contributes exactly one leaf node-wide
    (XOR folds would cancel pairwise on double-count)."""
    if parts is None:
        return False
    best = None
    if isinstance(parts, Ranges):
        for a in parts:
            for b in ranges:
                s = max(a.start, b.start)
                if s < min(a.end, b.end) and (best is None or s < best):
                    best = s
    else:
        for k in parts:
            if ranges.contains(k) and (best is None or k.token < best):
                best = k.token
    return best is not None and owned.contains_token(best)


def entry_class(cmd) -> Optional[Tuple[str, Optional[Timestamp]]]:
    """Auditable decision of a command, or None when undecided.

    ("committed", executeAt) — decided to execute (PreCommitted..Erased);
    ("invalidated", None)    — decided against;
    ("unknown", None)        — truncated with the decision shed
                               (set_truncated_remotely): compatible with
                               anything, never digested."""
    st = cmd.save_status
    if st < SaveStatus.PRE_COMMITTED:
        return None
    if st == SaveStatus.INVALIDATED:
        return ("invalidated", None)
    if cmd.execute_at is None:
        return ("unknown", None)
    return ("committed", cmd.execute_at)


def node_floors(node, ranges: Ranges) -> Tuple[Timestamp, Timestamp]:
    """(lo, hi) digest floors for this replica over `ranges`: lo = the
    bootstrap/staleness bound (holes below it are legitimate), hi = the
    universal-durable floor (below it this replica is certified complete).
    Uncovered spans floor hi to NONE — no certificate, no window."""
    lo: Timestamp = TXNID_NONE
    hi: Optional[Timestamp] = None
    for store in node.command_stores.all():
        owned = ranges.slice(store.ranges) if not store.ranges.is_empty \
            else ranges
        if owned.is_empty:
            continue
        b = store.redundant_before.audit_low_bound(owned)
        if b > lo:
            lo = b
        _maj, uni = store.durable_before.min_bounds(owned)
        hi = uni if hi is None else min(hi, uni)
    return lo, (hi if hi is not None else TXNID_NONE)


def _walk_decided(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                  owned: Ranges = None):
    """Yield (txn_id, cls, at) once per transaction across the node's
    stores (a multi-key command registered in several stores must
    contribute ONE leaf, or XOR folds would cancel pairwise).  `owned`
    engages the worker-runtime min-token filter (_owns_min_token) so the
    same dedup holds across per-shard processes."""
    seen = set()
    for store in node.command_stores.all():
        for txn_id, cmd in list(store.commands.items()):
            if txn_id in seen or txn_id < lo or not (txn_id < hi):
                continue
            ec = entry_class(cmd)
            if ec is None:
                continue
            scope = _audit_scope(cmd)
            if owned is not None:
                if not _owns_min_token(owned, scope, ranges):
                    continue
            elif not _in_ranges(scope, ranges):
                continue
            seen.add(txn_id)
            yield txn_id, ec[0], ec[1]
        # the paging tier (local/paging.py): spilled commands contribute
        # the SAME (class, executeAt, scope) their resident husks would —
        # captured at spill time, which is sound because every evictable
        # status is decision-terminal (eviction must never perturb the
        # cross-replica digests)
        pager = getattr(store, "pager", None)
        if pager is None:
            continue
        for txn_id, m in list(pager.meta.items()):
            if txn_id in seen or txn_id < lo or not (txn_id < hi):
                continue
            ec = m[0]
            if ec is None:
                continue
            if owned is not None:
                if not _owns_min_token(owned, m[1], ranges):
                    continue
            elif not _in_ranges(m[1], ranges):
                continue
            seen.add(txn_id)
            yield txn_id, ec[0], ec[1]


def digest_node(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                owned: Ranges = None) -> Tuple[int, int]:
    """(digest, count): XOR-fold the committed decisions in the window."""
    acc = 0
    count = 0
    for txn_id, cls, at in _walk_decided(node, ranges, lo, hi, owned=owned):
        if cls != "committed":
            continue
        acc ^= entry_leaf(txn_id, at)
        count += 1
    return acc, count


def digest_reply(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                 owned: Ranges = None) -> AuditDigestOk:
    """Serve one AUDIT_DIGEST_REQ: digest over the REQUESTED window plus
    this replica's own floors for the negotiation."""
    acc, count = digest_node(node, ranges, lo, hi, owned=owned)
    flo, fhi = node_floors(node, ranges)
    return AuditDigestOk(f"{acc:032x}", count, flo, fhi)


def collect_entries(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                    owned: Ranges = None) -> List[tuple]:
    """Drill-down entry list for the window, sorted by txn id."""
    out = [(txn_id, cls, at)
           for txn_id, cls, at in _walk_decided(node, ranges, lo, hi,
                                                owned=owned)]
    out.sort(key=lambda e: e[0])
    return out


def local_digest(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                 done: Callable) -> None:
    """Serve the auditor's LOCAL digest leg, calling done(AuditDigestOk).
    Synchronous in-loop; under the worker runtime the walk fans over the
    shard pipes (supervisor merge) and `done` fires when they answer."""
    cs = node.command_stores
    if cs.remote:
        from accord_tpu_torch.messages.audit import AuditDigest
        cs.audit_local(AuditDigest(ranges, lo, hi), done)
        return
    done(digest_reply(node, ranges, lo, hi))


def local_entries(node, ranges: Ranges, lo: Timestamp, hi: Timestamp,
                  done: Callable) -> None:
    """Serve the auditor's LOCAL entry-list leg, calling
    done(AuditEntriesOk); worker-aware like local_digest."""
    cs = node.command_stores
    if cs.remote:
        from accord_tpu_torch.messages.audit import AuditEntries
        cs.audit_local(AuditEntries(ranges, lo, hi), done)
        return
    done(AuditEntriesOk(tuple(collect_entries(node, ranges, lo, hi))))


def _midpoint(lo: Timestamp, hi: Timestamp) -> Optional[Timestamp]:
    """A split point strictly inside (lo, hi), or None when the window is
    no longer splittable (bisection then falls back to enumeration)."""
    if lo.epoch == hi.epoch:
        mid_hlc = (lo.hlc + hi.hlc) // 2
        mid = Timestamp(lo.epoch, mid_hlc, 0, 0)
    else:
        mid = Timestamp(hi.epoch, 0, 0, 0)
    if lo < mid < hi:
        return mid
    return None


# ---------------------------------------------------------------- census --

# SaveStatus -> census class (coarse lifecycle buckets; README table)
_STATUS_CLASS = {
    SaveStatus.NOT_DEFINED: "undecided",
    SaveStatus.PRE_ACCEPTED: "undecided",
    SaveStatus.ACCEPTED_INVALIDATE: "undecided",
    SaveStatus.ACCEPTED: "undecided",
    SaveStatus.PRE_COMMITTED: "decided",
    SaveStatus.COMMITTED: "decided",
    SaveStatus.STABLE: "executing",
    SaveStatus.READY_TO_EXECUTE: "executing",
    SaveStatus.PRE_APPLIED: "executing",
    SaveStatus.APPLYING: "executing",
    SaveStatus.APPLIED: "applied",
    SaveStatus.TRUNCATED_APPLY: "truncated",
    SaveStatus.ERASED: "erased",
    SaveStatus.INVALIDATED: "invalidated",
}

# terminal-but-uncleaned: what the cleanup ladder should eventually purge;
# monotonic growth here is the leak the census alarms on
_QUIESCENT_UNCLEANED = (SaveStatus.APPLIED, SaveStatus.INVALIDATED)

_WATERMARK_KINDS = ("locally_applied", "shard_applied", "durable_majority",
                    "durable_universal")


def _quantile(sorted_vals: List[int], q: float) -> int:
    if not sorted_vals:
        return 0
    rank = max(1, min(len(sorted_vals), int(q * len(sorted_vals) + 0.9999999)))
    return int(sorted_vals[rank - 1])


# the retention-heavy Command fields, all wire-registered — what the
# bounded-memory store would have to spill; WaitingOn bitsets / listener
# sets are small and not wire types, charged as a flat overhead
_BYTE_FIELDS = ("txn_id", "execute_at", "route", "partial_txn",
                "partial_deps", "stable_deps", "writes", "result")
_BYTE_OVERHEAD = 64


def _approx_cmd_bytes(cmd) -> int:
    """Wire-encoding size of one command's retained payload fields (the
    census byte estimator's per-sample probe)."""
    from accord_tpu_torch.host.wire import encode
    import json as _json
    total = _BYTE_OVERHEAD
    for attr in _BYTE_FIELDS:
        v = getattr(cmd, attr, None)
        if v is None:
            continue
        try:
            total += len(_json.dumps(encode(v)))
        except TypeError:
            total += _BYTE_OVERHEAD  # host-specific unregistered payload
    return total


def census_node(node, byte_sample: int = 48) -> dict:
    """One sampled lifecycle sweep over the node's command stores and
    CommandsForKey indexes.  Counts are exact; resident bytes are estimated
    from a bounded sample of canonical encodings (the sweep must stay
    inside the always-on <2% budget, tests/test_obs_budget.py)."""

    cs = node.command_stores
    if cs.remote:
        # worker runtime: the stores live in per-shard processes — fold the
        # cached worker censuses (stats poll, ~2s fresh); before the first
        # poll lands, fall through to the storeless walk (a zeroed census)
        merged = cs.merged_census()
        if merged is not None:
            return merged

    now_us = node.obs.now_us()
    by_class: Dict[str, int] = {}
    by_durability: Dict[str, int] = {}
    ages: List[int] = []
    quiescent_uncleaned = 0
    total = 0
    sampled_bytes = 0
    sampled_n = 0
    cfk_keys = 0
    cfk_entries = 0
    gated = 0
    range_cmds = 0
    spilled_total = 0
    spilled_by_class: Dict[str, int] = {}
    spilled_uncleaned = 0
    cfk_spilled = 0
    paging = None
    # per-store breakdown (store.id == shard index node-wide): the paging
    # budget satellite's shard-labeled accord_pager_*/tier gauges read this
    per_shard: Dict[int, dict] = {}
    floors = {k: None for k in _WATERMARK_KINDS}
    for store in node.command_stores.all():
        # the paging tier: spilled state is evicted, NOT leaked — it must
        # stay visible to the census (and count against the leak detector
        # exactly as if resident).  Aggregates are maintained incrementally
        # by the pager so this sweep stays O(stores), not O(spilled).
        pager = getattr(store, "pager", None)
        if pager is not None:
            spilled_total += len(pager.meta)
            for cls, n in pager.spilled_by_class.items():
                spilled_by_class[cls] = spilled_by_class.get(cls, 0) + n
            spilled_uncleaned += pager.spilled_uncleaned
            cfk_spilled += len(pager.cfk_residuals)
            s = pager.stats()
            if paging is None:
                paging = dict(s)
            else:
                for k, v in s.items():
                    paging[k] += v
        cfk_keys += len(store.cfks)
        cfk_entries += sum(cfk.size() for cfk in store.cfks.values())
        gated += len(store.gated)
        range_cmds += len(store.range_commands)
        if not store.ranges.is_empty:
            rb, db = store.redundant_before, store.durable_before
            maj, uni = db.min_bounds(store.ranges)
            for kind, wm in (
                    ("locally_applied",
                     rb.min_locally_applied_before(store.ranges)),
                    ("shard_applied",
                     rb.min_shard_applied_before(store.ranges)),
                    ("durable_majority", maj),
                    ("durable_universal", uni)):
                cur = floors[kind]
                floors[kind] = wm if cur is None else min(cur, wm)
        n = len(store.commands)
        per_shard[store.id] = {
            "resident": n,
            "spilled": len(pager.meta) if pager is not None else 0,
            "paging": dict(pager.stats()) if pager is not None else None,
        }
        stride = max(1, n // max(1, byte_sample))
        for i, cmd in enumerate(list(store.commands.values())):
            total += 1
            st = cmd.save_status
            cls = _STATUS_CLASS.get(st, "other")
            by_class[cls] = by_class.get(cls, 0) + 1
            dname = cmd.durability.name
            by_durability[dname] = by_durability.get(dname, 0) + 1
            if st in _QUIESCENT_UNCLEANED:
                quiescent_uncleaned += 1
            if st >= SaveStatus.APPLIED:
                ref = cmd.execute_at if cmd.execute_at is not None \
                    else cmd.txn_id
                ages.append(max(0, now_us - ref.hlc))
            if i % stride == 0 and sampled_n < byte_sample:
                sampled_n += 1
                sampled_bytes += _approx_cmd_bytes(cmd)
    ages.sort()
    est_bytes = int(sampled_bytes / sampled_n * total) if sampled_n else 0
    watermarks = {}
    for kind in _WATERMARK_KINDS:
        wm = floors[kind] if floors[kind] is not None else TXNID_NONE
        watermarks[kind] = {
            "hlc": wm.hlc,
            # distance of the cleanup/durability fence from the HLC now:
            # the "cleanup lag" the bounded-memory store will size against
            # (-1 = no fact recorded yet for some owned span)
            "lag_us": (max(0, now_us - wm.hlc) if wm.hlc > 0 else -1),
        }
    return {
        "node": node.id,
        "at_us": now_us,
        "resident": total,
        "by_class": by_class,
        "by_durability": by_durability,
        # quiescent-but-uncleaned counts BOTH tiers: eviction moves a
        # command resident->spilled without changing this total, so the
        # leak detector cannot false-trip on paging (nor can paging hide
        # a genuine cleanup strand)
        "quiescent_uncleaned": quiescent_uncleaned + spilled_uncleaned,
        "resident_bytes_est": est_bytes,
        "spilled": spilled_total,
        "spilled_by_class": spilled_by_class,
        "spilled_quiescent_uncleaned": spilled_uncleaned,
        "paging": paging,
        "age_us": {"p50": _quantile(ages, 0.50),
                   "p95": _quantile(ages, 0.95),
                   "max": ages[-1] if ages else 0,
                   "count": len(ages)},
        "cfk": {"keys": cfk_keys, "entries": cfk_entries,
                "spilled": cfk_spilled},
        "gated": gated,
        "range_commands": range_cmds,
        "watermarks": watermarks,
        "per_shard": per_shard,
    }


def _merge_int_dicts(acc: Dict[str, int], d: Optional[Dict[str, int]]
                     ) -> Dict[str, int]:
    for k, v in (d or {}).items():
        acc[k] = acc.get(k, 0) + v
    return acc


def merge_censuses(censuses: List[dict], node_id: int, at_us: int) -> dict:
    """Fold per-worker censuses into one node view (worker runtime).
    Counts are exact sums; age quantiles cannot be merged exactly, so each
    is the max across workers (a conservative upper bound); watermark
    floors take the weakest shard (min hlc / max lag — a floor is only as
    good as the shard furthest behind)."""
    out = {
        "node": node_id, "at_us": at_us,
        "resident": sum(c["resident"] for c in censuses),
        "by_class": {}, "by_durability": {},
        "quiescent_uncleaned": sum(c["quiescent_uncleaned"]
                                   for c in censuses),
        "resident_bytes_est": sum(c["resident_bytes_est"]
                                  for c in censuses),
        "spilled": sum(c["spilled"] for c in censuses),
        "spilled_by_class": {},
        "spilled_quiescent_uncleaned": sum(
            c["spilled_quiescent_uncleaned"] for c in censuses),
        "paging": None,
        "gated": sum(c["gated"] for c in censuses),
        "range_commands": sum(c["range_commands"] for c in censuses),
        "per_shard": {},
    }
    for c in censuses:
        _merge_int_dicts(out["by_class"], c["by_class"])
        _merge_int_dicts(out["by_durability"], c["by_durability"])
        _merge_int_dicts(out["spilled_by_class"], c["spilled_by_class"])
        if c.get("paging") is not None:
            if out["paging"] is None:
                out["paging"] = {}
            _merge_int_dicts(out["paging"], c["paging"])
        for sid, ps in (c.get("per_shard") or {}).items():
            out["per_shard"][sid] = ps
    out["age_us"] = {
        q: max((c["age_us"][q] for c in censuses), default=0)
        for q in ("p50", "p95", "max")}
    out["age_us"]["count"] = sum(c["age_us"]["count"] for c in censuses)
    out["cfk"] = {
        k: sum(c["cfk"][k] for c in censuses)
        for k in ("keys", "entries", "spilled")}
    watermarks: Dict[str, dict] = {}
    for kind in _WATERMARK_KINDS:
        wms = [c["watermarks"][kind] for c in censuses
               if kind in c.get("watermarks", {})]
        if not wms:
            watermarks[kind] = {"hlc": 0, "lag_us": -1}
            continue
        watermarks[kind] = {
            "hlc": min(w["hlc"] for w in wms),
            "lag_us": (-1 if any(w["lag_us"] < 0 for w in wms)
                       else max(w["lag_us"] for w in wms)),
        }
    out["watermarks"] = watermarks
    return out


# --------------------------------------------------------------- auditor --

class _ShardAudit:
    """One digest round for one shard: floor negotiation, digest compare,
    and — on mismatch — the bisecting drill-down to the first divergent
    transaction.  All callbacks run on the node's single loop thread (sim
    queue / host dispatch loop), so there is no locking."""

    __slots__ = ("auditor", "ranges", "replicas", "peers", "on_done",
                 "outcome", "window", "rounds", "_settled")

    MAX_FLOOR_RETRIES = 2
    MAX_DEPTH = 48

    def __init__(self, auditor: "Auditor", shard, on_done: Callable):
        self.auditor = auditor
        self.ranges = Ranges([shard.range])
        self.replicas = sorted(shard.nodes)
        self.peers = [n for n in self.replicas if n != auditor.node.id]
        self.on_done = on_done
        self.outcome = None
        self.window: Tuple[Timestamp, Timestamp] = (TXNID_NONE, TXNID_NONE)
        self.rounds = 0
        self._settled = False

    # -- generic fan-out of one request to every replica (self served
    # locally: no loopback round trip, and an rf=1 shard still audits) --
    def _fan(self, make_req, local_fn, on_all) -> None:
        # `local_fn(done)` serves the local leg and calls done(reply):
        # synchronous in-loop, but asynchronous under the worker runtime
        # (the walk fans over the shard pipes before the reply exists)
        node = self.auditor.node
        replies: Dict[int, object] = {}
        missing = [0]  # failed/timed-out replicas (self included)
        outstanding = [len(self.peers) + 1]
        self.rounds += 1

        def settle():
            if outstanding[0] == 0:
                on_all(replies, missing[0])

        def local_done(reply):
            if type(reply) in (AuditDigestOk, AuditEntriesOk):
                replies[node.id] = reply
            else:
                missing[0] += 1
            outstanding[0] -= 1
            settle()

        def ok(from_id, reply):
            if type(reply) in (AuditDigestOk, AuditEntriesOk):
                replies[from_id] = reply
            else:
                missing[0] += 1
            outstanding[0] -= 1
            settle()

        def fail(from_id, _failure):
            missing[0] += 1
            outstanding[0] -= 1
            settle()

        for to in self.peers:
            node.send(to, make_req(), FunctionCallback(ok, fail))
        local_fn(local_done)

    def _finish(self, outcome: str) -> None:
        if self._settled:
            return
        self._settled = True
        self.outcome = outcome
        a = self.auditor
        a.registry.counter("accord_audit_rounds_total",
                           outcome=outcome).inc()
        r = self.ranges[0]
        a.node.obs.flight.record(
            "audit_digest", None,
            (r.start, r.end, len(self.replicas), outcome))
        self.on_done(self)

    # -- phase 1: floor-negotiated digest compare --
    def start(self) -> None:
        lo, hi = node_floors(self.auditor.node, self.ranges)
        self._digest_round(lo, hi, retries=self.MAX_FLOOR_RETRIES)

    def _digest_round(self, lo: Timestamp, hi: Timestamp,
                      retries: int) -> None:
        node = self.auditor.node
        self._fan(lambda: AuditDigest(self.ranges, lo, hi),
                  lambda done: local_digest(node, self.ranges, lo, hi, done),
                  lambda replies, missing: self._on_digests(
                      lo, hi, retries, replies, missing))

    def _on_digests(self, lo, hi, retries, replies, missing) -> None:
        if missing:
            return self._finish("inconclusive")
        nlo = max(r.lo_floor for r in replies.values())
        nlo = max(nlo, lo)
        nhi = min(r.hi_floor for r in replies.values())
        if (nlo, nhi) != (lo, hi):
            if not (nlo < nhi):
                self.window = (nlo, nhi)
                return self._finish("agree")  # empty certified window
            if retries > 0:
                return self._digest_round(nlo, nhi, retries - 1)
            return self._finish("inconclusive")  # floors kept moving
        self.window = (lo, hi)
        if not (lo < hi):
            return self._finish("agree")
        if len({r.digest for r in replies.values()}) == 1:
            return self._finish("agree")
        self.auditor.registry.counter("accord_audit_mismatch_total").inc()
        count = max(r.count for r in replies.values())
        self._drill(lo, hi, count, depth=0)

    # -- phase 2: bisect to an enumerable window, then diff entries --
    def _drill(self, lo, hi, count_hint, depth) -> None:
        a = self.auditor
        a.registry.counter("accord_audit_drill_total").inc()
        mid = _midpoint(lo, hi) if count_hint > a.entry_limit else None
        if mid is None or depth >= self.MAX_DEPTH:
            return self._fetch_entries(lo, hi, depth)
        node = a.node

        def on_half(half_lo, half_hi, next_fn):
            def handler(replies, missing):
                if missing:
                    return self._finish("inconclusive")
                if len({r.digest for r in replies.values()}) > 1:
                    self._drill(half_lo, half_hi,
                                max(r.count for r in replies.values()),
                                depth + 1)
                else:
                    next_fn()
            return handler

        def try_right():
            self._fan(lambda: AuditDigest(self.ranges, mid, hi),
                      lambda done: local_digest(node, self.ranges, mid, hi,
                                                done),
                      on_half(mid, hi,
                              lambda: self._finish("inconclusive")))

        # lowest mismatching half first: the drill lands on the FIRST
        # divergent transaction in the window
        self._fan(lambda: AuditDigest(self.ranges, lo, mid),
                  lambda done: local_digest(node, self.ranges, lo, mid,
                                            done),
                  on_half(lo, mid, try_right))

    def _fetch_entries(self, lo, hi, depth) -> None:
        node = self.auditor.node
        self._fan(lambda: AuditEntries(self.ranges, lo, hi),
                  lambda done: local_entries(node, self.ranges, lo, hi,
                                             done),
                  lambda replies, missing: self._on_entries(
                      lo, hi, depth, replies, missing))

    def _on_entries(self, lo, hi, depth, replies, missing) -> None:
        a = self.auditor
        if missing:
            return self._finish("inconclusive")
        if any(r.truncated for r in replies.values()):
            mid = _midpoint(lo, hi)
            if mid is not None and depth < self.MAX_DEPTH:
                # over the serving cap: keep splitting rather than diffing
                # a partial list
                return self._drill(lo, hi, AuditEntries.LIMIT * 2, depth + 1)
            return self._finish("inconclusive")
        by_node = {n: {t: (cls, at) for t, cls, at in r.entries}
                   for n, r in replies.items()}
        a.registry.counter("accord_audit_entries_total").inc(
            sum(len(m) for m in by_node.values()))
        hard, lag = classify_entry_sets(by_node)
        for txn_id, kind, vals in hard:
            a._record_divergence(self, txn_id, kind, vals)
        escalated = a._note_lag(self, lag)
        if hard or escalated:
            return self._finish("divergence")
        return self._finish("mismatch_lag")


class Auditor:
    """Per-node audit + census driver.

    `audit_once` runs one digest round per shard this node replicates
    (skipped while a previous invocation is still in flight); `census_once`
    runs one lifecycle sweep.  `start()` arms recurring timers for either
    surface whose interval is > 0 — both are OFF by default so harnesses
    opt in explicitly (hosts default them on via auditor_from_env)."""

    def __init__(self, node, interval_s: float = 0.0,
                 census_interval_s: Optional[float] = None,
                 entry_limit: int = 1024, lag_rounds: int = 3,
                 leak_min_growth: int = 64, leak_sweeps: int = 20):
        self.node = node
        self.interval_s = interval_s
        self.census_interval_s = (census_interval_s
                                  if census_interval_s is not None
                                  else interval_s)
        self.entry_limit = entry_limit
        self.lag_rounds = lag_rounds
        self.registry = node.obs.registry
        self.leak = LeakDetector(min_growth=leak_min_growth,
                                 sweeps=leak_sweeps)
        self.divergences: List[dict] = []
        self.last_report: Optional[dict] = None
        self.last_census: Optional[dict] = None
        # (txn repr, node) -> consecutive rounds a committed-below-universal
        # entry was absent on that node; escalates at lag_rounds
        self._lag: Dict[tuple, int] = {}
        # a persistent divergence is re-confirmed by every later round:
        # count each re-detection (the metric is the liveness signal) but
        # record one row per distinct (txn, kind)
        self._div_seen: set = set()
        self._timers: list = []
        self._busy = False
        # live view for the metrics endpoint's /audit route + host frames
        node.obs.audit_view = self.view

    # ------------------------------------------------------------- audit --
    def audit_once(self, on_done: Optional[Callable] = None) -> bool:
        """One full pass over this node's shards; False when a previous
        pass is still in flight (on_done then fires with None)."""
        if self._busy:
            if on_done is not None:
                on_done(None)
            return False
        topo = self.node.topology.current()
        shards = [s for s in topo.shards if self.node.id in s.nodes]
        if not shards:
            if on_done is not None:
                on_done({"at_us": self.node.obs.now_us(), "rounds": []})
            return True
        self._busy = True
        results: List[_ShardAudit] = []

        def next_shard(i: int) -> None:
            if i >= len(shards):
                self._busy = False
                report = {
                    "at_us": self.node.obs.now_us(),
                    "rounds": [{"range": [r.ranges[0].start,
                                          r.ranges[0].end],
                                "replicas": r.replicas,
                                "outcome": r.outcome,
                                "window": [repr(r.window[0]),
                                           repr(r.window[1])],
                                "requests": r.rounds}
                               for r in results],
                }
                self.last_report = report
                if on_done is not None:
                    on_done(report)
                return
            audit = _ShardAudit(self, shards[i],
                                lambda r: (results.append(r),
                                           next_shard(i + 1)))
            audit.start()

        next_shard(0)
        return True

    def _record_divergence(self, shard_audit: _ShardAudit, txn_id, kind,
                           vals) -> None:
        tid = repr(txn_id)
        r = shard_audit.ranges[0]
        self.registry.counter("accord_audit_divergence_total",
                              kind=kind).inc()
        # every (re-)confirmation goes on the bounded flight ring — a
        # persistent divergence must still be visible when the ring has
        # wrapped past its first detection
        self.node.obs.flight.record(
            "audit_divergence", tid,
            (kind, r.start, r.end,
             tuple(n for n, v in sorted(vals.items()) if v is not None)))
        if (tid, kind) in self._div_seen:
            return
        self._div_seen.add((tid, kind))
        row = {
            "txn": tid,
            "kind": kind,
            "range": [r.start, r.end],
            "replicas": shard_audit.replicas,
            "nodes": {str(n): (None if v is None
                               else [v[0], repr(v[1]) if v[1] is not None
                                     else None])
                      for n, v in vals.items()},
            "at_us": self.node.obs.now_us(),
        }
        self.divergences.append(row)

    def _note_lag(self, shard_audit: _ShardAudit, lag) -> bool:
        """Track committed-below-universal entries absent on some replica;
        persistent absence across `lag_rounds` consecutive drill-downs is
        itself a divergence (the universal certificate says every replica
        applied it — a healthy replica mid-catch-up clears in one round)."""
        escalated = False
        seen = set()
        for txn_id, absent_nodes in lag:
            for n in absent_nodes:
                key = (repr(txn_id), n)
                seen.add(key)
                self._lag[key] = self._lag.get(key, 0) + 1
                if self._lag[key] == self.lag_rounds:
                    self._record_divergence(
                        shard_audit, txn_id, "missing_below_universal",
                        {n: None})
                    escalated = True
        # any (txn, node) no longer lagging resolved itself: forget it
        for key in [k for k in self._lag if k not in seen]:
            del self._lag[key]
        return escalated

    # ------------------------------------------------------------ census --
    def census_once(self) -> dict:
        census = census_node(self.node)
        self.last_census = census
        reg = self.registry
        nid = self.node.id
        reg.counter("accord_census_sweeps_total").inc()
        for cls, n in census["by_class"].items():
            reg.gauge("accord_census_resident", node=nid, cls=cls).set(n)
        # tier-labeled view (resident|spilled): evicted-but-live state must
        # not vanish from accord_census_* — the spilled tier is published
        # beside the resident one under the same class buckets
        for cls, n in census["by_class"].items():
            reg.gauge("accord_census_commands", node=nid, cls=cls,
                      tier="resident").set(n)
        for cls, n in census["spilled_by_class"].items():
            reg.gauge("accord_census_commands", node=nid, cls=cls,
                      tier="spilled").set(n)
        reg.gauge("accord_census_spilled_total", node=nid).set(
            census["spilled"])
        paging = census.get("paging")
        if paging is not None:
            for k in ("hits", "misses", "evictions", "refaults",
                      "resident", "resident_high_water", "spilled",
                      "cfk_evictions", "cfk_restores", "spill_disk_bytes",
                      "spill_compactions"):
                reg.gauge(f"accord_pager_{k}", node=nid).set(paging[k])
        # per-shard paging budgets: the same tier/pager surfaces labeled by
        # shard (store.id == shard index, in-loop and worker mode alike)
        for sid, ps in (census.get("per_shard") or {}).items():
            reg.gauge("accord_census_commands", node=nid, tier="resident",
                      shard=sid).set(ps["resident"])
            reg.gauge("accord_census_commands", node=nid, tier="spilled",
                      shard=sid).set(ps["spilled"])
            pg = ps.get("paging")
            if pg is not None:
                for k in ("hits", "misses", "evictions", "refaults",
                          "resident", "resident_high_water", "spilled",
                          "cfk_evictions", "cfk_restores",
                          "spill_disk_bytes", "spill_compactions"):
                    reg.gauge(f"accord_pager_{k}", node=nid,
                              shard=sid).set(pg.get(k, 0))
        for d, n in census["by_durability"].items():
            reg.gauge("accord_census_resident_by_durability", node=nid,
                      durability=d).set(n)
        reg.gauge("accord_census_resident_total", node=nid).set(
            census["resident"])
        reg.gauge("accord_census_resident_bytes_est", node=nid).set(
            census["resident_bytes_est"])
        reg.gauge("accord_census_quiescent_uncleaned", node=nid).set(
            census["quiescent_uncleaned"])
        reg.gauge("accord_census_cfk_entries", node=nid).set(
            census["cfk"]["entries"])
        for q in ("p50", "p95", "max"):
            reg.gauge("accord_census_age_us", node=nid, q=q).set(
                census["age_us"][q])
        # satellite: the cleanup/durability watermarks finally reach
        # /metrics — floor HLC and its distance from now, per node
        for kind, wm in census["watermarks"].items():
            reg.gauge("accord_watermark_hlc", node=nid, kind=kind).set(
                wm["hlc"])
            reg.gauge("accord_watermark_lag_us", node=nid, kind=kind).set(
                wm["lag_us"])
        alarm = self.leak.observe(census["quiescent_uncleaned"])
        if alarm:
            reg.counter("accord_census_leak_alarms_total").inc()
        census["leak_alarm"] = alarm
        census["leak_alarms_total"] = self.leak.alarms
        self.node.obs.flight.record(
            "census_sweep", None,
            (census["resident"], census["quiescent_uncleaned"],
             census["resident_bytes_est"]))
        return census

    # --------------------------------------------------------- lifecycle --
    def start(self) -> None:
        sched = self.node.scheduler
        if self.interval_s and self.interval_s > 0:
            self._timers.append(
                sched.recurring(self.interval_s,
                                lambda: self.audit_once()))
        if self.census_interval_s and self.census_interval_s > 0:
            self._timers.append(
                sched.recurring(self.census_interval_s,
                                lambda: self.census_once()))

    def stop(self) -> None:
        for t in self._timers:
            try:
                t.cancel()
            except AttributeError:
                pass
        self._timers = []

    def view(self) -> dict:
        """JSON-safe live view (httpd /audit, the tcp "audit" frame)."""
        return {
            "node": self.node.id,
            "divergences": list(self.divergences),
            "last_report": self.last_report,
            "census": self.last_census,
            "leak_alarms": self.leak.alarms,
        }


def auditor_from_env(node, default_interval_s: float = 5.0
                     ) -> Optional[Auditor]:
    """Host wiring: ACCORD_AUDIT_S tunes the periodic audit+census interval
    (seconds; 0 disables, default 5).  Census runs on the same cadence."""
    raw = os.environ.get("ACCORD_AUDIT_S", "")
    try:
        interval = float(raw) if raw else default_interval_s
    except ValueError:
        interval = default_interval_s
    if interval <= 0:
        return None
    auditor = Auditor(node, interval_s=interval)
    auditor.start()
    return auditor
