"""Audit-side pure logic: entry-set classification and the leak detector.

The replica-state auditor (local/audit.py) exchanges range digests and
per-txn entry lists across replicas; THIS module holds the parts with no
engine dependencies — comparing entry sets into hard divergences vs
benign lag, and the census sweep's monotonic-growth leak alarm — so they
stay inside obs/'s import fence (intra-package only, no jax/numpy;
tests/test_obs_budget.py enforces it) and unit-testable on plain data.

Entry shape (produced by local/audit.py, opaque here):

    {node_id: {txn_key: (cls, at)}}   cls in ("committed", "invalidated",
                                      "unknown"); at = executeAt (opaque,
                                      compared via repr) or None

Classification rules (the soundness story lives with the digest window in
local/audit.py — everything compared here is below the negotiated
universal-durable bound, where every replica is certified to have applied
or invalidated every transaction):

  * two replicas committed with different executeAts  -> HARD divergence
  * one replica invalidated, another committed        -> HARD divergence
  * "unknown" (locally truncated, decision shed)      -> compatible with
    anything — the replica cannot represent the decision, it does not
    contradict it
  * absent on one replica, committed on another       -> lag candidate;
    below the universal bound this should be impossible at quiesce, so
    the auditor escalates it only after `lag_rounds` CONSECUTIVE rounds
    (a replica mid-bootstrap/replay must not trip a one-shot alarm)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def classify_entry_sets(by_node: Dict[int, dict]
                        ) -> Tuple[List[tuple], List[tuple]]:
    """Compare per-replica entry maps for one digest window.

    Returns (hard, lag), each sorted by txn key so the FIRST element is the
    first divergent transaction in the window:

      hard: [(txn_key, kind, {node: ("cls", at) | None})]
            kind in ("execute_at", "invalidated_vs_committed")
      lag:  [(txn_key, (absent_node, ...))]
    """
    nodes = sorted(by_node)
    union = sorted({k for m in by_node.values() for k in m})
    hard: List[tuple] = []
    lag: List[tuple] = []
    for key in union:
        vals = {n: by_node[n].get(key) for n in nodes}
        present = {n: v for n, v in vals.items() if v is not None}
        committed = {n: v[1] for n, v in present.items()
                     if v[0] == "committed"}
        invalidated = [n for n, v in present.items() if v[0] == "invalidated"]
        if committed and len({repr(at) for at in committed.values()}) > 1:
            hard.append((key, "execute_at", vals))
            continue
        if committed and invalidated:
            hard.append((key, "invalidated_vs_committed", vals))
            continue
        if committed:
            absent = tuple(n for n in nodes if vals[n] is None)
            if absent:
                lag.append((key, absent))
    return hard, lag


class LeakDetector:
    """Alarm when quiescent-but-uncleaned state grows monotonically.

    The census sweep feeds it the per-node count of terminal commands the
    cleanup ladder should eventually purge (APPLIED / INVALIDATED, not yet
    truncated).  Healthy clusters saw-tooth: the count grows between
    durability rounds and drops at each cleanup sweep.  A broken ladder
    (durability rounds disabled, a watermark wedged, an erase bug) only
    grows — after `sweeps` consecutive non-decreasing observations with at
    least `min_growth` total growth, the detector latches one alarm and
    re-arms from the new baseline."""

    __slots__ = ("min_growth", "sweeps", "alarms", "_base", "_last",
                 "_streak")

    def __init__(self, min_growth: int = 64, sweeps: int = 20):
        self.min_growth = min_growth
        self.sweeps = sweeps
        self.alarms = 0
        self._base: Optional[int] = None
        self._last: Optional[int] = None
        self._streak = 0

    def observe(self, count: int) -> bool:
        """Feed one sweep's count; True when this observation trips the
        alarm."""
        if self._base is None or (self._last is not None
                                  and count < self._last):
            # any decrease proves cleanup is alive: re-arm from here
            self._base = count
            self._streak = 0
        else:
            self._streak += 1
        self._last = count
        if self._streak >= self.sweeps and count - self._base >= self.min_growth:
            self.alarms += 1
            self._base = count
            self._streak = 0
            return True
        return False
