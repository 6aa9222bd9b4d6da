"""Per-transaction trace spans.

A span is the ordered event list one node recorded for one trace id; the
trace id is the transaction id's canonical repr, so the id every replica
derives independently is identical — stitching a cross-replica trace is a
merge-sort of the participating nodes' span stores, no id exchange needed.

Senders additionally stamp the trace id onto outbound requests
(`Node.send` sets `request.trace_id`; `host/wire.py`'s structural codec
round-trips it as an ordinary instance field), so a replica records rx
events even for verbs it cannot attribute to a coordination of its own —
that is what makes recovery visible end-to-end: the recovering node's span
carries `begin(path=recovery)` while every contacted replica carries
`rx:BEGIN_RECOVER_REQ` under the SAME trace id.

Bounded: the store is an LRU of `capacity` traces; each span caps its
event list so a pathological retry loop cannot grow one span unboundedly.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

_MAX_EVENTS_PER_SPAN = 256

# protocol milestones in coordination order (the ephemeral-read path's two
# rounds slot in right after begin — a span carries either the eph_* pair
# or the witnessed-txn ladder, never both); the per-phase latency breakdown
# is the delta between consecutive *present* milestones
PHASE_ORDER = ("begin", "eph_deps", "eph_read", "preaccept",
               "preaccept_extend", "begin_recover", "accept", "commit",
               "stable", "apply", "end")


def phase_firsts(span) -> list:
    """[(phase, at_us)] — first occurrence of each PHASE_ORDER milestone
    present on the span, in coordination order.  The join key between the
    open-loop generator's intended-start ledger and a txn's trace."""
    if span is None:
        return []
    out = []
    for ph in PHASE_ORDER:
        ev = span.first(ph)
        if ev is not None:
            out.append((ph, ev[0]))
    return out


def phase_deltas(firsts) -> list:
    """[(phase, duration_us)] between consecutive present milestones of a
    `phase_firsts` list: the time attributed to each phase."""
    return [(ph, max(0, nat - at))
            for (ph, at), (_nph, nat) in zip(firsts, firsts[1:])]


def trace_key(txn_id) -> str:
    """Canonical trace id for a transaction (identical on every replica)."""
    return repr(txn_id)


class Span:
    """One trace id's events on ONE node: [(at_us, phase, tags-or-None)]."""

    __slots__ = ("trace_id", "node_id", "events", "path")

    def __init__(self, trace_id: str, node_id: int):
        self.trace_id = trace_id
        self.node_id = node_id
        self.events: List[Tuple[int, str, Optional[dict]]] = []
        self.path = None  # "fast" | "slow" | "recovery" | ... once known

    def first(self, phase: str):
        for at, ph, tags in self.events:
            if ph == phase:
                return (at, ph, tags)
        return None

    def phases(self):
        return [ph for _, ph, _ in self.events]

    def __repr__(self):
        return (f"Span({self.trace_id} n{self.node_id} "
                f"path={self.path} {self.phases()})")


class SpanStore:
    """Bounded per-node span collection (LRU on trace id)."""

    __slots__ = ("node_id", "capacity", "_spans")

    def __init__(self, node_id: int, capacity: int = 4096):
        self.node_id = node_id
        self.capacity = capacity
        self._spans: "OrderedDict[str, Span]" = OrderedDict()

    def event(self, trace_id: str, phase: str, at_us: int,
              tags: Optional[dict] = None) -> Span:
        span = self._spans.get(trace_id)
        if span is None:
            span = self._spans[trace_id] = Span(trace_id, self.node_id)
            if len(self._spans) > self.capacity:
                self._spans.popitem(last=False)
        if len(span.events) < _MAX_EVENTS_PER_SPAN:
            span.events.append((at_us, phase, tags))
        return span

    def get(self, trace_id: str) -> Optional[Span]:
        return self._spans.get(trace_id)

    def ids(self):
        return list(self._spans)

    def spans(self):
        return list(self._spans.values())

    def __len__(self):
        return len(self._spans)


def stitch(stores, trace_id: str):
    """Merge one trace id's events across span stores into a single
    time-ordered list of (at_us, node_id, phase, tags).  Per-node clocks
    may drift in sim; the order is best-effort, the per-node sublists are
    exact."""
    merged = []
    for store in stores:
        span = store.get(trace_id)
        if span is not None:
            merged.extend((at, span.node_id, ph, tags)
                          for at, ph, tags in span.events)
    merged.sort(key=lambda e: (e[0], e[1]))
    return merged


def find_trace_ids(stores, phase: Optional[str] = None, **tags):
    """Trace ids having at least one event matching `phase` (prefix match
    when it ends with '*') and every given tag, on ANY of the stores."""
    prefix = phase[:-1] if phase is not None and phase.endswith("*") else None
    ids = set()
    for store in stores:
        for span in store.spans():
            if span.trace_id in ids:
                continue
            for _, ph, tg in span.events:
                if phase is not None:
                    if prefix is not None:
                        if not ph.startswith(prefix):
                            continue
                    elif ph != phase:
                        continue
                if tags and not all((tg or {}).get(k) == v
                                    for k, v in tags.items()):
                    continue
                ids.add(span.trace_id)
                break
    return ids
