"""Trace: structured protocol-event logging.

Reference: the reference observes through slf4j logging spread across the
engine plus the burn simulation's `accord.impl.basic.Trace` logger
(Cluster.java:104) and per-message-type Stats counters.  Here the same job
is done by one tiny facility: a per-process `Trace` that records structured
events (phase transitions, recovery escalations, topology changes, fetches)
with virtual-or-wall timestamps, forwarding to stdlib `logging` so hosts
plug in their own handlers, and optionally retaining a bounded in-memory
ring for test assertions and burn dumps (`--trace` on the burn CLI).

Disabled (the default) it is a no-op behind one `if` — the engine stays
allocation-free on the hot path.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Optional, Tuple

logger = logging.getLogger("accord_tpu_torch")


class Trace:
    """One per Node (or one shared, in tests).  `enabled` gates everything;
    `ring` retains the last `capacity` events when retention is on."""

    __slots__ = ("enabled", "node_id", "clock", "ring")

    def __init__(self, node_id: Optional[int] = None, enabled: bool = False,
                 clock=None, capacity: int = 10_000):
        self.enabled = enabled
        self.node_id = node_id
        self.clock = clock  # () -> float; None = no timestamps
        self.ring: Deque[Tuple] = deque(maxlen=capacity)

    def event(self, _what: str, **fields) -> None:
        if not self.enabled:
            return
        at = self.clock() if self.clock is not None else None
        self.ring.append((at, self.node_id, _what, fields))
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("n%s %s %s %s", self.node_id, at, _what, fields)

    # -- introspection --
    def events(self, what: Optional[str] = None):
        return [e for e in self.ring if what is None or e[2] == what]

    def dump(self, limit: int = 200) -> str:
        lines = []
        for at, node, kind, fields in list(self.ring)[-limit:]:
            ts = f"{at:.6f}" if isinstance(at, float) else "-"
            lines.append(f"{ts} n{node} {kind} "
                         + " ".join(f"{k}={v!r}" for k, v in fields.items()))
        return "\n".join(lines)


NO_TRACE = Trace(enabled=False)
