"""Strict-serializability verification for the append-register workload.

Reference: accord-core test verify/StrictSerializabilityVerifier.java:17-58 —
an online happens-before checker over observed per-key append sequences with
real-time bounds and cycle detection.

Model: each committed transaction observed (reads = per-key value tuples,
appends = per-key single values, virtual start/end times). Given the final
per-key histories, strict serializability holds iff:
  1. every read is a prefix of the final per-key order;
  2. every committed append appears exactly once;
  3. a read-modify-write's append lands immediately after its read prefix;
  4. the constraint graph (per-key append order + read-before/after-write
     + real-time precedence) is acyclic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Observation:
    __slots__ = ("txn_desc", "reads", "appends", "start_us", "end_us")

    def __init__(self, txn_desc, reads: Dict[int, Tuple[int, ...]],
                 appends: Dict[int, int], start_us: int, end_us: int):
        self.txn_desc = txn_desc
        self.reads = dict(reads)      # token -> observed value tuple
        self.appends = dict(appends)  # token -> appended value
        self.start_us = start_us
        self.end_us = end_us

    def __repr__(self):
        return (f"Obs({self.txn_desc}, r={self.reads}, a={self.appends}, "
                f"[{self.start_us},{self.end_us}])")


class Violation(AssertionError):
    pass


class ForensicsMixin:
    """Optional failure-forensics hook shared by the history checkers.

    A harness that owns the cluster's flight recorders (sim/burn.py)
    attaches a callable `forensics(txn_descs) -> str`; every Violation a
    checker raises through `_violation` then carries the stitched
    cross-replica flight timeline for the offending transactions instead
    of (or in addition to) raw state dumps."""

    forensics = None  # Callable[[List[str]], str] | None

    def attach_forensics(self, fn) -> None:
        self.forensics = fn

    def _violation(self, detail: str, txn_descs=(),
                   brief: Optional[str] = None) -> Violation:
        """Build a Violation: `detail` alone without forensics; with a
        forensics hook attached, `brief` (or detail) plus the stitched
        flight timeline.  `brief` lets a checker drop raw state dicts when
        the timeline supersedes them (sim/verify_replay.py)."""
        if self.forensics is not None:
            try:
                extra = self.forensics(list(txn_descs))
            except Exception:  # noqa: BLE001 — forensics must never mask
                extra = ""     # the underlying violation
            if extra:
                return Violation(f"{brief or detail}\n{extra}")
        return Violation(detail)


def real_time_edges(obs: Sequence[Observation], add_edge) -> None:
    """Reduced real-time precedence: a -> every b starting in (end_a, m]
    where m is the minimum end among txns starting after end_a — any
    later-starting txn is reachable transitively through one of those.
    Shared by both checkers (the reduction itself is infrastructure, not
    part of either checking algorithm)."""
    from bisect import bisect_right
    n = len(obs)
    order = sorted(range(n), key=lambda i: obs[i].start_us)
    starts = [obs[i].start_us for i in order]
    suffix_min_end: List[Optional[int]] = [None] * n
    running: Optional[int] = None
    for k in range(n - 1, -1, -1):
        e = obs[order[k]].end_us
        running = e if running is None or e < running else running
        suffix_min_end[k] = running
    for ai in range(n):
        a = order[ai]
        j = bisect_right(starts, obs[a].end_us, lo=ai + 1)
        if j >= n:
            continue
        bound = suffix_min_end[j]
        k = j
        while k < n and starts[k] <= bound:
            add_edge(a, order[k])
            k += 1


class StrictSerializabilityVerifier(ForensicsMixin):
    def __init__(self):
        self.observations: List[Observation] = []

    def observe(self, obs: Observation) -> None:
        self.observations.append(obs)

    def verify(self, final_histories: Dict[int, Sequence[int]]) -> None:
        """Raises Violation with a description on any anomaly."""
        obs = self.observations
        n = len(obs)
        positions: Dict[Tuple[int, int], int] = {}  # (token, value) -> index
        for token, hist in final_histories.items():
            if len(set(hist)) != len(hist):
                raise Violation(f"duplicate value in history of key {token}: {hist}")
            for i, v in enumerate(hist):
                positions[(token, v)] = i

        # 1-3: per-observation checks
        writer_of: Dict[Tuple[int, int], int] = {}  # (token, position) -> obs idx
        for i, o in enumerate(obs):
            for token, value in o.appends.items():
                pos = positions.get((token, value))
                if pos is None:
                    raise self._violation(
                        f"lost append: {o} appended {value} to key {token} "
                        f"but final history is {final_histories.get(token)}",
                        txn_descs=[o.txn_desc])
                dup = writer_of.get((token, pos))
                if dup is not None:
                    raise self._violation(
                        f"two txns own key {token} position {pos}",
                        txn_descs=[obs[dup].txn_desc, o.txn_desc])
                writer_of[(token, pos)] = i
            for token, read in o.reads.items():
                hist = tuple(final_histories.get(token, ()))
                if tuple(read) != hist[:len(read)]:
                    raise self._violation(
                        f"non-prefix read: {o} read {read} of key {token} "
                        f"whose final history is {hist}",
                        txn_descs=[o.txn_desc])
                if token in o.appends:
                    pos = positions[(token, o.appends[token])]
                    if pos != len(read):
                        raise self._violation(
                            f"non-atomic rmw: {o} read prefix of length "
                            f"{len(read)} of key {token} but its append landed "
                            f"at position {pos}", txn_descs=[o.txn_desc])

        # 4: constraint graph acyclicity
        edges: Dict[int, set] = {i: set() for i in range(n)}

        def add_edge(a: int, b: int):
            if a != b:
                edges[a].add(b)

        # per-key append order
        for token, hist in final_histories.items():
            prev: Optional[int] = None
            for pos in range(len(hist)):
                w = writer_of.get((token, pos))
                if w is None:
                    continue  # external/unobserved write
                if prev is not None:
                    add_edge(prev, w)
                prev = w
        # reads: writer(pos < len) -> reader -> writer(pos >= len)
        for i, o in enumerate(obs):
            for token, read in o.reads.items():
                hist = final_histories.get(token, ())
                for pos in range(len(hist)):
                    w = writer_of.get((token, pos))
                    if w is None:
                        continue
                    if pos < len(read):
                        add_edge(w, i)
                    else:
                        add_edge(i, w)
        real_time_edges(obs, add_edge)

        self._check_acyclic(edges)

    def _check_acyclic(self, edges: Dict[int, set]) -> None:
        # Kahn's algorithm; report a cycle member on failure
        indeg = {i: 0 for i in edges}
        for a, outs in edges.items():
            for b in outs:
                indeg[b] += 1
        queue = [i for i, d in indeg.items() if d == 0]
        seen = 0
        while queue:
            a = queue.pop()
            seen += 1
            for b in edges[a]:
                indeg[b] -= 1
                if indeg[b] == 0:
                    queue.append(b)
        if seen != len(edges):
            cyclic = [self.observations[i] for i, d in indeg.items() if d > 0]
            raise self._violation(
                "serialization cycle among "
                f"{[o.txn_desc for o in cyclic[:10]]}"
                f"{'...' if len(cyclic) > 10 else ''}",
                txn_descs=[o.txn_desc for o in cyclic[:10]])
