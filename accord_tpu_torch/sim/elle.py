"""Third, independently-authored history checker: a port of Elle's
list-append analysis.

The reference composes its own strict-serializability verifier with Elle,
jepsen's community-hardened checker (accord-core/build.gradle:36-46,
test/accord/verify/ElleVerifier.java:47).  Rounds 1-3 composed two
home-grown algorithms written against one author's mental model; this
module de-correlates the oracle by porting the PUBLISHED algorithm from
Elle's paper (Kingsbury & Alvaro, "Elle: Inferring Isolation Anomalies
from Experimental Observations", VLDB 2020) for the list-append workload:

  1. VERSION ORDERS are inferred from the observations themselves — every
     read of a key is a version of its list, and list-append's prefix
     property requires all observed versions of a key to form a chain
     under the prefix relation ("incompatible order" anomaly otherwise).
     The final history joins as the closing read.
  2. DIRTY/ABORTED READS (G1a): a read strictly longer than the final
     history means values surfaced to a reader but never durably
     happened.
  3. DEPENDENCY EDGES are derived per Elle's recoverability argument:
       wr: T2 read a version whose last element T1 appended;
       ww: T1 appended the element immediately preceding T2's append in
           the inferred version order;
       rw: T1 read a version that T2's append immediately extends.
  4. REAL-TIME edges join for strict serializability (Elle's "realtime"
     graph under Jepsen).
  5. CYCLE SEARCH runs Tarjan's strongly-connected-components algorithm;
     a non-trivial SCC is an anomaly, CLASSIFIED by the edge kinds on a
     concrete cycle recovered from the SCC: G0 (write cycle), G1c (ww+wr),
     G-single (exactly one rw), G2 (multiple rw), with "-realtime"
     appended when real-time edges participate.

Structural independence from the two in-tree checkers: sim/verify.py
tests one constraint graph for acyclicity via Kahn counting; verify_replay
constructs an explicit witness and replays it against a model store;
this checker infers version orders purely from reads, computes SCCs, and
names the anomaly class.  All three must pass on every burn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.sim.verify import (ForensicsMixin, Observation, Violation,
                                   real_time_edges)

WW, WR, RW, RT = "ww", "wr", "rw", "realtime"


class ElleListAppendChecker(ForensicsMixin):
    """Same observe/verify surface as the other two checkers."""

    def __init__(self):
        self.observations: List[Observation] = []

    def observe(self, obs: Observation) -> None:
        self.observations.append(obs)

    # ---------------------------------------------------------- verify --
    def verify(self, final_histories: Dict[int, Sequence[int]]) -> None:
        obs = self.observations
        n = len(obs)

        # -- step 1: per-key version chains from reads + final history --
        versions: Dict[int, List[Tuple[int, ...]]] = {}
        for o in obs:
            for token, read in o.reads.items():
                versions.setdefault(token, []).append(tuple(read))
        for token, hist in final_histories.items():
            versions.setdefault(token, []).append(tuple(hist))
        order: Dict[int, Tuple[int, ...]] = {}
        for token, vs in versions.items():
            vs.sort(key=len)
            for a, b in zip(vs, vs[1:]):
                if b[:len(a)] != a:
                    raise Violation(
                        f"elle: incompatible version order on key {token}: "
                        f"{a} vs {b} (no prefix chain)")
            # the final history is one of the versions; a longer READ means
            # observed appends vanished from the final state (G1a-class:
            # values surfaced to a reader but never durably happened)
            final = tuple(final_histories.get(token, ()))
            if vs and len(vs[-1]) > len(final):
                raise Violation(
                    f"elle: G1a — key {token} was read as {vs[-1]} but "
                    f"finally holds only {final}: observed appends vanished")
            order[token] = vs[-1] if vs else ()

        # appender of each (token, value); duplicate appends of one value
        # would corrupt recoverability, and an ACKED append absent from
        # the inferred version order is Elle's lost-update anomaly
        appender: Dict[Tuple[int, int], int] = {}
        for i, o in enumerate(obs):
            for token, value in o.appends.items():
                if (token, value) in appender:
                    raise Violation(
                        f"elle: value {value} appended to key {token} twice")
                appender[(token, value)] = i
                if value not in order.get(token, ()):
                    raise self._violation(
                        f"elle: lost update — acked append of {value} to "
                        f"key {token} is absent from the version order "
                        f"{order.get(token, ())} ({o})",
                        txn_descs=[o.txn_desc])

        # -- step 3+4: dependency edges (parallel adjacency by kind) --
        # node ids: 0..n-1 observations; values appended by no observed
        # txn (committed-but-unobserved winners) get phantom nodes
        phantom_of: Dict[Tuple[int, int], int] = {}
        labels: List[object] = [o.txn_desc for o in obs]

        def writer(token: int, value: int) -> int:
            i = appender.get((token, value))
            if i is not None:
                return i
            key = (token, value)
            if key not in phantom_of:
                phantom_of[key] = len(labels)
                labels.append(f"phantom({token}={value})")
            return phantom_of[key]

        edges: Dict[Tuple[int, int], Set[str]] = {}

        def edge(a: int, b: int, kind: str) -> None:
            if a != b:
                edges.setdefault((a, b), set()).add(kind)

        for token, version in order.items():
            for p in range(1, len(version)):
                edge(writer(token, version[p - 1]),
                     writer(token, version[p]), WW)
        for i, o in enumerate(obs):
            for token, read in o.reads.items():
                version = order.get(token, ())
                if read:
                    edge(writer(token, read[-1]), i, WR)
                if len(read) < len(version):
                    edge(i, writer(token, version[len(read)]), RW)
        real_time_edges(obs, lambda a, b: edge(a, b, RT))

        total = len(labels)
        succ: List[List[int]] = [[] for _ in range(total)]
        for (a, b) in edges:
            succ[a].append(b)

        # -- step 5: Tarjan SCC (iterative), then classify a cycle --
        sccs = _tarjan(total, succ)
        for scc in sccs:
            if len(scc) < 2:
                continue
            cycle = _find_cycle(scc, succ)
            kinds: Set[str] = set()
            for a, b in zip(cycle, cycle[1:] + cycle[:1]):
                kinds |= edges.get((a, b), set())
            raise self._violation(
                f"elle: {_classify(kinds, edges, cycle)} cycle over "
                f"{[labels[i] for i in cycle]}",
                txn_descs=[labels[i] for i in cycle
                           if isinstance(labels[i], str)
                           and not labels[i].startswith("phantom(")])

    # introspection for tests: the checker found the history clean
    def __repr__(self):
        return f"ElleListAppendChecker({len(self.observations)} obs)"


def _classify(kinds: Set[str], edges, cycle: List[int]) -> str:
    rw_count = 0
    for a, b in zip(cycle, cycle[1:] + cycle[:1]):
        if RW in edges.get((a, b), set()) \
                and not (edges.get((a, b), set()) - {RW, RT}):
            rw_count += 1
    data = kinds - {RT}
    if data <= {WW}:
        name = "G0"
    elif data <= {WW, WR}:
        name = "G1c"
    elif rw_count == 1:
        name = "G-single"
    else:
        name = "G2"
    return name + ("-realtime" if RT in kinds else "")


def _tarjan(n: int, succ: List[List[int]]) -> List[List[int]]:
    """Iterative Tarjan strongly-connected components."""
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    stack: List[int] = []
    out: List[List[int]] = []
    counter = [1]
    for root in range(n):
        if visited[root]:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for j in range(pi, len(succ[v])):
                w = succ[v][j]
                if not visited[w]:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _find_cycle(scc: List[int], succ: List[List[int]]) -> List[int]:
    """A concrete cycle inside a non-trivial SCC: BFS from its first node
    back to itself through SCC-internal edges."""
    members = set(scc)
    start = scc[0]
    parent: Dict[int, int] = {}
    frontier = [start]
    while frontier:
        nxt = []
        for v in frontier:
            for w in succ[v]:
                if w == start:
                    path = [v]
                    while path[-1] != start:
                        path.append(parent[path[-1]])
                    path.reverse()
                    return path
                if w in members and w not in parent:
                    parent[w] = v
                    nxt.append(w)
        frontier = nxt
    return [start]  # unreachable for a genuine SCC
