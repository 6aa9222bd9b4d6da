"""Second, independent history checker: witness construction + model replay.

The reference composes its own strict-serializability verifier with Elle
(jepsen's checker) so two unrelated algorithms must both pass
(test verify/CompositeVerifier, ElleVerifier.java:47).  This module is the
counterpart second algorithm: instead of testing the constraint graph for
cycles (sim/verify.py), it CONSTRUCTS an explicit serial witness order and
replays it against a model key-value store, validating every observation
against the model state at its position:

  1. phantom writers are synthesised for committed-but-unobserved appends
     (client-nacked transactions that actually won — their values appear in
     the final histories with no observation);
  2. ordering constraints are derived afresh — per-key final append order
     (ww), read-prefix placement (wr/rw), and real-time precedence;
  3. a topological order over them is the candidate witness; failure to
     find one is a serialization violation;
  4. the witness is replayed serially: each transaction's reads must equal
     the model state EXACTLY (the workload reads whole registers) and its
     appends are applied; the end state must equal the final histories.

Step 4 is the independence payoff: even if an edge rule in either checker
is subtly wrong, a wrong witness cannot replay cleanly.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

from accord_tpu_torch.sim.verify import (ForensicsMixin, Observation, Violation,
                                   real_time_edges)


class _Phantom:
    """Synthesised observation for an unobserved committed append."""

    __slots__ = ("token", "value")

    def __init__(self, token: int, value: int):
        self.token = token
        self.value = value

    def __repr__(self):
        return f"Phantom({self.token}={self.value})"


class WitnessReplayVerifier(ForensicsMixin):
    """Same observe/verify surface as StrictSerializabilityVerifier."""

    def __init__(self):
        self.observations: List[Observation] = []

    def observe(self, obs: Observation) -> None:
        self.observations.append(obs)

    # ------------------------------------------------------------ verify --
    def verify(self, final_histories: Dict[int, Sequence[int]]) -> None:
        obs = self.observations
        n = len(obs)
        # (token, value) -> final position; duplicates are caught by the
        # primary checker, but re-assert (independence)
        pos: Dict[Tuple[int, int], int] = {}
        for token, hist in final_histories.items():
            for i, v in enumerate(hist):
                if (token, v) in pos:
                    raise Violation(f"duplicate {v} in key {token}")
                pos[(token, v)] = i

        # writers per (token, position): observed index or phantom
        writer: Dict[Tuple[int, int], int] = {}
        for i, o in enumerate(obs):
            for token, value in o.appends.items():
                p = pos.get((token, value))
                if p is None:
                    raise Violation(
                        f"lost append {value} to key {token} by {o}")
                if (token, p) in writer:
                    raise Violation(f"key {token} pos {p} written twice")
                writer[(token, p)] = i
        phantoms: List[_Phantom] = []
        for token, hist in final_histories.items():
            for p in range(len(hist)):
                if (token, p) not in writer:
                    writer[(token, p)] = n + len(phantoms)
                    phantoms.append(_Phantom(token, hist[p]))
        total = n + len(phantoms)

        # -- constraints (fresh derivation) --
        succ: List[set] = [set() for _ in range(total)]
        indeg = [0] * total

        def edge(a: int, b: int) -> None:
            if a != b and b not in succ[a]:
                succ[a].add(b)
                indeg[b] += 1

        for token, hist in final_histories.items():
            for p in range(1, len(hist)):
                edge(writer[(token, p - 1)], writer[(token, p)])
        for i, o in enumerate(obs):
            for token, read in o.reads.items():
                hist = tuple(final_histories.get(token, ()))
                if tuple(read) != hist[:len(read)]:
                    raise Violation(
                        f"read {read} of key {token} is not a prefix of "
                        f"{hist} ({o})")
                if read:
                    edge(writer[(token, len(read) - 1)], i)  # wr
                if len(read) < len(hist):
                    edge(i, writer[(token, len(read))])      # rw
        real_time_edges(obs, edge)

        # -- witness construction (deterministic smallest-index-first
        #    topological order via a heap: O(E log V)) --
        ready = [i for i in range(total) if indeg[i] == 0]
        heapq.heapify(ready)
        witness: List[int] = []
        while ready:
            a = heapq.heappop(ready)
            witness.append(a)
            for b in succ[a]:
                indeg[b] -= 1
                if indeg[b] == 0:
                    heapq.heappush(ready, b)
        if len(witness) != total:
            stuck = [obs[i].txn_desc if i < n else phantoms[i - n]
                     for i in range(total) if indeg[i] > 0]
            raise self._violation(
                f"no serial witness exists; cyclic constraints around "
                f"{stuck[:10]}{'...' if len(stuck) > 10 else ''}",
                txn_descs=[d for d in stuck[:10] if isinstance(d, str)])

        # -- model replay --
        state: Dict[int, List[int]] = {}
        for idx in witness:
            if idx >= n:
                ph = phantoms[idx - n]
                state.setdefault(ph.token, []).append(ph.value)
                continue
            o = obs[idx]
            for token, read in o.reads.items():
                got = tuple(state.get(token, ()))
                if tuple(read) != got:
                    # with forensics attached the raw model-state dump is
                    # superseded by the stitched flight timeline, which
                    # leads with the first diverging cross-replica event
                    raise self._violation(
                        f"witness replay mismatch: {o} read {read} of key "
                        f"{token} but the model held {got}",
                        txn_descs=[o.txn_desc],
                        brief=(f"witness replay mismatch: {o.txn_desc} "
                               f"read key {token} diverges from the serial "
                               f"witness"))
            for token, value in o.appends.items():
                state.setdefault(token, []).append(value)
        for token, hist in final_histories.items():
            if tuple(state.get(token, ())) != tuple(hist):
                raise self._violation(
                    f"witness end-state mismatch on key {token}: model "
                    f"{state.get(token)} vs final {tuple(hist)}")


class CompositeVerifier:
    """Run every verifier over the same observations (the reference's
    CompositeVerifier wrapping its own checker + Elle)."""

    def __init__(self, *verifiers):
        self.verifiers = verifiers

    def observe(self, obs: Observation) -> None:
        for v in self.verifiers:
            v.observe(obs)

    def attach_forensics(self, fn) -> None:
        """Propagate the flight-timeline hook to every member checker
        that supports it (sim/verify.ForensicsMixin)."""
        for v in self.verifiers:
            if hasattr(v, "attach_forensics"):
                v.attach_forensics(fn)

    def verify(self, final_histories: Dict[int, Sequence[int]]) -> None:
        for v in self.verifiers:
            v.verify(final_histories)

    @property
    def observations(self):
        """The shared observation stream (every member sees the same one);
        exported by the external-Elle harness (sim/elle_export.py)."""
        return self.verifiers[0].observations


def full_verifier(witness_replay: bool = True) -> CompositeVerifier:
    """THE checker roster, in one place so no call site can drift to a
    weaker oracle: constraint-graph cycle test, witness construction +
    model replay (optional — the black-box host paths skip it), and the
    ported Elle list-append analysis."""
    from accord_tpu_torch.sim.elle import ElleListAppendChecker
    from accord_tpu_torch.sim.verify import StrictSerializabilityVerifier
    vs = [StrictSerializabilityVerifier()]
    if witness_replay:
        vs.append(WitnessReplayVerifier())
    vs.append(ElleListAppendChecker())
    return CompositeVerifier(*vs)
