"""Export burn/host observations as a jepsen/Elle list-append EDN history.

The reference drives the REAL Elle checker (Clojure) over its histories
(accord-core test verify/ElleVerifier.java:47, deps build.gradle:36-46); our
in-tree port (sim/elle.py) implements the published algorithm but is still
this repo's code.  This exporter closes the oracle-trust gap: it renders the
exact observation stream our checkers consume in the EDN history format the
external Elle tooling (e.g. elle-cli) reads, so a real Elle binary — when one
is available in the environment — can adjudicate the same histories
(tests/test_elle_external.py drives it as a subprocess).

Format (one event map per line, jepsen-style):
    {:index 0, :type :invoke, :process 3, :time 12000, :f :txn,
     :value [[:append 5 1] [:r 5 nil]]}
    {:index 1, :type :ok, ...,  :value [[:append 5 1] [:r 5 [1 2]]]}

Each observation becomes one logical process (clients here are one-shot), so
per-process well-formedness is trivial and Elle's realtime analysis recovers
exactly the completion-before-invocation edges our own checkers use: events
are emitted in virtual-time order with :invoke sorting before :ok at the
same instant.  Same-instant completion/invocation pairs across processes
are therefore treated as CONCURRENT (no realtime edge) — the convention of
sim/verify.real_time_edges, conservative for the checker, and it keeps a
zero-duration op's own :invoke ahead of its :ok (a malformed history
otherwise).
"""

from __future__ import annotations

from typing import List, Sequence


def _micro_ops(obs, invoke: bool) -> str:
    ops: List[str] = []
    for token in sorted(obs.appends):
        ops.append(f"[:append {token} {obs.appends[token]}]")
    for token in sorted(obs.reads):
        if invoke:
            ops.append(f"[:r {token} nil]")
        else:
            vals = " ".join(str(v) for v in obs.reads[token])
            ops.append(f"[:r {token} [{vals}]]")
    return "[" + " ".join(ops) + "]"


def to_edn_history(observations: Sequence) -> str:
    """Render observations (sim/verify.Observation) as an EDN history,
    one event per line, sorted by virtual time."""
    events = []
    for process, obs in enumerate(observations):
        # sort key: (time, phase) with :invoke (0) before :ok (1) at the
        # same instant — same-instant pairs are concurrent (module doc),
        # and a zero-duration op keeps its own invoke→ok order
        events.append((obs.start_us, 0, ":invoke", process,
                       _micro_ops(obs, invoke=True)))
        events.append((obs.end_us, 1, ":ok", process,
                       _micro_ops(obs, invoke=False)))
    events.sort(key=lambda e: (e[0], e[1]))
    lines = []
    for index, (t_us, _phase, etype, process, value) in enumerate(events):
        lines.append(
            "{:index %d, :type %s, :process %d, :time %d, :f :txn, "
            ":value %s}" % (index, etype, process, t_us * 1000, value))
    return "\n".join(lines) + "\n"
