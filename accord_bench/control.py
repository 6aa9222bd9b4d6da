"""The control: the reference put in the program's place with one guarantee
broken, to show that the check fails what it must fail.

The configurations state no numeric precision; they state strict
serializability.  The control breaks it the way a batched store is tempted
to: it serves every deps scan of a flush window from the conflict index
as it stood before the window's new transactions registered, so a
transaction misses the conflicts that arrived earlier in its own window
(what the program's version gate exists to prevent).  Its answers then go
through ``check.judge`` as the program's would, and ``replies_wrong`` must
come out above its limit.  The control's scans are all its own, so it
serves every scan the reference says the card must serve, and its waves
are the reference's layers of its own executeAts.

    python3 -m accord_bench.control --workload <cell> --seed <n>
                                    [--windows N]

runs the cell's warm-up and N windows more (default: as many as a run of
``run_seconds`` measures) and prints one JSON line with every
number and its limit.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

from accord_bench import check
from accord_bench.generate import Traffic
from accord_bench.reference.store import ReferenceStore

class SnapshotStore(ReferenceStore):
    """The reference, but no deps scan sees a transaction first witnessed
    in the scan's own window."""

    def run_window(self, ops) -> list:
        self._grow()
        self._fresh = {self.ids[i] for name, i in ops
                       if name == "preaccept" and self.status[i] == 0}
        return super().run_window(ops)

    def _deps(self, i: int, before: tuple) -> tuple:
        keyed, ranged = super()._deps(i, before)
        return tuple(d for d in keyed if d[1] not in self._fresh), ranged


def control_answers(traffic: Traffic, n_windows: int,
                    store_cls=SnapshotStore) -> SimpleNamespace:
    """The answers of `store_cls` (by default the control) to the first
    `n_windows` windows, as ``check.judge`` takes the program's."""
    store = store_cls(traffic.txns)
    run = SimpleNamespace(replies=[], applied=[], served=[], plans=[],
                          writes=[], store_faults=0)
    for w in range(n_windows):
        ops = traffic.ops(w)
        n0 = len(store.applied)
        run.served.append(store.served(ops))
        run.replies.append(store.run_window(ops))
        run.plans.append(store.waves(ops))
        done = store.applied[n0:]
        run.applied.append([traffic.txns[i][2] for i in done])
        run.writes += [(t, traffic.txns[i][2]) for i in done
                       for t in traffic.txns[i][5]]
    run.data = store.data()
    return run


def judge_control(config: dict, mix: dict, seed: int, n_windows: int,
                  store_cls=SnapshotStore):
    traffic = Traffic(config, mix, seed)
    return check.judge(traffic, control_answers(traffic, n_windows,
                                                store_cls))


def main(argv=None) -> int:
    from accord_bench.run import load_cell, measured_windows
    p = argparse.ArgumentParser(prog="accord_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--windows", type=int, default=None)
    args = p.parse_args(argv)
    cell, config, mix, _e2e, _per_layer = load_cell(args.workload)
    traffic = Traffic(config, mix, args.seed)
    n = args.windows if args.windows is not None \
        else traffic.warmup_windows + measured_windows(
            mix, cell["run_seconds"])
    numbers = judge_control(config, mix, args.seed, n)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "windows": n, "correct": check.is_correct(numbers),
                      "checks": {k: {"value": v, "limit": check.LIMITS[k]}
                                 for k, v in numbers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
