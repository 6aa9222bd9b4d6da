"""What decides ``correct``: the program's answers against the reference's.

Every op of every window a run drove (its warm-up included) is compared,
after the measured window has closed.  All answers are exact, so every
limit is 0:

* ``replies_wrong``: ops whose reply (outcome, executeAt, deps) differs;
* ``applies_missing``: transactions whose Apply was sent and that did not
  apply by the end of that window, or applied twice;
* ``data_wrong``: keys whose data differs from the reference's;
* ``writes_out_of_order``: writes that ran at a key after a write with a
  later executeAt;
* ``scans_off_card``: deps scans that the window's flush had to serve
  from the card (the reference's ``served``) and the store served on the
  host instead, counted window by window;
* ``waves_wrong``: Applies whose wave in the store's plan differs from the
  reference's Kahn layer of the window's Apply graph (or that the plan
  left out or added);
* ``store_faults``: the store left its device tier or recorded a failure.
"""

from __future__ import annotations

from typing import Dict, List

from accord_bench.reference.store import ReferenceStore

LIMITS = {"replies_wrong": 0, "applies_missing": 0, "data_wrong": 0,
          "writes_out_of_order": 0, "scans_off_card": 0, "waves_wrong": 0,
          "store_faults": 0}


def out_of_order(writes) -> int:
    """Writes that ran after a write with a later executeAt at their key."""
    latest: Dict[int, int] = {}
    n = 0
    for token, hlc in writes:
        if hlc < latest.get(token, -1):
            n += 1
        else:
            latest[token] = hlc
    return n


def waves_wrong(got: Dict[int, int], want: Dict[int, int]) -> int:
    return sum(got.get(h) != w for h, w in want.items()) \
        + sum(h not in want for h in got)


def judge(traffic, run) -> Dict[str, int]:
    """-> {number: value}.  `run` holds what the program gave, window by
    window: `replies`, `applied` (the hlcs that applied), `served` (deps
    scans served from the card), `plans` ({hlc: wave}); and at the end
    `data` (its data store), `writes` (its write log) and `store_faults`."""
    ref = ReferenceStore(traffic.txns)
    replies = applies = off_card = waves = 0
    for w, got in enumerate(run.replies):
        ops = traffic.ops(w)
        off_card += max(0, ref.served(ops) - run.served[w])
        want = ref.run_window(ops)
        replies += sum(g != x for g, x in zip(got, want))
        replies += abs(len(got) - len(want))
        waves += waves_wrong(run.plans[w], ref.waves(ops))
        due = sorted(traffic.txns[i][2] for i in traffic.applied_batch(w))
        applies += len(set(due) ^ set(run.applied[w])) \
            + len(run.applied[w]) - len(set(run.applied[w]))
    want_data = ref.data()
    data_wrong = sum(run.data.get(t) != v for t, v in want_data.items()) \
        + sum(t not in want_data for t in run.data)
    return {"replies_wrong": replies,
            "applies_missing": applies,
            "data_wrong": data_wrong,
            "writes_out_of_order": out_of_order(run.writes),
            "scans_off_card": off_card,
            "waves_wrong": waves,
            "store_faults": run.store_faults}


def is_correct(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
