"""Store serving (the state machine's transitions and the served scans, on
the host): the measured window's wall time less the store's flush laps,
in ms a transaction applied.  Source: the store's profiler laps
(``obs/profiler.py``), on in the traced run."""


def read(run):
    if not run.laps_s or not run.txns:
        return None
    return (run.seconds - sum(run.laps_s.values())) * 1e3 / run.txns
