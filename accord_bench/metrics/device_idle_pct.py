"""The share of the measured window in which no kernel, copy or memset
ran on the card, from the profiler's trace, in %."""


def read(run):
    if run.device != "cuda" or run.trace is None \
            or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
