"""The device time of every kernel the window ran, from the profiler's
trace, in ms a transaction applied."""


def read(run):
    if run.device != "cuda" or run.trace is None or not run.txns \
            or not run.trace["kernel_s"]:
        return None
    return run.trace["kernel_s"] * 1e3 / run.txns
