"""The 95th percentile, over every transaction whose PreAccept was
submitted and whose Apply executed in the measured window, of the time
from the one to the other (host clock; paced by the host, hence
per-layer)."""

import statistics


def read(run):
    if len(run.lifecycle_ms) < 20:
        return None
    return statistics.quantiles(run.lifecycle_ms, n=20)[-1]
