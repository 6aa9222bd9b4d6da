"""The device step's share of its roofline: the least time of every
succ_w, deps tile, in-window graph and K2 launch of the window (its least
bytes at the card's HBM bandwidth, ``roofline.py``) over the device time
the trace gives those launches, in %.  Only those steps: the range stab
(``bench.ranges``) is not among them."""

from accord_bench import roofline

STEPS = ("bench.deps", "bench.graph", "bench.waves")


def read(run):
    if run.device != "cuda" or run.trace is None:
        return None
    device_s = sum(run.trace["step_s"].get(k, 0.0) for k in STEPS)
    least_s = sum(roofline.least_seconds(run.least_bytes.get(k, 0))
                  for k in STEPS)
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
