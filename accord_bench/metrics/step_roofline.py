"""The device step's share of its roofline: the least time of every
succ_w, deps tile, in-window graph and K2 launch of the window (its least
bytes at the card's HBM bandwidth, ``roofline.py``) over the device time
the trace gives those launches, in %."""

from accord_bench import roofline


def read(run):
    if run.device != "cuda" or run.trace is None:
        return None
    device_s = sum(run.trace["step_s"].get(k, 0.0) for k in run.least_bytes)
    least_s = sum(roofline.least_seconds(b) for b in run.least_bytes.values())
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
