"""Arrival-rate schedules for the open-loop generator.

An open-loop client decides WHEN each op starts before the run begins; the
cluster's behavior can delay completions but never arrivals.  Schedules are
deterministic from (kind, rate, n, seed) so a lane is reproducible and a
regression bisectable — the Poisson schedule draws its exponential
inter-arrival gaps from the same `RandomSource` the sim uses everywhere.

All times are integer microsecond OFFSETS from the run's t0 (virtual or
wall); the runner adds its own epoch.
"""

from __future__ import annotations

import math
from typing import List

from accord_tpu_torch.utils.random_source import RandomSource

SCHEDULE_KINDS = ("poisson", "paced")


def paced_offsets_us(rate_per_s: float, n: int) -> List[int]:
    """Uniformly paced arrivals: op i at i/rate.  The harshest schedule for
    a batching tier (no natural bursts to coalesce)."""
    assert rate_per_s > 0 and n >= 0
    gap_us = 1e6 / rate_per_s
    return [int(i * gap_us) for i in range(n)]


def poisson_offsets_us(rate_per_s: float, n: int, seed: int) -> List[int]:
    """Poisson arrivals at `rate_per_s`: i.i.d. exponential gaps, the
    classic open-system model (bursts and lulls at every scale)."""
    assert rate_per_s > 0 and n >= 0
    rng = RandomSource(seed)
    at = 0.0
    out = []
    for _ in range(n):
        # inverse-CDF exponential; guard the u=0 edge of next_float
        u = rng.next_float()
        at += -math.log(1.0 - u if u < 1.0 else 0.5) * (1e6 / rate_per_s)
        out.append(int(at))
    return out


def make_offsets_us(kind: str, rate_per_s: float, n: int,
                    seed: int = 0) -> List[int]:
    if kind == "paced":
        return paced_offsets_us(rate_per_s, n)
    if kind == "poisson":
        return poisson_offsets_us(rate_per_s, n, seed)
    raise ValueError(f"unknown schedule kind {kind!r}; "
                     f"one of {SCHEDULE_KINDS}")
