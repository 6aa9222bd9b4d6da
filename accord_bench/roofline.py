"""Peaks of the card and the least bytes each device step must move.

The byte counts are copied from ``chip_smoke.py`` at commit f0ab6b5 (the
K1, K2, succ_w and graph counts of its timing phase), written as functions
of a launch's shapes.  Each counts the step's inputs read once and its
outputs written once, so they hold whatever implements the step.  The
steps' operation counts depend on the data (which pairs share a key, how
many writes a key holds), so the least time here is the byte bound alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense tensor and vector peaks
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "fp32_flops_per_s": 67e12,
    "int8_ops_per_s": 1979e12,
}


def deps_bytes(b: int, k: int, e: int) -> int:
    """succ_w (K6) then the deps tile (K1) over B probes of K key columns
    and E entries: K6 reads five int32 [E] entry arrays and writes one; K1
    reads touches [B, K] bool, six int32 [E] arrays and two int32 [B], and
    writes the [B, E] bool mask and the int32 [B] counts."""
    if 0 in (b, k, e):
        return 0
    return 6 * 4 * e + (b * k + 6 * 4 * e + 2 * 4 * b + b * e + 4 * b)


def graph_bytes(b: int, k: int) -> int:
    """The in-window graph: three int32 [B] vectors and touches [B, K] bool
    read, the [B, B] bool graph written."""
    return 3 * 4 * b + b * k + b * b


def waves_bytes(b: int) -> int:
    """K2: the [B, B] bool graph and int32 [B] ranks read, int32 [B] waves
    written."""
    return b * b + 4 * b + 4 * b


def least_seconds(nbytes: int) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]
