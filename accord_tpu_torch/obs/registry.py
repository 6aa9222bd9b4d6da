"""Process-local metrics registry: counters, gauges, log-bucketed histograms.

Plain Python on the host path — no jax, no numpy, no allocation beyond the
metric objects themselves.  Metric identity is (name, labels); get-or-create
is the only locked operation (hosts mutate from their single loop thread;
reader threads only snapshot).

Naming convention (README "Observability"): `accord_<area>_<what>[_total]`
with snake_case label keys — `_total` suffix for monotonic counters,
`_us` suffix for microsecond-valued histograms.

Snapshot format (JSON-safe, mergeable across nodes/processes):

    {"counters":   {name: {label_key: value}},
     "gauges":     {name: {label_key: value}},
     "histograms": {name: {label_key: {"count": n, "sum": s,
                                       "buckets": {exp: n}}}}}

where `label_key` is the canonical "k=v,k2=v2" string ("" for no labels)
and a histogram bucket `exp` counts observations v with
2**(exp-1) < v <= 2**exp (exp "0" holds v <= 1).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


def _label_key(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_labels(label_key: str) -> Dict[str, str]:
    """Inverse of the snapshot's canonical label string."""
    if not label_key:
        return {}
    out = {}
    for part in label_key.split(","):
        k, _, v = part.partition("=")
        out[k] = v
    return out


class Counter:
    """Monotonic-by-convention counter.  `value` is directly assignable so
    read-through views (obs/views.MetricView) can keep legacy `attr += 1` /
    `attr = max(...)` call sites working unchanged."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self):
        return f"Counter({self.name}{self.labels or ''}={self.value})"


class Gauge(Counter):
    """Point-in-time value; same shape as Counter, different snapshot
    section (and different cross-node merge: max, not sum)."""

    __slots__ = ()

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Log2-bucketed histogram: observe(v) lands in bucket ceil(log2(v)),
    i.e. bucket e counts 2**(e-1) < v <= 2**e (e=0 holds v <= 1).  One dict
    op per observation; quantiles are bucket-upper-bound approximations,
    which is all a latency breakdown needs.

    ERROR BOUND (pinned for the JAX package's copy by tests/test_obs.py): for any distribution and
    any q, the reported quantile r and the exact same-rank sample value v
    satisfy v <= r < 2*v (for v >= 1) — r is the upper bound of v's
    bucket.  Monitoring tolerates a [1x, 2x) one-sided bound; a tail-
    latency GATE does not, which is why every SLO lane and the profiler
    use raw-sample exact quantiles (obs/report.exact_quantiles_us)."""

    __slots__ = ("name", "labels", "count", "sum", "buckets")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0
        self.buckets: Dict[int, int] = {}

    def observe(self, v) -> None:
        self.count += 1
        self.sum += v
        e = 0 if v <= 1 else (int(v) - 1).bit_length()
        self.buckets[e] = self.buckets.get(e, 0) + 1

    def quantile(self, q: float):
        """Upper bound of the bucket holding the q-quantile observation
        (None when empty)."""
        if self.count == 0:
            return None
        rank = max(1, int(q * self.count + 0.9999999))
        seen = 0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            if seen >= rank:
                return 1 << e if e else 1
        return 1 << max(self.buckets)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __repr__(self):
        return (f"Histogram({self.name}{self.labels or ''} "
                f"count={self.count} mean={self.mean:.1f})")


class Registry:
    """Get-or-create metric store.  Creation is locked (reader/writer
    threads on the TCP host); mutation of an existing metric is a plain
    attribute update on the single owning loop thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], Counter] = {}
        self._gauges: Dict[Tuple[str, str], Gauge] = {}
        self._histograms: Dict[Tuple[str, str], Histogram] = {}

    # ------------------------------------------------------ get-or-create --
    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def _get(self, table, cls, name, labels):
        # canonical label string built without the per-call dict copy the
        # hot paths used to pay (str-izing happens in the f-format; values
        # are verbs/phases/ints, for which format == str); the full copy
        # only runs on the miss path when the metric is created
        if not labels:
            lk = ""
        elif len(labels) == 1:
            (k, v), = labels.items()
            lk = f"{k}={v}"
        else:
            lk = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        key = (name, lk)
        m = table.get(key)
        if m is None:
            with self._lock:
                m = table.get(key)
                if m is None:
                    m = table[key] = cls(name, {k: str(v)
                                                for k, v in labels.items()})
        return m

    # -------------------------------------------------------------- query --
    def value(self, name: str, **labels) -> int:
        """Current value of one counter/gauge (0 when absent)."""
        key = (name, _label_key({k: str(v) for k, v in labels.items()}))
        m = self._counters.get(key) or self._gauges.get(key)
        return m.value if m is not None else 0

    def total(self, name: str) -> int:
        """Sum of a counter over every label set."""
        return sum(c.value for (n, _), c in self._counters.items()
                   if n == name)

    def find_histograms(self, name: str):
        return [h for (n, _), h in self._histograms.items() if n == name]

    # ----------------------------------------------------------- snapshot --
    def snapshot(self) -> dict:
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, lk), c in list(self._counters.items()):
            out["counters"].setdefault(name, {})[lk] = c.value
        for (name, lk), g in list(self._gauges.items()):
            out["gauges"].setdefault(name, {})[lk] = g.value
        for (name, lk), h in list(self._histograms.items()):
            out["histograms"].setdefault(name, {})[lk] = {
                "count": h.count, "sum": h.sum,
                "buckets": {str(e): n for e, n in sorted(h.buckets.items())}}
        return out

    # --------------------------------------------------------- prometheus --
    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, histograms with
        cumulative `le` buckets in native units)."""
        lines = []

        def fmt(name, labels, value, extra=None):
            lab = dict(labels)
            if extra:
                lab.update(extra)
            if lab:
                body = ",".join(f'{k}="{v}"' for k, v in sorted(lab.items()))
                lines.append(f"{name}{{{body}}} {value}")
            else:
                lines.append(f"{name} {value}")

        for kind, table in (("counter", self._counters),
                            ("gauge", self._gauges)):
            seen = set()
            for (name, _), m in sorted(table.items()):
                if name not in seen:
                    seen.add(name)
                    lines.append(f"# TYPE {name} {kind}")
                fmt(name, m.labels, m.value)
        seen = set()
        for (name, _), h in sorted(self._histograms.items()):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} histogram")
            acc = 0
            for e in sorted(h.buckets):
                acc += h.buckets[e]
                fmt(f"{name}_bucket", h.labels, acc,
                    {"le": str(1 << e if e else 1)})
            fmt(f"{name}_bucket", h.labels, h.count, {"le": "+Inf"})
            fmt(f"{name}_sum", h.labels, h.sum)
            fmt(f"{name}_count", h.labels, h.count)
        return "\n".join(lines) + "\n"


def merge_snapshots(snapshots) -> dict:
    """Merge registry snapshots across nodes/processes: counters and
    histogram buckets sum; gauges take the max (they are high-water marks
    or instantaneous depths — summing drifted instants is meaningless)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not snap:
            continue
        for name, by_label in snap.get("counters", {}).items():
            dst = out["counters"].setdefault(name, {})
            for lk, v in by_label.items():
                dst[lk] = dst.get(lk, 0) + v
        for name, by_label in snap.get("gauges", {}).items():
            dst = out["gauges"].setdefault(name, {})
            for lk, v in by_label.items():
                dst[lk] = max(dst.get(lk, v), v)
        for name, by_label in snap.get("histograms", {}).items():
            dst = out["histograms"].setdefault(name, {})
            for lk, h in by_label.items():
                cur = dst.setdefault(lk, {"count": 0, "sum": 0,
                                          "buckets": {}})
                cur["count"] += h.get("count", 0)
                cur["sum"] += h.get("sum", 0)
                for e, n in h.get("buckets", {}).items():
                    cur["buckets"][e] = cur["buckets"].get(e, 0) + n
    return out


def snapshot_quantile(hist_snap: dict, q: float):
    """Quantile (bucket upper bound) from a snapshot-format histogram."""
    count = hist_snap.get("count", 0)
    if not count:
        return None
    rank = max(1, int(q * count + 0.9999999))
    seen = 0
    for e in sorted(hist_snap.get("buckets", {}), key=int):
        seen += hist_snap["buckets"][e]
        if seen >= rank:
            return 1 << int(e) if int(e) else 1
    return None
