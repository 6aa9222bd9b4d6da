"""Read-through views: registry-backed attributes with legacy call sites.

The three pre-registry stat surfaces (`Node.infer_stats`, the device
store's `device_*` ints, `PipelineStats`' counters) are mutated all over
the engine with plain `obj.attr += 1` / `stats[key] += 1`.  Migrating them
onto the registry must not churn those call sites — so the OLD attribute
names stay, as descriptors/dict-views whose storage IS a registry metric.
"""

from __future__ import annotations

from typing import Dict, Iterable


class MetricView:
    """Class-level descriptor making `obj.attr` an int view over a registry
    Counter/Gauge.  `bind_metric_views(obj, registry, **labels)` must run
    (normally first thing in __init__) before any access; after that,
    `obj.attr += 1` and `obj.attr = max(obj.attr, x)` work unchanged while
    the value lives in the registry."""

    __slots__ = ("metric", "kind", "_attr")

    def __init__(self, metric: str, kind: str = "counter"):
        self.metric = metric
        self.kind = kind
        self._attr = None

    def __set_name__(self, owner, name):
        self._attr = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._obs_metrics[self._attr].value

    def __set__(self, obj, value):
        obj._obs_metrics[self._attr].value = value


def bind_metric_views(obj, registry, **labels) -> None:
    """Create the per-instance metric objects behind every MetricView
    declared on `type(obj)` (registry get-or-create, so two instances with
    identical labels share one metric)."""
    metrics: Dict[str, object] = {}
    for klass in type(obj).__mro__:
        for name, desc in vars(klass).items():
            if isinstance(desc, MetricView) and name not in metrics:
                make = (registry.gauge if desc.kind == "gauge"
                        else registry.counter)
                metrics[name] = make(desc.metric, **labels)
    object.__setattr__(obj, "_obs_metrics", metrics)


class CounterDict:
    """Dict-shaped view over one labeled counter family: `d[key] += n`
    increments `name{<label>=key}`.  Fixed key set (the legacy dicts were
    fixed-shape); equality against plain dicts keeps test assertions
    working."""

    __slots__ = ("_metrics",)

    def __init__(self, registry, name: str, keys: Iterable[str],
                 label: str = "kind", **labels):
        self._metrics = {k: registry.counter(name, **{label: k}, **labels)
                         for k in keys}

    def __getitem__(self, key):
        return self._metrics[key].value

    def __setitem__(self, key, value):
        self._metrics[key].value = value

    def get(self, key, default=0):
        m = self._metrics.get(key)
        return m.value if m is not None else default

    def keys(self):
        return self._metrics.keys()

    def values(self):
        return [m.value for m in self._metrics.values()]

    def items(self):
        return [(k, m.value) for k, m in self._metrics.items()]

    def as_dict(self) -> dict:
        return dict(self.items())

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self):
        return len(self._metrics)

    def __contains__(self, key):
        return key in self._metrics

    def __eq__(self, other):
        if isinstance(other, CounterDict):
            return self.as_dict() == other.as_dict()
        return self.as_dict() == other

    def __repr__(self):
        return repr(self.as_dict())
