"""GeoProfile: named datacenters, per-node placement, and a deterministic
inter-DC latency matrix keyed by link class (intra / metro / wan).

One profile object serves every host:

  * the sim installs it into SimNetwork (`set_geo`) where the per-(src,dst)
    delay draw replaces the flat default-link draw — still one bounded
    `next_int` per delivery, so runs stay bit-identical per seed;
  * the TCP host reads it from ACCORD_GEO (the JSON spec below) and applies
    the NOMINAL one-way delay as an egress shim on the event loop's own
    scheduler — no `tc`, no root, wall-clock clusters see the same matrix;
  * the obs stack labels coordination outcomes by the coordinator's DC and
    buckets the transport census by `link_class` so WAN crossings/txn and
    WAN bytes/txn are first-class recorded numbers.

Latency bounds are ONE-WAY microseconds; an RTT is the sum of two
independent one-way draws, so `rtt_us(a, b)` (2x the nominal midpoint) is
the number a lane's `p50_rtt_multiple` is expressed against.

Spec (JSON, also the ACCORD_GEO env payload):

    {"name": "wan3",
     "dcs": {"dc_a": [1, 2, 3, 4], "dc_b": [5]},
     "classes": {"intra": [150, 400], "wan": [22500, 27500]},
     "pairs": [["dc_a", "dc_b", "wan", 22500, 27500]]}

`classes` overrides the per-class default one-way bounds; `pairs` assigns a
class and (optionally) bespoke bounds to a specific DC pair — unlisted
cross-DC pairs default to class "wan".
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

# default ONE-WAY bounds (us) per link class; a metro link is a nearby
# facility (~2-5 ms RTT), a wan link a cross-region backbone (~45-55 ms RTT)
DEFAULT_CLASS_BOUNDS_US: Dict[str, Tuple[int, int]] = {
    "intra": (150, 400),
    "metro": (1_500, 2_500),
    "wan": (22_500, 27_500),
}

LINK_CLASSES = ("intra", "metro", "wan")


def _pair_key(dc_a: str, dc_b: str) -> Tuple[str, str]:
    return (dc_a, dc_b) if dc_a <= dc_b else (dc_b, dc_a)


class GeoProfile:
    """Immutable DC layout + latency matrix (see module docstring)."""

    __slots__ = ("name", "dcs", "node_dc", "class_bounds_us",
                 "pair_overrides")

    def __init__(self, dcs: Dict[str, Iterable[int]], name: str = "geo",
                 class_bounds_us: Optional[Dict[str, Tuple[int, int]]] = None,
                 pairs: Optional[Iterable[Tuple]] = None):
        self.name = str(name)
        self.dcs: Dict[str, Tuple[int, ...]] = {
            str(dc): tuple(sorted(int(n) for n in nodes))
            for dc, nodes in dcs.items()}
        self.node_dc: Dict[int, str] = {}
        for dc, nodes in self.dcs.items():
            for n in nodes:
                if n in self.node_dc:
                    raise ValueError(f"node {n} assigned to both "
                                     f"{self.node_dc[n]} and {dc}")
                self.node_dc[n] = dc
        self.class_bounds_us: Dict[str, Tuple[int, int]] = dict(
            DEFAULT_CLASS_BOUNDS_US)
        for cls, bounds in (class_bounds_us or {}).items():
            lo, hi = int(bounds[0]), int(bounds[1])
            self.class_bounds_us[str(cls)] = (lo, hi)
        # (dc, dc) sorted pair -> (class, lo_us, hi_us)
        self.pair_overrides: Dict[Tuple[str, str], Tuple[str, int, int]] = {}
        for entry in (pairs or ()):
            dc_a, dc_b, cls = str(entry[0]), str(entry[1]), str(entry[2])
            if len(entry) >= 5:
                lo, hi = int(entry[3]), int(entry[4])
            else:
                lo, hi = self.class_bounds_us[cls]
            self.pair_overrides[_pair_key(dc_a, dc_b)] = (cls, lo, hi)

    # ------------------------------------------------------------ queries --
    def dc_of(self, node_id: int) -> Optional[str]:
        return self.node_dc.get(node_id)

    def nodes_in(self, dc: str) -> Tuple[int, ...]:
        return self.dcs.get(dc, ())

    def link_class(self, src: int, dst: int) -> Optional[str]:
        """intra | metro | wan — None when either endpoint is unplaced
        (the caller falls back to its flat default behavior)."""
        a, b = self.node_dc.get(src), self.node_dc.get(dst)
        if a is None or b is None:
            return None
        if a == b:
            return "intra"
        over = self.pair_overrides.get(_pair_key(a, b))
        return over[0] if over is not None else "wan"

    def delay_bounds_us(self, src: int, dst: int
                        ) -> Optional[Tuple[int, int]]:
        """One-way (lo, hi) us for this ordered pair; None when unplaced."""
        a, b = self.node_dc.get(src), self.node_dc.get(dst)
        if a is None or b is None:
            return None
        if a == b:
            return self.class_bounds_us["intra"]
        over = self.pair_overrides.get(_pair_key(a, b))
        if over is not None:
            return (over[1], over[2])
        return self.class_bounds_us["wan"]

    def one_way_nominal_us(self, src: int, dst: int) -> Optional[int]:
        """Midpoint one-way delay — the TCP shim's constant per-pair delay
        (constant per pair keeps per-lane frame order trivially intact)."""
        bounds = self.delay_bounds_us(src, dst)
        return (bounds[0] + bounds[1]) // 2 if bounds is not None else None

    def rtt_us(self, dc_a: str, dc_b: str) -> int:
        """Nominal RTT between two DCs: 2x the midpoint one-way delay.
        This is the 'injected WAN RTT' a lane's latency multiples cite."""
        if dc_a == dc_b:
            lo, hi = self.class_bounds_us["intra"]
        else:
            over = self.pair_overrides.get(_pair_key(dc_a, dc_b))
            lo, hi = (over[1], over[2]) if over is not None \
                else self.class_bounds_us["wan"]
        return 2 * ((lo + hi) // 2)

    # ------------------------------------------------------------- codecs --
    def to_spec(self) -> dict:
        """JSON-friendly spec (the ACCORD_GEO env payload)."""
        return {
            "name": self.name,
            "dcs": {dc: list(nodes) for dc, nodes in sorted(self.dcs.items())},
            "classes": {cls: list(b) for cls, b
                        in sorted(self.class_bounds_us.items())},
            "pairs": [[a, b, cls, lo, hi] for (a, b), (cls, lo, hi)
                      in sorted(self.pair_overrides.items())],
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "GeoProfile":
        return cls(spec["dcs"], name=spec.get("name", "geo"),
                   class_bounds_us=spec.get("classes"),
                   pairs=spec.get("pairs"))

    @classmethod
    def from_env(cls, value: Optional[str]) -> Optional["GeoProfile"]:
        """Parse the ACCORD_GEO env payload (JSON spec, or empty/None)."""
        if not value:
            return None
        return cls.from_spec(json.loads(value))

    def to_wire(self) -> tuple:
        """Canonical nested-tuple form for EpochInstall frames (wire.py's
        structural codec round-trips tuples of str/int losslessly)."""
        return (
            self.name,
            tuple((dc, tuple(nodes))
                  for dc, nodes in sorted(self.dcs.items())),
            tuple((cls, int(lo), int(hi)) for cls, (lo, hi)
                  in sorted(self.class_bounds_us.items())),
            tuple((a, b, cls, int(lo), int(hi))
                  for (a, b), (cls, lo, hi)
                  in sorted(self.pair_overrides.items())),
        )

    @classmethod
    def from_wire(cls, wire) -> "GeoProfile":
        name, dcs, classes, pairs = wire
        return cls({dc: nodes for dc, nodes in dcs}, name=name,
                   class_bounds_us={c: (lo, hi) for c, lo, hi in classes},
                   pairs=pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, GeoProfile) and \
            self.to_wire() == other.to_wire()

    def __repr__(self) -> str:
        return (f"GeoProfile({self.name!r}, dcs="
                f"{{{', '.join(f'{d}:{len(n)}' for d, n in sorted(self.dcs.items()))}}})")


def wan3_profile(hub: int = 4) -> GeoProfile:
    """The slo-wan lane's layout: a hub DC holding a full slow-path quorum
    (`hub` nodes) plus three single-node DCs at increasing WAN distance —
    RTT ~50 ms (dc_b), ~100 ms (dc_c), ~160 ms (dc_d) from the hub.

    With rf = hub + 3 the slow-path/stable quorum (rf - f) fits inside the
    hub, so the client-visible latency is governed by how far the fast-path
    ELECTORATE reaches: a minimal electorate spanning to dc_b commits in
    ~1x the dc_a<->dc_b RTT, while the all-replicas electorate's larger
    fast quorum must additionally hear dc_c — measurably worse."""
    n = int(hub)
    return GeoProfile(
        dcs={"dc_a": range(1, n + 1), "dc_b": (n + 1,),
             "dc_c": (n + 2,), "dc_d": (n + 3,)},
        name="wan3",
        pairs=[
            ("dc_a", "dc_b", "wan", 22_500, 27_500),   # RTT ~50 ms
            ("dc_a", "dc_c", "wan", 45_000, 55_000),   # RTT ~100 ms
            ("dc_a", "dc_d", "wan", 75_000, 85_000),   # RTT ~160 ms
            ("dc_b", "dc_c", "wan", 35_000, 45_000),
            ("dc_b", "dc_d", "wan", 55_000, 65_000),
            ("dc_c", "dc_d", "wan", 45_000, 55_000),
        ])
