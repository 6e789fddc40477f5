"""Zone-aware cluster network topology with contended, fair-shared links.

The paper's evaluation (and the seed sim) models one uncontended registry
link: every transfer was charged ``bytes / registry_bw_Bps`` in isolation,
so N concurrent migrations each moved at full bandwidth.  This module
replaces that with an explicit topology:

  * every node belongs to a **zone**; the registry has its own attachment
    zone (``registry_zone``);
  * traffic between two zones rides one shared :class:`~repro_torch.cluster.sim.Link`
    per zone pair, classified as ``intra`` (same zone), ``cross``
    (different zones, same site) or ``wan`` (zone pairs listed in
    ``wan_pairs``), each with its own capacity, per-transfer latency and
    sharing mode;
  * concurrent transfers on a shared link split bandwidth max-min style
    (progressive filling — see ``sim.Link``), so fleet migrations finally
    pay for their concurrency.

Presets (``make_topology``):

  * ``flat``     — one zone, one dedicated-capacity link: **bit-identical**
    to the seed's single-registry-link constants (the backward-compat
    default);
  * ``two_zone`` — two equal zones, registry in zone-a; cross-zone traffic
    shares a 4x thinner link;
  * ``edge_wan`` — a core site (with the registry) and an edge site behind
    a 20x thinner, high-latency WAN uplink.

A ``NetworkTopology`` binds to exactly one ``Sim`` (links hold sim state);
build a fresh instance — or pass the preset name / a factory — per
experiment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional

from repro_torch.cluster.sim import Link, Sim

LINK_CLASSES = ("intra", "cross", "wan")
_CLASS_RANK = {"intra": 0, "cross": 1, "wan": 2}


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Capacity + per-transfer latency + sharing mode of one link class."""

    capacity_Bps: float
    latency_s: float = 0.0
    shared: bool = True


class NetworkTopology:
    """Nodes -> zones, a registry attachment zone, and one lazily-built
    shared ``Link`` per zone pair."""

    def __init__(self, name: str, zone_of: Dict[str, str],
                 registry_zone: str, link_specs: Dict[str, LinkSpec],
                 wan_pairs: Iterable[Iterable[str]] = ()):
        if "intra" not in link_specs:
            raise ValueError("link_specs needs at least an 'intra' entry")
        unknown = set(link_specs) - set(LINK_CLASSES)
        if unknown:
            raise ValueError(f"unknown link class(es): {sorted(unknown)}")
        self.name = name
        self.zone_of = dict(zone_of)
        self.registry_zone = registry_zone
        self.link_specs = dict(link_specs)
        self.link_specs.setdefault("cross", self.link_specs["intra"])
        self.link_specs.setdefault("wan", self.link_specs["cross"])
        self.wan_pairs: set = {frozenset(p) for p in wan_pairs}
        self._sim: Optional[Sim] = None
        self._links: Dict[FrozenSet[str], Link] = {}

    # -- binding ---------------------------------------------------------------
    def bind(self, sim: Sim) -> "NetworkTopology":
        """Attach to a Sim.  One topology serves one cluster: links carry
        sim state, so rebinding to a different sim is an error."""
        if self._sim is not None and self._sim is not sim:
            raise RuntimeError(
                f"topology {self.name!r} is already bound to another Sim; "
                "build a fresh NetworkTopology per cluster/experiment")
        self._sim = sim
        return self

    def is_multizone(self) -> bool:
        """More than one distinct zone exists (nodes or registry)."""
        return len(set(self.zone_of.values()) | {self.registry_zone}) > 1

    def ensure_node(self, node: str, zone: Optional[str] = None) -> None:
        """Register a node in ``zone``.

        Already-registered nodes are left alone unless ``zone``
        contradicts the registration (that is a wiring bug, not a
        default).  For an unknown node, ``zone=None`` is only acceptable
        while the topology is single-zone (there is exactly one answer);
        on a multi-zone topology it would silently file the node next to
        the registry — ``zone_distance == 0`` — and every placement
        scorer (and the rebalance controller) would systematically
        prefer it, so an explicit zone is required there."""
        have = self.zone_of.get(node)
        if have is not None:
            if zone is not None and zone != have:
                raise ValueError(
                    f"node {node!r} is already in zone {have!r}; "
                    f"cannot re-register it in {zone!r}")
            return
        if zone is None:
            if self.is_multizone():
                raise ValueError(
                    f"node {node!r} needs an explicit zone on multi-zone "
                    f"topology {self.name!r} (zones: "
                    f"{sorted(set(self.zone_of.values()) | {self.registry_zone})}); "
                    "defaulting to the registry zone would give it "
                    "zone_distance == 0 and bias every placement score "
                    "toward it")
            zone = self.registry_zone
        self.zone_of[node] = zone

    # -- classification --------------------------------------------------------
    def zone(self, node: Optional[str]) -> str:
        if node is None:
            return self.registry_zone
        return self.zone_of.get(node, self.registry_zone)

    def link_class(self, zone_a: str, zone_b: str) -> str:
        if zone_a == zone_b:
            return "intra"
        if frozenset((zone_a, zone_b)) in self.wan_pairs:
            return "wan"
        return "cross"

    def zone_distance(self, zone_a: str, zone_b: str) -> int:
        """Rank of the link class between two zones: intra=0 cross=1 wan=2
        (the placement score's distance term)."""
        return _CLASS_RANK[self.link_class(zone_a, zone_b)]

    # -- links -----------------------------------------------------------------
    def link_between(self, zone_a: str, zone_b: str) -> Link:
        if self._sim is None:
            raise RuntimeError(
                f"topology {self.name!r} is not bound to a Sim yet")
        key = frozenset((zone_a, zone_b))
        link = self._links.get(key)
        if link is None:
            cls = self.link_class(zone_a, zone_b)
            spec = self.link_specs[cls]
            link = Link(self._sim, spec.capacity_Bps,
                        latency_s=spec.latency_s, shared=spec.shared,
                        name=f"{cls}:{'|'.join(sorted(key))}")
            self._links[key] = link
        return link

    def registry_link(self, node: Optional[str]) -> Link:
        """The link a node's registry traffic (push/pull/prefetch) rides."""
        return self.link_between(self.zone(node), self.registry_zone)

    def registry_capacity_Bps(self, node: Optional[str] = None) -> float:
        return self.link_specs[
            self.link_class(self.zone(node), self.registry_zone)].capacity_Bps

    def links(self) -> List[Link]:
        return [self._links[k] for k in sorted(self._links,
                                               key=lambda k: sorted(k))]

    def stats(self) -> Dict[str, Any]:
        """Telemetry for reports/benchmarks: per-link byte/flow counters."""
        return {"topology": self.name,
                "zones": sorted(set(self.zone_of.values())
                                | {self.registry_zone}),
                "links": [link.stats() for link in self.links()]}


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def _split_zones(node_names: Iterable[str], first: str, second: str
                 ) -> Dict[str, str]:
    """First half of the nodes in ``first`` (at least one), rest in
    ``second`` — the deterministic preset layout."""
    names = list(node_names)
    cut = max(1, len(names) // 2)
    return {n: (first if i < cut else second) for i, n in enumerate(names)}


def flat_topology(node_names: Iterable[str] = (),
                  registry_bw_Bps: float = 200e6) -> NetworkTopology:
    """One zone, one dedicated-capacity registry link: bit-identical to
    the seed's uncontended ``bytes / registry_bw_Bps`` model."""
    return NetworkTopology(
        "flat", {n: "flat" for n in node_names}, "flat",
        {"intra": LinkSpec(registry_bw_Bps, latency_s=0.0, shared=False)})


def two_zone_topology(node_names: Iterable[str] = (),
                      registry_bw_Bps: float = 200e6,
                      cross_ratio: float = 0.25,
                      intra_latency_s: float = 0.02,
                      cross_latency_s: float = 0.1) -> NetworkTopology:
    """Two equal zones (registry in zone-a); each zone's fabric and the
    cross-zone trunk are shared, the trunk 4x thinner."""
    return NetworkTopology(
        "two_zone", _split_zones(node_names, "zone-a", "zone-b"), "zone-a",
        {"intra": LinkSpec(registry_bw_Bps, latency_s=intra_latency_s),
         "cross": LinkSpec(registry_bw_Bps * cross_ratio,
                           latency_s=cross_latency_s)})


def edge_wan_topology(node_names: Iterable[str] = (),
                      registry_bw_Bps: float = 200e6,
                      wan_ratio: float = 0.05,
                      intra_latency_s: float = 0.01,
                      wan_latency_s: float = 0.3) -> NetworkTopology:
    """A core site (first half of the nodes, with the registry) and an
    edge site behind a 20x thinner, high-latency shared WAN uplink."""
    return NetworkTopology(
        "edge_wan", _split_zones(node_names, "core", "edge"), "core",
        {"intra": LinkSpec(registry_bw_Bps, latency_s=intra_latency_s),
         "wan": LinkSpec(registry_bw_Bps * wan_ratio,
                         latency_s=wan_latency_s)},
        wan_pairs=[("core", "edge")])


TOPOLOGY_PRESETS: Dict[str, Callable[..., NetworkTopology]] = {
    "flat": flat_topology,
    "two_zone": two_zone_topology,
    "edge_wan": edge_wan_topology,
}


def available_topologies() -> List[str]:
    return sorted(TOPOLOGY_PRESETS)


def topology_entries() -> List[Dict[str, str]]:
    """One row per preset: name + docstring summary (CLI --list-topologies
    and the docs table read this)."""
    rows = []
    for name in available_topologies():
        doc = (TOPOLOGY_PRESETS[name].__doc__ or "").strip()
        rows.append({"name": name,
                     "summary": " ".join(line.strip()
                                         for line in doc.splitlines())})
    return rows


def make_topology(topology: Any, node_names: Iterable[str],
                  registry_bw_Bps: float) -> NetworkTopology:
    """Resolve a topology argument: None -> flat (legacy behaviour), a
    preset name, a ready ``NetworkTopology``, or a factory called as
    ``factory(node_names, registry_bw_Bps)``."""
    if topology is None:
        topology = "flat"
    if isinstance(topology, NetworkTopology):
        return topology
    if isinstance(topology, str):
        try:
            factory = TOPOLOGY_PRESETS[topology]
        except KeyError:
            raise ValueError(
                f"unknown topology preset {topology!r}; "
                f"available: {available_topologies()}") from None
        return factory(node_names, registry_bw_Bps=registry_bw_Bps)
    if callable(topology):
        return topology(node_names, registry_bw_Bps)
    raise TypeError(f"cannot build a topology from {topology!r}")
