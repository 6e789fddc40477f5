"""Cluster-scale migration orchestration (beyond paper §III: the paper
migrates one pod at a time; real StatefulSets migrate many replicas).

The ``ClusterMigrationOrchestrator`` drives N migrations through the same
strategy registry the MigrationManager uses, three ways:

  * ``migrate_fleet``        — parallel individual-pod migrations with a
                               configurable concurrency limit (a semaphore
                               over migration processes: excess specs queue
                               and start as slots free up);
  * ``rolling_statefulset``  — one replica at a time with sticky-identity
                               handoff (ms2m_statefulset per replica), the
                               Kubernetes rolling-update discipline;
  * ``drain_node``           — evacuate every pod off a node (maintenance /
                               pre-failure drain), auto-detecting
                               StatefulSet identities and spreading targets
                               over the remaining alive nodes.

Every migration runs inside a guard process, so one failing spec (e.g. a
target node that died mid-fleet) is recorded in ``FleetReport.failures``
instead of aborting the whole fleet.  Per-pod ``MigrationReport``s are
aggregated into a ``FleetReport``; the per-queue MigrationManagers are
cached so repeated migrations of the same lineage reuse one manager (which
is exactly the scenario that used to leak ``on_processed`` callbacks — see
migration.py).  Migration behaviour is configured with one declarative
``MigrationPolicy`` (fleet-wide on the orchestrator, overridable per spec);
the legacy ``manager_kwargs`` dict is still accepted and folded in.

``run_fleet_experiment`` is the workload harness: N queues x N Poisson
producers x N consumer pods, orchestrated migration, then per-pod
verification against an independent reference fold (sets
``MigrationReport.state_verified``).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import numpy as np

from repro_torch.cluster.cluster import APIServer, Cluster, Node, Pod, TimingConstants
from repro_torch.cluster.sim import Condition, Interrupt
from repro_torch.core.cutoff import CutoffController
from repro_torch.core.migration import MigrationManager, MigrationReport
from repro_torch.core.policy import MigrationPolicy
from repro_torch.core.strategy import (MigrationError, get_strategy,
                                 worker_state_nbytes)


@dataclasses.dataclass
class PodMigrationSpec:
    """One pod to move: where from is implied by the pod, where to is not.

    ``target_node=None`` defers target selection to the orchestrator's
    placement policy, resolved when the spec actually starts (so the score
    sees the link load of the migrations already in flight)."""
    pod: Pod
    queue: str                       # the pod's primary queue name
    target_node: Optional[str] = None
    strategy: str = "ms2m_individual"
    identity: Optional[str] = None   # StatefulSet identity to hand off
    policy: Optional[MigrationPolicy] = None  # overrides the fleet policy


# ---------------------------------------------------------------------------
# Placement policies (target-node selection)
# ---------------------------------------------------------------------------

def make_round_robin_placement(api: APIServer,
                               inflight: Dict[str, int]) -> Callable[
        [Pod, List[Node]], str]:
    """The legacy default: blind rotation over the candidate nodes."""
    rr = itertools.count()

    def pick(pod: Pod, candidates: List[Node]) -> str:
        return candidates[next(rr) % len(candidates)].name

    return pick


def make_topology_aware_placement(api: APIServer,
                                  inflight: Dict[str, int]) -> Callable[
        [Pod, List[Node]], str]:
    """Score candidates by (zone distance x estimated wire bytes, current
    registry-link load), cheapest first.

    The distance term counts both legs the migration's bytes ride — the
    pull from the registry to the candidate and the affinity to the
    source's zone — times the pod's state size (the wire-byte estimate).
    Ties break lexicographically on the candidate's registry-link load —
    bytes still in flight first, then active flows (distinct units:
    summing them would let one in-flight byte outweigh a whole flow) —
    then occupancy (pods already there plus ``inflight`` migrations
    targeting it), then name (deterministic)."""
    topo = api.topology

    def pick(pod: Pod, candidates: List[Node]) -> str:
        src_zone = topo.zone(pod.node.name)
        dist = {}
        for node in candidates:
            zone = topo.zone(node.name)
            dist[node.name] = (topo.zone_distance(topo.registry_zone, zone)
                               + topo.zone_distance(src_zone, zone))
        # the byte estimate scales the distance term; when every candidate
        # is equidistant it cannot change the argmin, so skip measuring
        # the state entirely
        est_bytes = (max(1, worker_state_nbytes(pod.worker))
                     if len(set(dist.values())) > 1 else 1)

        def score(node: Node):
            link = topo.registry_link(node.name)
            return (dist[node.name] * est_bytes,
                    link.queued_bytes, link.n_flows,
                    len(node.pods) + inflight.get(node.name, 0), node.name)

        return min(candidates, key=score).name

    return pick


PLACEMENT_POLICIES: Dict[str, Callable[[APIServer, Dict[str, int]],
                                       Callable]] = {
    "round_robin": make_round_robin_placement,
    "topology": make_topology_aware_placement,
}


def available_placements() -> List[str]:
    return sorted(PLACEMENT_POLICIES)


def resolve_placement(placement: Union[str, Callable, None],
                      api: APIServer,
                      inflight: Optional[Dict[str, int]] = None
                      ) -> Callable[[Pod, List[Node]], str]:
    """None -> the topology-aware default; a name -> the registered
    factory (called with the api and the orchestrator's in-flight target
    counts); a callable -> used as-is (``pick(pod, candidates) -> str``)."""
    if placement is None:
        placement = "topology"
    if callable(placement):
        return placement
    try:
        factory = PLACEMENT_POLICIES[placement]
    except KeyError:
        raise ValueError(
            f"unknown placement policy {placement!r}; "
            f"available: {available_placements()}") from None
    return factory(api, inflight if inflight is not None else {})


@dataclasses.dataclass
class FleetReport:
    """Aggregate of N per-pod MigrationReports."""
    t_start: float
    t_end: float = 0.0
    reports: List[MigrationReport] = dataclasses.field(default_factory=list)
    targets: List[Pod] = dataclasses.field(default_factory=list)
    peak_concurrency: int = 0
    # specs whose migration raised (error isolated, fleet kept going)
    failures: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # per-link byte/flow telemetry of the topology the fleet ran over
    network: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_migrated(self) -> int:
        return len(self.reports)

    @property
    def n_failed(self) -> int:
        return len(self.failures)

    @property
    def span(self) -> float:
        """Wall-clock (virtual) time from first start to last completion."""
        return self.t_end - self.t_start

    @property
    def max_downtime(self) -> float:
        return max((r.downtime for r in self.reports), default=0.0)

    @property
    def total_downtime(self) -> float:
        return sum(r.downtime for r in self.reports)

    @property
    def raw_bytes_total(self) -> int:
        """Dirty bytes a codec-less transfer would have moved, fleet-wide."""
        return sum(r.image_raw_bytes for r in self.reports)

    @property
    def wire_bytes_total(self) -> int:
        """Encoded bytes the delta codecs actually put on the wire."""
        return sum(r.image_wire_bytes for r in self.reports)

    @property
    def wire_reduction(self) -> float:
        wire = self.wire_bytes_total
        return self.raw_bytes_total / wire if wire > 0 else 1.0

    @property
    def attempts(self) -> int:
        """Migration attempts fleet-wide, successes and failures included
        (== n_migrated + n_failed when no retries happened)."""
        return (sum(r.attempts for r in self.reports)
                + sum(f.get("attempts", 1) for f in self.failures))

    @property
    def n_recovered(self) -> int:
        """Migrations that completed only after >= 1 rolled-back attempt."""
        return sum(1 for r in self.reports if r.attempts > 1)

    @property
    def all_verified(self) -> Optional[bool]:
        """True/False once every report has been verified; None while any
        report is unverified (or the fleet is empty) — 'not checked' must
        not read as either success or state divergence."""
        if not self.reports or any(r.state_verified is None
                                   for r in self.reports):
            return None
        return all(r.state_verified for r in self.reports)

    def downtime_by_strategy(self) -> Dict[str, Dict[str, float]]:
        """Per-strategy downtime breakdown (a fleet can mix strategies —
        e.g. a drain moving sticky replicas via ms2m_statefulset)."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.reports:
            s = out.setdefault(r.strategy,
                               {"n": 0, "max": 0.0, "total": 0.0})
            s["n"] += 1
            s["max"] = max(s["max"], r.downtime)
            s["total"] += r.downtime
        for s in out.values():
            s["mean"] = round(s["total"] / s["n"], 3)
            s["max"] = round(s["max"], 3)
            s["total"] = round(s["total"], 3)
        return out

    def row(self) -> Dict[str, Any]:
        from repro_torch.analysis.stats import summarize_spans

        downtime_pcts = summarize_spans([r.downtime for r in self.reports])
        return {
            "n_migrated": self.n_migrated,
            "n_failed": self.n_failed,
            "span": round(self.span, 3),
            "peak_concurrency": self.peak_concurrency,
            "max_downtime": round(self.max_downtime, 3),
            "downtime_p50": downtime_pcts["p50"],
            "downtime_p99": downtime_pcts["p99"],
            "total_downtime": round(self.total_downtime, 3),
            "raw_bytes_total": self.raw_bytes_total,
            "wire_bytes_total": self.wire_bytes_total,
            "wire_reduction": round(self.wire_reduction, 3),
            "all_verified": self.all_verified,
            "attempts": self.attempts,
            "recovered": self.n_recovered,
            "strategies": sorted({r.strategy for r in self.reports}),
            "downtime_by_strategy": self.downtime_by_strategy(),
            "failures": [dict(f) for f in self.failures],
            "network": dict(self.network),
        }


class ClusterMigrationOrchestrator:
    """Drives N migrations against one APIServer, bounded concurrency."""

    def __init__(self, api: APIServer, make_worker: Callable[[], Any], *,
                 max_concurrent: int = 4,
                 cutoff_factory: Optional[Callable[[], CutoffController]] = None,
                 policy: Optional[MigrationPolicy] = None,
                 placement: Union[str, Callable, None] = None,
                 manager_kwargs: Optional[Dict[str, Any]] = None):
        self.api = api
        self.sim = api.sim
        self.make_worker = make_worker
        self.max_concurrent = max_concurrent
        self.cutoff_factory = cutoff_factory
        # target-node selection for specs that leave target_node=None (and
        # the drain default): "topology" | "round_robin" | a callable.
        # _inflight counts migrations currently targeting each node, so
        # simultaneous placements don't all tie onto one candidate
        self._inflight: Dict[str, int] = {}
        self.placement = resolve_placement(placement, api, self._inflight)
        # legacy shim: manager_kwargs={"precopy": True, ...} folds into the
        # declarative policy
        self.policy = MigrationPolicy.resolve(policy, **(manager_kwargs or {}))
        self._managers: Dict[str, MigrationManager] = {}

    # -- managers (one per primary queue, cached across migrations) ----------
    def manager_for(self, queue: str) -> MigrationManager:
        if queue not in self._managers:
            cutoff = self.cutoff_factory() if self.cutoff_factory else None
            self._managers[queue] = MigrationManager(
                self.api, self.make_worker, queue, cutoff=cutoff,
                policy=self.policy)
        return self._managers[queue]

    def identity_of(self, pod: Pod) -> Optional[str]:
        """Reverse lookup of a pod's StatefulSet identity, if any."""
        for replica, holder in self.api.statefulsets.identities.items():
            if holder == pod.name:
                return replica
        return None

    # -- fleet driver ---------------------------------------------------------
    def migrate_fleet(self, specs: List[PodMigrationSpec],
                      max_concurrent: Optional[int] = None) -> Condition:
        """Run every spec, at most ``max_concurrent`` in flight; completion
        Condition carries the FleetReport."""
        limit = max(1, max_concurrent or self.max_concurrent)
        fleet = FleetReport(t_start=self.sim.now)
        return self.sim.process(self._drive(list(specs), limit, fleet),
                                name=f"fleet:{len(specs)}x{limit}")

    def pick_target(self, pod: Pod, exclude: Optional[set] = None) -> str:
        """Run the placement policy over the alive nodes (excluding the
        pod's own — migrating onto the source node is a no-op — and any
        ``exclude`` entries: targets that already failed this spec)."""
        exclude = exclude or set()
        candidates = [n for n in self.api.nodes.values()
                      if n.alive and n.name != pod.node.name
                      and n.name not in exclude]
        if not candidates and exclude:
            # every fresh candidate is gone: allow excluded-but-alive
            # nodes again (a flapped target that revived beats giving up)
            candidates = [n for n in self.api.nodes.values()
                          if n.alive and n.name != pod.node.name]
        if not candidates:
            raise RuntimeError(
                f"no alive target node to place {pod.name} "
                f"(source {pod.node.name})")
        return self.placement(pod, candidates)

    def _guard(self, spec: PodMigrationSpec) -> Generator:
        """One migration with failure isolation and crash recovery.

        Any exception — spec validation, a dead target node mid-fleet, an
        aborted transfer, a strategy bug — fails this spec only, never
        the fleet.  Failures that went through the rollback path
        (``MigrationError``) are retried up to ``policy.max_attempts``
        times after ``policy.retry_backoff_s``: the spec is re-placed by
        the placement policy with every failed target node excluded, and
        the source handle is refreshed when the rollback re-created the
        pod.  Validation errors never retry (they would fail identically).
        """
        policy = spec.policy or self.policy
        pod = spec.pod
        excluded: set = set()
        attempt = 0
        # "was the workload left rolled back?" — updated by every attempt
        # that actually touched the workload (raised MigrationError after
        # running rollback).  An attempt that failed before reaching the
        # strategy (e.g. no target node left to pick) does not reset it:
        # the source's serving state is whatever the last rollback left.
        rolled_back = False
        while True:
            attempt += 1
            # the failure entry's target describes the TERMINAL attempt —
            # a pick_target failure has no target at all
            target_node = None
            try:
                if pod is None or pod.deleted:
                    raise RuntimeError(
                        f"source pod for queue {spec.queue!r} is gone "
                        "(its node died?): nothing left to migrate")
                if spec.target_node is not None and attempt == 1:
                    target_node = spec.target_node
                else:
                    # placement deferred to start time (or re-placement on
                    # retry): the score sees the link load of the
                    # migrations already in flight, minus failed targets
                    target_node = self.pick_target(pod, exclude=excluded)
                self._inflight[target_node] = (
                    self._inflight.get(target_node, 0) + 1)
                try:
                    mgr = self.manager_for(spec.queue)
                    report, target = yield from mgr.migration(
                        spec.strategy, pod, target_node,
                        statefulset_identity=spec.identity,
                        policy=spec.policy)
                finally:
                    self._inflight[target_node] -= 1
                report.attempts = attempt
                return "ok", report, target
            except Interrupt:
                # kernel control flow is not a migration failure: the
                # interrupter owns recovery — re-raise before the broad
                # isolation handler can eat it [SIM001]
                raise
            except Exception as exc:  # noqa: BLE001 — isolate any failure
                retryable = isinstance(exc, MigrationError)
                if retryable:
                    ctx = exc.context
                    rolled_back = ctx.rolled_back
                    if ctx.restored_source is not None:
                        pod = ctx.restored_source  # rollback re-created it
                if target_node is not None:
                    excluded.add(target_node)
                if not retryable or attempt >= policy.max_attempts:
                    cause = exc.cause if isinstance(exc, MigrationError) \
                        else exc
                    return "failed", {
                        "pod": spec.pod.name if spec.pod else None,
                        "queue": spec.queue,
                        "target_node": target_node,
                        "strategy": spec.strategy,
                        "error": f"{type(cause).__name__}: {cause}",
                        "attempts": attempt,
                        "rolled_back": rolled_back,
                        "source_pod": (pod.name if pod is not None
                                       and not pod.deleted else None),
                    }
                if policy.retry_backoff_s > 0:
                    yield policy.retry_backoff_s

    def _drive(self, specs: List[PodMigrationSpec], limit: int,
               fleet: FleetReport) -> Generator:
        pending = deque(specs)
        active: Dict[Condition, PodMigrationSpec] = {}
        while pending or active:
            while pending and len(active) < limit:
                spec = pending.popleft()
                cond = self.sim.process(
                    self._guard(spec),
                    name=f"migration:{spec.strategy}:{spec.queue}")
                active[cond] = spec
                fleet.peak_concurrency = max(fleet.peak_concurrency,
                                             len(active))
            # snapshot the fan-out in explicit launch order [SIM003]: the
            # wakeup must not be built from a view of a dict that the
            # drain below mutates, and the arm order (-> any_of callback
            # order) must be the deterministic admission order, not
            # whatever a set/hash iteration yields
            armed = list(active.keys())
            yield self.sim.any_of(*armed)
            for cond in [c for c in armed if c.triggered]:
                active.pop(cond)
                status, *payload = cond.value
                if status == "ok":
                    report, target = payload
                    fleet.reports.append(report)
                    fleet.targets.append(target)
                else:
                    fleet.failures.append(payload[0])
        fleet.t_end = self.sim.now
        fleet.network = self.api.topology.stats()
        return fleet

    # -- rolling StatefulSet migration ---------------------------------------
    def rolling_statefulset(self, specs: List[PodMigrationSpec]) -> Condition:
        """One replica at a time (concurrency 1), sticky-identity handoff:
        replica k+1 does not start until replica k's target holds its
        identity — the Kubernetes rolling-update discipline."""
        rolled = [dataclasses.replace(
            spec, strategy="ms2m_statefulset",
            identity=spec.identity or self.identity_of(spec.pod))
            for spec in specs]
        return self.migrate_fleet(rolled, max_concurrent=1)

    # -- node drain -----------------------------------------------------------
    def drain_node(self, node_name: str, *,
                   strategy: str = "ms2m_individual",
                   target_node_for: Optional[Callable[[Pod], str]] = None,
                   max_concurrent: Optional[int] = None) -> Condition:
        """Migrate every pod off ``node_name`` (maintenance drain).  Pods
        holding a StatefulSet identity are moved with ms2m_statefulset
        regardless of ``strategy``; targets default to the orchestrator's
        placement policy (topology-aware unless configured otherwise),
        scored when each spec starts.  ``target_node_for`` pins targets
        explicitly and bypasses the policy."""
        others = [n for n in self.api.nodes.values()
                  if n.alive and n.name != node_name]
        if not others:
            raise RuntimeError(f"no alive node to drain {node_name} onto")

        specs = []
        for pod in list(self.api.nodes[node_name].pods.values()):
            identity = self.identity_of(pod)
            specs.append(PodMigrationSpec(
                pod=pod, queue=pod.queue.name,
                target_node=(target_node_for(pod) if target_node_for
                             else None),
                strategy="ms2m_statefulset" if identity else strategy,
                identity=identity))
        return self.migrate_fleet(specs, max_concurrent=max_concurrent)


# ---------------------------------------------------------------------------
# Fleet workload harness (used by tests, benchmarks and examples)
# ---------------------------------------------------------------------------

def audit_failed_spec(api: APIServer, entry: Dict[str, Any],
                      make_worker: Callable, published: List[int], *,
                      exact: bool = True, verify: bool = True):
    """Record the rollback guarantee on one failure entry, in place: is
    the source pod still serving, on an alive node, and drain-consistent
    (its state equals the reference fold of everything it processed)?
    Shared by the fleet and single-migration harnesses so the invariant
    audit cannot drift between them.  Returns the source pod (or None)."""
    from repro_torch.core.workload import reference_fold

    src = api.pods.get(entry.get("source_pod") or "")
    entry["source_serving"] = bool(src is not None and not src.deleted
                                   and src.node.alive and src.serving)
    entry["source_node_alive"] = bool(src is not None and src.node.alive)
    if src is not None and verify:
        ref = reference_fold(make_worker, published, src.worker.last_msg_id)
        entry["source_verified"] = bool(ref.state_equal(src.worker,
                                                        exact=exact))
    else:
        entry["source_verified"] = False if src is None else None
    return src

def run_fleet_experiment(
    n_pods: int,
    strategy: str,
    message_rate: float,
    *,
    registry_root: str,
    mode: str = "parallel",          # parallel | rolling | drain
    max_concurrent: int = 4,
    processing_ms: float = 50.0,
    t_migrate: float = 10.0,
    settle_time: float = 5.0,
    seed: int = 0,
    num_nodes: int = 4,
    timings: Optional[TimingConstants] = None,
    worker_factory: Optional[Callable] = None,
    chunk_bytes: Optional[int] = None,
    policy: Optional[MigrationPolicy] = None,
    manager_kwargs: Optional[Dict[str, Any]] = None,
    t_replay_max: float = 45.0,
    topology=None,                   # preset name | NetworkTopology | factory
    placement: Union[str, Callable, None] = None,
    auto_targets: bool = False,      # let the placement policy pick targets
    faults=None,                     # FaultSchedule | list of Fault/specs
    allow_failures: bool = False,    # chaos runs: failures are data, not bugs
) -> FleetReport:
    """N queues x N Poisson producers x N consumer pods; orchestrated
    migration per ``mode``; per-pod verification against an independent
    reference fold of each queue's published log (no loss, no duplication,
    no reordering), recorded in ``MigrationReport.state_verified``.

    ``topology`` selects the network model (default: the seed-identical
    ``flat`` preset); ``auto_targets=True`` leaves each spec's target to
    the orchestrator's ``placement`` policy instead of pinning the
    reserved last node.

    ``faults`` injects a deterministic failure schedule
    (``repro_torch.cluster.faults``).  With ``allow_failures=True`` a spec that
    exhausted its retries is data rather than an assertion failure: its
    ``FleetReport.failures`` entry gains ``source_serving`` /
    ``source_node_alive`` / ``source_verified`` fields asserting the
    rollback guarantee — the source pod is still serving and its state
    still equals the reference fold of what it processed."""
    from repro_torch.core.workload import HashConsumer, reference_fold

    if num_nodes < 2:
        raise ValueError(
            f"run_fleet_experiment needs num_nodes >= 2 (got {num_nodes}): "
            "with a single node every source would also be its own "
            "migration target — there is nowhere to migrate to")
    timings = dataclasses.replace(timings or TimingConstants(),
                                  processing_ms=processing_ms)
    cluster = Cluster(registry_root, timings=timings, num_nodes=num_nodes,
                      chunk_bytes=chunk_bytes, topology=topology,
                      faults=faults)
    sim, api, broker = cluster.sim, cluster.api, cluster.broker
    make_worker = worker_factory or (lambda: HashConsumer())
    mu = 1000.0 / processing_ms

    # In drain mode every source sits on node0 (targets round-robin over
    # the remaining nodes); otherwise sources spread over all-but-the-last
    # node and every target lands on the last node, which is reserved —
    # i.e. kept free of sources — so migration direction is deterministic.
    published: List[List[int]] = [[] for _ in range(n_pods)]
    stop_producing = {"flag": False}
    sources: List[Pod] = []
    rolling = mode == "rolling"

    for i in range(n_pods):
        qname = f"orders-{i}"
        queue = broker.declare_queue(qname)

        # per-queue arrival source (legacy draw interleave: gap, then
        # token); fleet pods have no per-message observers, so steady
        # traffic runs as fluid epochs (docs/scaling.md)
        def make_draw(i=i):
            from repro_torch.core.workload import open_loop_gaps
            rng = np.random.default_rng(seed * 1009 + i)
            gaps = open_loop_gaps(rng, message_rate)

            def draw():
                if stop_producing["flag"]:
                    return None
                gap = next(gaps)
                return gap, {"token": int(rng.integers(0, 2048))}

            return draw

        def on_publish(msg, i=i):
            published[i].append(msg.payload["token"])

        queue.attach_source(make_draw(), on_publish=on_publish)
        src_node = "node0" if mode == "drain" else f"node{i % max(1, num_nodes - 1)}"
        identity = f"consumer-{i}" if rolling else None

        def boot(i=i, qname=qname, src_node=src_node, identity=identity):
            pod = yield from api.create_pod(
                f"consumer-{i}", src_node, make_worker(),
                broker.queues[qname], statefulset_identity=identity)
            pod.start()
            sources.append(pod)

        sim.process(boot(), name=f"boot-{i}")

    sim.run(until=t_migrate)
    assert len(sources) == n_pods
    sources.sort(key=lambda p: int(p.name.rsplit("-", 1)[-1]))

    # strategies declare their control-plane needs via the registry — any
    # scheme that wants the Eq. 5 controller (cutoff, adaptive, custom
    # registrations) gets one, with no per-name special cases here
    cutoff_factory = None
    if get_strategy(strategy).wants_cutoff:
        cutoff_factory = lambda: CutoffController(  # noqa: E731
            t_replay_max=t_replay_max, mu_fallback=mu,
            lam_fallback=message_rate)
    orch = ClusterMigrationOrchestrator(
        api, make_worker, max_concurrent=max_concurrent,
        cutoff_factory=cutoff_factory, policy=policy, placement=placement,
        manager_kwargs=manager_kwargs)

    if mode == "drain":
        done = orch.drain_node("node0", strategy=strategy,
                               max_concurrent=max_concurrent)
    else:
        specs = [PodMigrationSpec(
            pod=pod, queue=pod.queue.name,
            target_node=None if auto_targets else f"node{num_nodes - 1}",
            strategy=strategy,
            identity=f"consumer-{i}" if rolling else None)
            for i, pod in enumerate(sources)]
        done = (orch.rolling_statefulset(specs) if rolling
                else orch.migrate_fleet(specs))

    sim.run(stop_when=done)
    fleet: FleetReport = done.value
    if not allow_failures:
        assert not fleet.failures, f"fleet migration failed: {fleet.failures}"

    # settle, stop traffic, let consumers drain their queues
    sim.run(until=sim.now + settle_time)
    stop_producing["flag"] = True
    for i in range(n_pods):
        broker.queues[f"orders-{i}"].halt_source()
    sim.run(until=sim.now + 2.0)
    for i in range(n_pods):  # land lazy arrivals / fold epochs at end-of-run
        broker.queues[f"orders-{i}"].sync(sim.now)

    # -- per-pod verification: reference fold of each queue's log ------------
    by_queue = {t.queue.name: (rep, t)
                for rep, t in zip(fleet.reports, fleet.targets)}
    for i in range(n_pods):
        hit = by_queue.get(f"orders-{i}")
        if hit is None:
            continue  # failed spec: verified below against its source
        rep, target = hit
        ref = reference_fold(make_worker, published[i],
                             target.worker.last_msg_id)
        rep.state_verified = bool(ref.state_equal(target.worker))

    # -- failed specs: the rollback guarantee ---------------------------------
    # an exhausted-retries failure must have left the source pod serving
    # the primary queue with drain-consistent state (its fold of whatever
    # it processed equals the reference fold — no loss, no duplication)
    for entry in fleet.failures:
        i = int(entry["queue"].rsplit("-", 1)[-1])
        audit_failed_spec(api, entry, make_worker, published[i])
    return fleet
