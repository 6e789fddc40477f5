"""Predictive rebalancing controller: migrate *before* the failure.

Every migration subsystem so far is reactive — an operator (or a test)
decides when to drain a node, and the fault injector decides when to kill
one.  This module closes the loop: a :class:`RebalanceController` runs as
a sim process, watches three cheap cluster-health signals each control
tick, and proactively drains the pods most at risk *ahead* of the
predicted failure or hotspot:

  * **heartbeat jitter** — a node whose heartbeat generation counter
    advanced since the last tick flapped (died and revived under the
    deadline-driven monitor in ``cluster.start_heartbeats``); flapping
    nodes are marked *suspect* for a window, on the operational prior
    that a node that just flapped is likely to flap again;
  * **link saturation** — a node whose registry link would need more
    than ``link_hot_drain_s`` seconds to drain its in-flight bytes
    (``Link.queued_bytes / capacity_Bps``) is a congestion hotspot;
  * **queue growth** — per-pod backlog slope over a short history ring
    of ``APIServer.fleet_state()`` snapshots (one vectorized scan per
    tick — no per-message observers, so the fluid execution regime is
    untouched).

Each flagged pod gets a cost/benefit score (pure functions, unit-testable
without a cluster):

  benefit  messages at risk if the pod's node fails now: current backlog
           plus arrivals over the catch-up exposure window, with the
           drain time from ``cutoff.expected_catchup_time`` (infinite at
           saturation — exactly the paper's high-λ failure mode — capped
           at ``horizon_s``);
  cost     estimated wire bytes times zone distance, reusing the two
           distance legs of the topology-aware placement score
           (registry→target plus source→target);
  score    risk-weighted benefit per byte moved.

Moves above ``min_score`` execute through the existing
``ClusterMigrationOrchestrator`` — per-spec rollback, retry and
placement included — and every decision is emitted as a structured
``MigrationEvent`` (also fanned out through ``api.notify_migration`` so
fault-phase triggers and probes can observe the controller).

The controller is **disabled by default** everywhere: nothing constructs
one unless a harness or CLI flag asks for it, so every existing
experiment timeline is bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Generator, List, Optional, Set

from repro_torch.cluster.cluster import APIServer, Node, Pod
from repro_torch.cluster.sim import Condition

# ---------------------------------------------------------------------------
# Pure decision math (the unit-testable core)
# ---------------------------------------------------------------------------


def predicted_messages_at_risk(lam: float, mu: float, backlog: float,
                               horizon_s: float) -> float:
    """Messages stranded if the pod's node failed right now: the backlog
    already queued plus the arrivals that land during the catch-up
    exposure window.  The window is ``expected_catchup_time`` (drain time
    of the backlog at μ-λ), capped at ``horizon_s``; at or beyond
    saturation the drain never converges, so the full horizon is exposed
    — saturated pods rank highest, which is exactly the regime the paper
    reports original MS2M degrading in."""
    from repro_torch.core.cutoff import expected_catchup_time

    catchup = expected_catchup_time(lam, mu, backlog)
    exposure = horizon_s if math.isinf(catchup) else min(catchup, horizon_s)
    return backlog + max(lam, 0.0) * exposure


def move_cost_bytes(state_bytes: float, registry_dist: int,
                    source_dist: int) -> float:
    """Wire-byte cost of relocating a pod: state size scaled by the same
    two zone-distance legs the topology-aware placement score charges
    (registry→target pull plus source→target affinity), plus the baseline
    intra-zone transfer itself (the ``1 +``)."""
    return max(1.0, float(state_bytes) * (1.0 + registry_dist + source_dist))


def move_score(risk: float, messages_at_risk: float,
               cost_bytes: float) -> float:
    """Risk-weighted messages-at-risk averted per byte moved — the
    controller's ranking key and its admission threshold
    (``RebalanceConfig.min_score``)."""
    return risk * messages_at_risk / max(cost_bytes, 1.0)


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Knobs of the predictive rebalancer (see docs/rebalancing.md)."""

    tick_s: float = 1.0            # control-loop period (virtual s)
    horizon_s: float = 30.0        # exposure cap for messages-at-risk
    suspect_s: float = 90.0        # how long a flapped node stays suspect
    cooldown_s: float = 30.0       # per-queue quiet period after a move
    max_moves_per_tick: int = 2    # new migrations admitted per tick
    max_inflight: int = 4          # total migrations in flight at once
    growth_window_ticks: int = 5   # history ring for the backlog slope
    growth_min_rate: float = 0.5   # sustained backlog growth (msgs/s) flag
    link_hot_drain_s: float = 5.0  # registry-link drain seconds flag
    lam_halflife_s: float = 10.0   # EWMA half-life of the per-pod λ̂
    flap_risk: float = 1.0         # risk weight: node flapped recently
    link_risk: float = 0.5         # risk weight: registry link saturated
    growth_risk: float = 0.3       # risk weight: backlog growing
    min_risk: float = 0.25         # ignore pods below this combined risk
    min_score: float = 1e-9        # messages-at-risk per byte admission bar
    strategy: str = "ms2m_individual"  # migration strategy for drains


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class RebalanceController:
    """Continuous rebalancing loop over one cluster.

    ``start()`` launches the tick process; ``stop()`` halts admissions;
    ``quiesce()`` (a generator — run it as a process or ``yield from``
    it) additionally waits for every in-flight fleet to land, so a
    harness can settle the cluster before verification.

    Wire ``on_node_dead`` into ``api.start_heartbeats`` (possibly chained
    with the workload's own callback) so confirmed deaths reach the
    controller at detection time rather than at the next tick.
    """

    def __init__(self, api: APIServer, orchestrator,
                 config: Optional[RebalanceConfig] = None):
        from repro_torch.core.orchestrator import ClusterMigrationOrchestrator
        assert isinstance(orchestrator, ClusterMigrationOrchestrator)
        self.api = api
        self.sim = api.sim
        self.orch = orchestrator
        self.config = config or RebalanceConfig()
        self.events: List[Any] = []          # MigrationEvent trace
        self.moves: List[Any] = []           # landed FleetReports
        self.n_ticks = 0
        self.n_moves_launched = 0
        self._stopped = False
        self._proc: Optional[Condition] = None
        # signal state
        self._node_gen: Dict[str, int] = {}
        self._suspect_until: Dict[str, float] = {}
        self._dead: Set[str] = set()
        self._lam: Dict[str, float] = {}             # per-queue λ̂ (EWMA)
        self._prev: Dict[str, tuple] = {}            # queue -> (t, published)
        self._depth_hist: Dict[str, List[tuple]] = {}  # queue -> [(t, depth)]
        self._cooldown_until: Dict[str, float] = {}  # queue -> t
        self._moving: Set[str] = set()               # queues in flight
        self._fleets: List[tuple] = []               # (cond, [queues])

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> Condition:
        if self._proc is None:
            self._proc = self.sim.process(self._loop(),
                                          name="rebalance-controller")
        return self._proc

    def stop(self) -> None:
        self._stopped = True

    def quiesce(self) -> Generator:
        """Stop admissions and wait for every in-flight fleet to land."""
        self.stop()
        while self._fleets:
            cond, _ = self._fleets[0]
            yield cond
            self._harvest()

    # -- signal intake ------------------------------------------------------
    def on_node_dead(self, name: str) -> None:
        """Heartbeat-monitor callback: a node's death was confirmed."""
        self._dead.add(name)
        self._emit("rebalance_node_dead", node=name)

    # -- event plumbing -----------------------------------------------------
    def _emit(self, kind: str, **data: Any) -> None:
        from repro_torch.core.policy import MigrationEvent

        now = self.sim.now
        self.events.append(MigrationEvent(t=now, kind=kind, data=dict(data)))
        self.api.notify_migration(kind, now, dict(data))

    def event_rows(self) -> List[Dict[str, Any]]:
        return [e.row() for e in self.events]

    @property
    def moved_wire_bytes(self) -> int:
        return sum(f.wire_bytes_total for f in self.moves)

    @property
    def n_moved(self) -> int:
        return sum(f.n_migrated for f in self.moves)

    @property
    def n_failed_moves(self) -> int:
        return sum(f.n_failed for f in self.moves)

    # -- main loop ----------------------------------------------------------
    def _loop(self) -> Generator:
        while not self._stopped:
            yield self.config.tick_s
            if self._stopped:
                return
            self.n_ticks += 1
            self._tick()

    def _harvest(self) -> None:
        """Collect landed fleets: record reports, release queues into
        cooldown, surface failures as events."""
        still = []
        for cond, queues in self._fleets:
            if not cond.triggered:
                still.append((cond, queues))
                continue
            fleet = cond.value
            self.moves.append(fleet)
            until = self.sim.now + self.config.cooldown_s
            for q in queues:
                self._moving.discard(q)
                self._cooldown_until[q] = until
            self._emit("rebalance_fleet_done",
                       n_migrated=fleet.n_migrated, n_failed=fleet.n_failed,
                       wire_bytes=fleet.wire_bytes_total,
                       queues=list(queues))
            for entry in fleet.failures:
                self._emit("rebalance_move_failed", queue=entry["queue"],
                           error=entry["error"])
        self._fleets = still

    def _scan_nodes(self) -> None:
        """Flap detection: a heartbeat-generation bump since the last tick
        means the node died and revived under the monitor — mark it
        suspect for ``suspect_s``."""
        now = self.sim.now
        for name, node in self.api.nodes.items():
            gen = node._hb_gen
            prev = self._node_gen.get(name)
            if prev is not None and gen > prev:
                self._suspect_until[name] = now + self.config.suspect_s
                self._dead.discard(name)
                self._emit("rebalance_suspect", node=name,
                           until=round(self._suspect_until[name], 6))
            self._node_gen[name] = gen

    def _suspect(self, name: str) -> bool:
        return self._suspect_until.get(name, -math.inf) > self.sim.now

    def _link_drain_s(self, node_name: str) -> float:
        link = self.api.topology.registry_link(node_name)
        return link.queued_bytes / link.capacity_Bps

    def _tick(self) -> None:
        cfg = self.config
        now = self.sim.now
        self._harvest()
        self._scan_nodes()

        state = self.api.fleet_state()  # one vectorized scan per tick
        depths = state["queue_depth"]
        pubs = state["total_published"]

        # per-queue λ̂: published-count deltas per tick, EWMA-smoothed
        # (windowed recent rate — not the lifetime average; satellite #1's
        # bug class must not be rebuilt here)
        candidates: List[tuple] = []
        for i, queue in enumerate(state["queue"]):
            prev = self._prev.get(queue)
            self._prev[queue] = (now, int(pubs[i]))
            hist = self._depth_hist.setdefault(queue, [])
            hist.append((now, int(depths[i])))
            if len(hist) > cfg.growth_window_ticks:
                del hist[0]
            if prev is not None and now > prev[0]:
                inst = (int(pubs[i]) - prev[1]) / (now - prev[0])
                lam = self._lam.get(queue)
                if lam is None:
                    self._lam[queue] = inst
                else:
                    alpha = 1.0 - 0.5 ** ((now - prev[0])
                                          / cfg.lam_halflife_s)
                    self._lam[queue] = lam + alpha * (inst - lam)

        # risk assessment + scoring, one pass over the pods
        inflight = len(self._moving)
        topo = self.api.topology
        drain_cache: Dict[str, float] = {}
        for i, pod_name in enumerate(state["pods"]):
            pod = self.api.pods.get(pod_name)
            if pod is None or pod.deleted or not pod.serving:
                continue
            if not pod.node.alive:
                continue  # nothing can move off a dead node; wait for revive
            if pod.queue._primary_ref is not None:
                continue  # migration-internal target draining a mirror
            if pod.queue._mirror_sinks:
                continue  # source already mid-migration (someone's fleet)
            queue = state["queue"][i]
            if queue in self._moving:
                continue
            if self._cooldown_until.get(queue, -math.inf) > now:
                continue

            risk = 0.0
            reasons = []
            if self._suspect(pod.node.name):
                risk += cfg.flap_risk
                reasons.append("node_flap")
            node_drain = drain_cache.get(pod.node.name)
            if node_drain is None:
                node_drain = self._link_drain_s(pod.node.name)
                drain_cache[pod.node.name] = node_drain
            if node_drain > cfg.link_hot_drain_s:
                risk += cfg.link_risk
                reasons.append("link_saturated")
            # growth needs a full ring: a part-filled history (first ticks
            # after boot, or right after a move reset) is startup noise
            hist = self._depth_hist.get(queue, [])
            if (len(hist) >= cfg.growth_window_ticks
                    and hist[-1][0] > hist[0][0]):
                growth = ((hist[-1][1] - hist[0][1])
                          / (hist[-1][0] - hist[0][0]))
                if growth > cfg.growth_min_rate:
                    risk += cfg.growth_risk
                    reasons.append("queue_growth")
            risk = min(1.0, risk)
            if risk < cfg.min_risk:
                continue

            lam = self._lam.get(queue, 0.0)
            mu = 1000.0 / pod.processing_ms
            mar = predicted_messages_at_risk(lam, mu, float(depths[i]),
                                             cfg.horizon_s)
            target = self._pick_target(pod)
            if target is None:
                continue  # nowhere trustworthy to go
            from repro_torch.core.strategy import worker_state_nbytes
            state_bytes = max(1, worker_state_nbytes(pod.worker))
            tgt_zone = topo.zone(target)
            cost = move_cost_bytes(
                state_bytes,
                topo.zone_distance(topo.registry_zone, tgt_zone),
                topo.zone_distance(topo.zone(pod.node.name), tgt_zone))
            score = move_score(risk, mar, cost)
            if score < cfg.min_score:
                self._emit("rebalance_skip", queue=queue, pod=pod_name,
                           score=score, risk=risk, reasons=reasons)
                continue
            candidates.append((score, queue, pod, target, risk, mar,
                               cost, reasons))

        if not candidates:
            return
        # deterministic admission: best score first, queue name tiebreak
        candidates.sort(key=lambda c: (-c[0], c[1]))
        budget = min(cfg.max_moves_per_tick,
                     max(0, cfg.max_inflight - inflight))
        if budget <= 0:
            return
        self._launch(candidates[:budget])

    def _pick_target(self, pod: Pod) -> Optional[str]:
        """Placement over the *trusted* nodes: alive, not the source, not
        suspect, not confirmed dead.  Reuses the orchestrator's placement
        policy so controller moves and operator drains score targets
        identically."""
        nodes = [n for n in self.api.nodes.values()
                 if n.alive and n.name != pod.node.name
                 and n.name not in self._dead
                 and not self._suspect(n.name)]
        if not nodes:
            return None
        return self.orch.placement(pod, nodes)

    def _launch(self, chosen: List[tuple]) -> None:
        from repro_torch.core.orchestrator import PodMigrationSpec

        specs = []
        queues = []
        for score, queue, pod, target, risk, mar, cost, reasons in chosen:
            identity = self.orch.identity_of(pod)
            specs.append(PodMigrationSpec(
                pod=pod, queue=queue, target_node=target,
                strategy=("ms2m_statefulset" if identity
                          else self.config.strategy),
                identity=identity))
            queues.append(queue)
            self._moving.add(queue)
            self.n_moves_launched += 1
            self._emit("rebalance_move", queue=queue, pod=pod.name,
                       source=pod.node.name, target=target,
                       score=score, risk=risk,
                       messages_at_risk=round(mar, 3),
                       cost_bytes=round(cost, 1), reasons=reasons)
        cond = self.orch.migrate_fleet(
            specs, max_concurrent=self.config.max_moves_per_tick)
        self._fleets.append((cond, queues))


# ---------------------------------------------------------------------------
# Scenario harness: controller-on vs reactive baseline, same seed
# ---------------------------------------------------------------------------

def nimble_timings(**overrides) -> Any:
    """Infra timings for rebalancing scenarios: a fast CRIU/registry path
    (container-native checkpointing on warm caches) where one pod move
    lands in a few virtual seconds — the regime where acting on a flap
    *before* the next one is physically possible.  The paper-fitted
    defaults (~49 s per stop-and-copy) would make every proactive story
    a foregone loss; benchmarks state which timing set they use."""
    from repro_torch.cluster.cluster import TimingConstants

    base = dict(checkpoint_s=1.0, image_build_s=1.0, delta_build_s=0.4,
                push_base_s=0.8, pull_base_s=0.7, restore_s=1.5,
                pod_create_s=0.5, pod_delete_s=0.3,
                sts_identity_release_s=1.0, route_switch_s=0.2,
                cutover_coord_s=0.1)
    base.update(overrides)
    return TimingConstants(**base)


@dataclasses.dataclass
class RebalanceResult:
    """One scenario run (a single (schedule, faults, controller?) cell)."""

    schedule: str
    controller: bool
    seed: int
    n_pods: int
    num_nodes: int
    t_end: float
    # exposure metrics (sampled every sample_dt of virtual time)
    unserved_queue_seconds: float = 0.0   # queue-seconds with no live consumer
    backlog_integral_msg_s: float = 0.0   # ∫ total backlog dt (msgs-at-risk)
    peak_backlog: int = 0
    # throughput/verification
    published_total: int = 0
    processed_total: int = 0
    verified: List[bool] = dataclasses.field(default_factory=list)
    # controller activity
    n_moves: int = 0
    n_failed_moves: int = 0
    moved_wire_bytes: int = 0
    n_detections: int = 0
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def all_verified(self) -> bool:
        return bool(self.verified) and all(self.verified)

    def row(self) -> Dict[str, Any]:
        return {
            "schedule": self.schedule, "controller": self.controller,
            "seed": self.seed, "n_pods": self.n_pods,
            "num_nodes": self.num_nodes, "t_end": self.t_end,
            "unserved_queue_seconds": round(self.unserved_queue_seconds, 6),
            "backlog_integral_msg_s": round(self.backlog_integral_msg_s, 6),
            "peak_backlog": int(self.peak_backlog),
            "published_total": self.published_total,
            "processed_total": self.processed_total,
            "all_verified": self.all_verified,
            "n_moves": self.n_moves,
            "n_failed_moves": self.n_failed_moves,
            "moved_wire_bytes": int(self.moved_wire_bytes),
            "n_detections": self.n_detections,
        }


def run_rebalance_scenario(
    *,
    registry_root: str,
    n_pods: int = 6,
    num_nodes: int = 4,
    message_rate: float = 6.0,
    schedule: str = "steady",
    schedule_kwargs: Optional[Dict[str, Any]] = None,
    faults: Any = None,
    seed: int = 0,
    t_end: float = 150.0,
    controller: Optional[RebalanceConfig] = None,
    worker_factory: Optional[Callable[[], Any]] = None,
    processing_ms: float = 50.0,
    timings: Any = None,
    topology: Any = None,
    placement: Any = None,
    policy: Any = None,
    sanitize: Optional[bool] = None,
    tiebreak_seed: Optional[int] = None,
    fluid: Optional[bool] = None,
    sample_dt: float = 2.0,
    drain_timeout_s: float = 240.0,
    verify: bool = True,
) -> RebalanceResult:
    """Drive one rebalancing scenario and measure service exposure.

    N queues x N seeded producers (``schedule`` selects the arrival
    modulation — see ``core.workload.make_arrival_gaps``) x N consumer
    pods spread over every node; ``faults`` injects the failure story.
    With ``controller=None`` the cluster is purely reactive (pods stall
    through partitions and catch up after — the baseline); with a
    ``RebalanceConfig`` the predictive controller runs and may drain pods
    ahead of predicted failures.  Identical seeds produce identical
    arrival sequences in both cells, so the exposure deltas are the
    controller's doing alone.

    Ends with source halt, full drain, and per-queue verification against
    an independent reference fold of each queue's published log."""
    import numpy as np
    from repro_torch.cluster.cluster import Cluster
    from repro_torch.core.orchestrator import ClusterMigrationOrchestrator
    from repro_torch.core.policy import MigrationPolicy
    from repro_torch.core.workload import (HashConsumer, make_arrival_gaps,
                                     reference_fold)

    timings = timings if timings is not None else nimble_timings()
    timings = dataclasses.replace(timings, processing_ms=processing_ms)
    cluster = Cluster(registry_root, timings=timings, num_nodes=num_nodes,
                      topology=topology, faults=faults, sanitize=sanitize,
                      tiebreak_seed=tiebreak_seed, fluid=fluid)
    sim, api, broker = cluster.sim, cluster.api, cluster.broker
    make_worker = worker_factory or (lambda: HashConsumer())

    published: List[List[int]] = [[] for _ in range(n_pods)]
    stop_producing = {"flag": False}
    qnames = [f"orders-{i}" for i in range(n_pods)]

    for i in range(n_pods):
        queue = broker.declare_queue(qnames[i])

        def make_draw(i=i):
            rng = np.random.default_rng(seed * 1009 + i)
            gaps = make_arrival_gaps(schedule, rng, message_rate,
                                     **(schedule_kwargs or {}))

            def draw():
                if stop_producing["flag"]:
                    return None
                gap = next(gaps)
                return gap, {"token": int(rng.integers(0, 2048))}

            return draw

        def on_publish(msg, i=i):
            published[i].append(msg.payload["token"])

        queue.attach_source(make_draw(), on_publish=on_publish)

        def boot(i=i):
            pod = yield from api.create_pod(
                f"consumer-{i}", f"node{i % num_nodes}", make_worker(),
                broker.queues[qnames[i]])
            pod.start()

        sim.process(boot(), name=f"boot-{i}")

    orch = ClusterMigrationOrchestrator(
        api, make_worker,
        policy=policy or MigrationPolicy(max_attempts=3,
                                         retry_backoff_s=1.0),
        placement=placement)

    ctrl: Optional[RebalanceController] = None
    if controller is not None:
        ctrl = RebalanceController(api, orch, controller)
        ctrl.start()

    detections: List[tuple] = []

    def on_dead(name: str) -> None:
        detections.append((sim.now, name))
        if ctrl is not None:
            ctrl.on_node_dead(name)

    api.start_heartbeats(on_dead)

    result = RebalanceResult(schedule=schedule,
                             controller=controller is not None,
                             seed=seed, n_pods=n_pods, num_nodes=num_nodes,
                             t_end=t_end)
    sampling = {"on": True}

    def queue_depths() -> int:
        total = 0
        now = sim.now
        for q in qnames:
            mq = broker.queues[q]
            mq.sync(now)
            total += mq.depth()
        return total

    def sampler() -> Generator:
        while sampling["on"]:
            yield sample_dt
            if not sampling["on"]:
                return
            state = api.fleet_state()
            live: Dict[str, bool] = {}
            for j, q in enumerate(state["queue"]):
                pod = api.pods.get(state["pods"][j])
                ok = bool(pod is not None and not pod.deleted
                          and pod.node.alive and pod.serving)
                live[q] = live.get(q, False) or ok
            unserved = sum(1 for q in qnames if not live.get(q, False))
            depth = queue_depths()
            result.unserved_queue_seconds += unserved * sample_dt
            result.backlog_integral_msg_s += depth * sample_dt
            result.peak_backlog = max(result.peak_backlog, depth)

    sim.process(sampler(), name="rebalance-sampler")
    sim.run(until=t_end)

    # settle: no new admissions, land in-flight moves, stop traffic, drain
    if ctrl is not None:
        done = sim.process(ctrl.quiesce(), name="rebalance-quiesce")
        sim.run(stop_when=done)
    sampling["on"] = False
    stop_producing["flag"] = True
    for q in qnames:
        broker.queues[q].halt_source()
    deadline = sim.now + drain_timeout_s
    while sim.now < deadline:
        sim.run(until=sim.now + 2.0)
        if queue_depths() == 0:
            break
    for q in qnames:
        broker.queues[q].sync(sim.now)

    # -- final consumer per queue + verification -----------------------------
    consumers: Dict[str, Pod] = {}
    for pod in api.pods.values():
        if not pod.deleted and pod.queue.name in set(qnames):
            prev = consumers.get(pod.queue.name)
            if prev is None or (pod.serving and not prev.serving):
                consumers[pod.queue.name] = pod

    result.published_total = sum(len(p) for p in published)
    for i, q in enumerate(qnames):
        pod = consumers.get(q)
        if pod is None or not pod.node.alive:
            result.verified.append(False)
            continue
        result.processed_total += getattr(pod.worker, "n_processed", 0)
        if verify:
            ref = reference_fold(make_worker, published[i],
                                 pod.worker.last_msg_id)
            result.verified.append(bool(ref.state_equal(pod.worker)))
        else:
            result.verified.append(True)

    result.n_detections = len(detections)
    if ctrl is not None:
        result.n_moves = ctrl.n_moved
        result.n_failed_moves = ctrl.n_failed_moves
        result.moved_wire_bytes = ctrl.moved_wire_bytes
        result.events = ctrl.event_rows()
    return result
