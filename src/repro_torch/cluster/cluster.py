"""Virtual-time Kubernetes-like cluster runtime.

Maps the paper's actors onto simulation objects:
  * ``Node`` — worker machine hosting Pods (kill-able: failure injection);
  * ``Pod``  — one consumer worker + its run-loop process;
  * ``APIServer`` — the control-plane facade the Migration Manager talks
    to: pod lifecycle, FCC checkpointing, image build/push/pull/restore.
    All infra operations are generator sub-processes charging calibrated
    virtual-time constants plus *real* registry byte counts / bandwidth;
  * ``StatefulSetController`` — sticky identity: a named replica's new Pod
    cannot be created until the old one is fully deleted (identity release),
    which is exactly why MS2M-for-StatefulSet must stop-then-replay.
  * heartbeat failure detector + reconciliation (checkpoint/restart FT path).

Calibration: constants default to values fitted to the paper's measured
sub-process distribution (Figs 5-14); benchmarks/constants.py documents the
derivation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generator, List, Optional

from repro_torch.analysis.sanitizer import capture_site
from repro_torch.broker.broker import Broker, MessageQueue
from repro_torch.checkpoint.registry import Registry
from repro_torch.cluster.network import NetworkTopology, flat_topology, make_topology
from repro_torch.cluster.sim import Condition, Sim, TransferAborted


@dataclasses.dataclass
class TimingConstants:
    """Virtual-time costs of infra sub-processes (seconds).

    Fitted so stop-and-copy totals ~49s (paper Fig. 5) with the paper's
    sub-process proportions; transfer terms add real_bytes / bandwidth.
    """

    checkpoint_s: float = 8.0          # FCC/CRIU dump of the pod
    image_build_s: float = 11.0        # buildah OCI image assembly
    delta_build_s: float = 2.5         # incremental layer assembly (pre-copy)
    push_base_s: float = 6.0           # registry round-trips
    pull_base_s: float = 5.0
    registry_bw_Bps: float = 200e6     # artifact registry bandwidth
    # checkpoint data-path compute: wire time is charged on *encoded*
    # bytes, so the codec's own cost must be charged too (raw bytes fed
    # through a delta-codec encoder), as must the device-side fingerprint
    # pass (a streaming reduction, so near memory bandwidth)
    codec_Bps: float = 1.2e9
    fingerprint_Bps: float = 24e9
    restore_s: float = 13.0            # CRIU restore into a fresh container
    pod_create_s: float = 3.0          # scheduling + sandbox start
    pod_delete_s: float = 2.0          # SIGTERM + teardown
    sts_identity_release_s: float = 8.0  # StatefulSet graceful identity release
    route_switch_s: float = 0.9        # consumer rebind / traffic redirect
    cutover_coord_s: float = 0.5       # pause coordination during cutover
    processing_ms: float = 50.0        # per-message service time (paper: 50ms)
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 6.0

    @classmethod
    def from_roofline(cls, roofline, **overrides) -> "TimingConstants":
        """Constants with the data-path throughputs recalibrated from a
        measured codec roofline (``benchmarks/roofline.py --codec`` ->
        ``results/codec_roofline.json``, or its loaded dict).

        The class defaults above stay the paper-fitted constants — every
        regression timeline is pinned to them bit-for-bit — so measured
        throughput is strictly opt-in via this constructor.
        """
        import json

        if isinstance(roofline, str):
            with open(roofline) as f:
                roofline = json.load(f)
        cal = roofline.get("calibration", roofline)
        kw = {}
        if cal.get("codec_Bps"):
            kw["codec_Bps"] = float(cal["codec_Bps"])
        if cal.get("fingerprint_Bps"):
            kw["fingerprint_Bps"] = float(cal["fingerprint_Bps"])
        kw.update(overrides)
        return cls(**kw)


class Node:
    def __init__(self, name: str, sim: Optional[Sim] = None):
        self.name = name
        self.alive = True
        self.pods: Dict[str, "Pod"] = {}
        self.last_heartbeat = 0.0
        # local image-layer cache (chunk keys): prefetched/pulled chunks are
        # free on later pulls — how pre-copy makes the final restore cheap
        self.image_chunks: set = set()
        # triggered when the node dies: in-flight link transfers touching
        # this node wait on it and abort; replaced fresh on revive
        self.down: Optional[Condition] = (Condition(sim, f"{name}:down")
                                          if sim is not None else None)
        # deadline-driven heartbeat bookkeeping: the generation counter
        # invalidates an armed detection deadline when the node revives
        # (and dies again) before it fires
        self._hb_gen = 0
        self._hb_armed_gen = -1


class Pod:
    """A consumer worker plus its service loop.

    Two execution regimes (docs/scaling.md): the per-message generator
    loop below (the seed behaviour, always used when any migration
    machinery is attached), and *fluid epochs* — when the pod is in
    steady state on a source-fed queue, the loop sleeps up to
    ``fluid_epoch_s`` and folds the whole epoch in one event, recomputing
    the service timeline with exact float arithmetic
    (``completion = max(arrival, cursor) + processing_ms/1000``).  Any
    observation point mid-epoch folds up to the current instant first, so
    the observable timeline is bit-identical to the per-message regime.
    """

    # fluid-epoch tuning: how long a steady-state pod may go unobserved
    # before it folds on its own (any observer folds it earlier, exactly)
    fluid_epoch_s = 20.0

    def __init__(self, name: str, node: Node, worker, queue: MessageQueue,
                 sim: Sim, timings: TimingConstants,
                 processing_ms: Optional[float] = None):
        self.name = name
        self.node = node
        self.worker = worker
        self.queue = queue
        self.sim = sim
        self.timings = timings
        self.processing_ms = (timings.processing_ms
                              if processing_ms is None else processing_ms)
        self.serving = False
        self.deleted = False
        self.paused = False
        self.service_log: List[tuple] = []  # (virtual_time, msg_id)
        # 10k-pod memory valve: per-message service history is O(messages);
        # large fleets that never inspect it can turn it off (both regimes
        # honour the flag, so differential comparisons stay fair)
        self.keep_service_log = True
        # single-slot hook (owned by the workload) + removable listeners
        # (owned by migrations, which must deregister on completion)
        self.on_processed: Optional[Callable] = None
        self.on_processed_listeners: List[Callable] = []
        self.in_flight = None  # message popped but not yet folded/requeued
        self._loop_started = False
        self._wake: Optional[Condition] = None
        # active fluid epoch (docs/scaling.md): the service timeline is
        # implicit — recomputed with exact event-loop arithmetic from the
        # queue/source state at fold time, never built as per-message
        # plan entries.  ``_fluid_cursor`` is the completion instant of
        # the last folded service (the chain base for the next one).
        self._fluid_active = False
        self._fluid_cursor = 0.0
        self._fluid_floor = -1
        self._fold_level_for: Optional[tuple] = None
        self._in_fold = False

    @property
    def busy(self) -> bool:
        """True while a popped message is mid-service (in flight)."""
        return self.in_flight is not None

    def add_on_processed(self, fn: Callable):
        # per-message listeners force exact mode: fold the active epoch
        # first so the listener sees every event from this instant on
        self._fluid_sync()
        self.on_processed_listeners.append(fn)
        if self.sim.sanitizer is not None:
            self.sim.sanitizer.check_listener_growth(
                f"pod {self.name!r} on_processed list",
                len(self.on_processed_listeners))

    def remove_on_processed(self, fn: Callable):
        if fn in self.on_processed_listeners:
            self.on_processed_listeners.remove(fn)

    def _notify_processed(self, msg):
        if self.on_processed:
            self.on_processed(self, msg)
        for fn in list(self.on_processed_listeners):
            fn(self, msg)

    # -- service loop ---------------------------------------------------------
    def start(self):
        self.serving = True
        if not self._loop_started:
            self._loop_started = True
            self.sim.process(self._run(), name=f"pod:{self.name}")

    def pause(self):
        self._fluid_sync()
        if self.sim.sanitizer is not None:
            self.sim.sanitizer.on_pause(self)
        self.paused = True
        self.serving = False

    def resume(self):
        self.paused = False
        self.serving = True
        self.wake()  # release a condition-stalled loop

    def stop(self):
        self._fluid_sync()
        self.deleted = True
        self.serving = False
        if self.sim.sanitizer is not None:
            self.sim.sanitizer.unprotect_pod(self)
        self.wake()

    def wake(self):
        """Unblock the loop (e.g. after a queue switch)."""
        if self._wake is not None:
            cond, self._wake = self._wake, None
            cond.trigger()

    # -- fluid epochs (docs/scaling.md) ---------------------------------------
    def _fluid_eligible(self) -> bool:
        """Steady state: a source-fed primary with no migration machinery
        attached and no per-message observers — the only regime where
        service can be planned analytically without changing anything
        observable."""
        q = self.queue
        return (self.sim.fluid_enabled
                and q._source is not None
                and q._primary_ref is None
                and not q._mirror_sinks
                and not q.stalled
                and not self.paused
                and not self.deleted
                and self.node.alive
                and self.on_processed is None
                and not self.on_processed_listeners)

    def _fluid_sync(self) -> None:
        """Fold the active epoch up to the current instant (no-op when
        none is active).  Every migration-relevant hook calls this before
        observing or mutating pod/queue state."""
        if self._fluid_active:
            self._fold_to(self.sim.now)

    def _on_queue_sync(self, now: float) -> None:
        if self._fluid_active:
            self._fold_to(now)

    def _fluid_epoch(self) -> Optional[Condition]:
        """Open up to ``fluid_epoch_s`` of steady-state service and return
        the condition to sleep on (woken by the epoch-end timer or by any
        hook that folds the epoch early).  ``None`` = nothing to cover;
        the caller falls through to the per-message wait path.

        The epoch stores no per-message state and draws no arrivals ahead
        of time: the exact service timeline is computed at fold time by
        drawing-and-consuming the source stream (``_fold_to``).  The wake
        timer is therefore NOT a completion estimate — folding always
        stamps every instant with event-loop arithmetic, so waking at any
        time is exact, and any observer folds the epoch earlier anyway.
        A message mid-service at the fold instant is carried across as a
        crosser, exactly like an observer-interrupted service."""
        q = self.queue
        src = q._source
        if src.closed and not src.pending and not q._items:
            return None  # source exhausted: park on the legacy wait path
        sim = self.sim
        now = sim.now
        self._fluid_cursor = now
        skip_until = getattr(self.worker, "skip_until", -1)
        last_id = self.worker.last_msg_id
        self._fluid_floor = skip_until if skip_until > last_id else last_id
        self._fluid_active = True
        self._wake = wake = sim.condition(f"{self.name}:wake")
        q._consumer_sync = self._on_queue_sync
        sim.call_at(now + self.fluid_epoch_s, self.wake, category="message")
        return wake

    def _fold_level(self) -> int:
        """How aggressively the worker's class lets a fold batch:
        2 = ``process_pairs`` (no Message allocation), 1 =
        ``process_batch`` (Message objects, one call), 0 = per-message
        ``process``.  A batch method may replace the per-message loop only
        when it was written with knowledge of the active ``process``: the
        first class in the MRO defining any of the three decides.  A
        subclass that overrides ``process`` without re-deriving the batch
        paths (extra state per message) falls back to the exact loop."""
        cls = type(self.worker)
        cached = self._fold_level_for
        if cached is not None and cached[0] is cls:
            return cached[1]
        level = 0
        for klass in cls.__mro__:
            d = klass.__dict__
            if "process_pairs" in d:
                level = 2
                break
            if "process_batch" in d:
                level = 1
                break
            if "process" in d:
                break
        self._fold_level_for = (cls, level)
        return level

    def _fold_to(self, t: float) -> None:
        """Consume every service with completion <= ``t``, recomputing the
        timeline with exact event-loop arithmetic (service = float
        ``processing_ms/1000`` added to max(arrival, cursor); already-
        folded ids consume zero time — the dedup guard).  A message
        mid-service at ``t`` becomes an in-flight *crosser* that finishes
        (or requeues, exactly like the legacy post-service interruption
        re-check) at its own completion event.  The epoch then closes —
        the loop wakes and re-opens one from the queue, which still holds
        everything unconsumed."""
        if self._in_fold:
            return
        self._in_fold = True
        try:
            q = self.queue
            src = q._source
            p = self.processing_ms / 1000.0
            cursor = self._fluid_cursor
            floor = self._fluid_floor
            log = self.service_log if self.keep_service_log else None
            level = self._fold_level()
            # allocation-free drain: ids + payloads only, no Message
            # objects — legal only when nothing needs the object
            fast = (level == 2 and src.on_publish is None
                    and not q._mirror_sinks)
            batch: List = []
            crosser = None
            items = q._items
            while items:
                msg = items[0]
                if msg.msg_id <= floor:
                    if cursor > t:
                        break
                    items.popleft()  # dedup skip: zero service time
                    continue
                done = cursor + p
                if done > t:
                    if cursor <= t:
                        items.popleft()
                        crosser = (msg, done)
                    break
                items.popleft()
                floor = msg.msg_id
                batch.append((msg.msg_id, msg.payload) if fast else msg)
                if log is not None:
                    log.append((done, msg.msg_id))
                cursor = done
            if crosser is None:
                pend = src.pending
                next_id = q._next_id
                append = batch.append
                log_append = None if log is None else log.append
                n_fast = 0
                # already-drawn arrivals first: boot backlog and the
                # overshoot draw a previous horizon left in flight
                while pend:
                    at, payload = pend[0]
                    if at > t:
                        break
                    start = at if at > cursor else cursor
                    done = start + p
                    if done > t:
                        pend.popleft()
                        msg = q._materialize(at, payload, enqueue=False)
                        crosser = (msg, done)
                        break
                    pend.popleft()
                    if fast:
                        n_fast += 1
                        append((next(next_id), payload))
                    else:
                        msg = q._materialize(at, payload, enqueue=False)
                        append(msg)
                    if log_append is not None:
                        log_append((done, batch[-1][0] if fast
                                    else batch[-1].msg_id))
                    cursor = done
                if crosser is None and not pend and not src.closed:
                    # fused draw-and-consume: each arrival goes straight
                    # from the source stream into the batch — same draw
                    # order and float arithmetic as ensure_drawn, minus
                    # the deque round-trip.  Exactly one overshoot draw
                    # (the producer's in-flight sleep) stays pending.
                    draw = src.draw
                    head_t = src.head_t
                    while True:
                        item = draw()
                        if item is None:
                            src.closed = True
                            break
                        payload = item[1]
                        head_t = head_t + float(item[0])
                        if head_t > t:
                            pend.append((head_t, payload))
                            break
                        start = head_t if head_t > cursor else cursor
                        done = start + p
                        if done > t:
                            src.head_t = head_t
                            msg = q._materialize(head_t, payload,
                                                 enqueue=False)
                            crosser = (msg, done)
                            break
                        if fast:
                            mid = next(next_id)
                            n_fast += 1
                            append((mid, payload))
                            if log_append is not None:
                                log_append((done, mid))
                        else:
                            src.head_t = head_t
                            msg = q._materialize(head_t, payload,
                                                 enqueue=False)
                            append(msg)
                            if log_append is not None:
                                log_append((done, msg.msg_id))
                        cursor = done
                    src.head_t = head_t
                if n_fast:
                    q.total_published += n_fast
            self._fluid_active = False
            q._consumer_sync = None
            if batch:
                worker = self.worker
                if fast:
                    worker.process_pairs(batch)
                elif level >= 1:
                    worker.process_batch(batch)
                else:
                    for m in batch:
                        worker.process(m)
            if crosser is not None:
                msg, done_t = crosser
                self.in_flight = msg
                self.sim.call_at(
                    done_t,
                    lambda m=msg, d=done_t: self._finish_crosser(m, d),
                    category="message")
            self.wake()
        finally:
            self._in_fold = False

    def _finish_crosser(self, msg, done_t: float) -> None:
        """Exact completion of a message that was mid-service when its
        epoch folded: re-checks the interruption flags at the completion
        instant, mirroring the legacy loop's post-service branch."""
        if self.deleted or self.paused or not self.node.alive:
            self.queue.requeue_front(msg)
            self.in_flight = None
        else:
            self.worker.process(msg)
            self.in_flight = None
            if self.keep_service_log:
                self.service_log.append((self.sim.now, msg.msg_id))
            self._notify_processed(msg)
        self.wake()

    def _run(self) -> Generator:
        while not self.deleted:
            if self._fluid_active:
                self._fold_to(self.sim.now)
            if self.in_flight is not None:
                # a fluid crosser is mid-service: its completion event
                # wakes us (spurious wakes just re-park)
                self._wake = self.sim.condition(f"{self.name}:wake")
                yield self._wake
                continue
            if self.paused or not self.node.alive:
                # condition-based stall, not a busy-poll: a paused pod (e.g.
                # the source of a long migration after the cutoff fired)
                # contributes ZERO sim events until resume()/stop()/node
                # recovery wakes it
                self._wake = self.sim.condition(f"{self.name}:stall")
                yield self._wake
                continue
            if self._fluid_eligible():
                wait = self._fluid_epoch()
                if wait is not None:
                    yield wait
                    continue
            msg = self.queue.try_get()
            if msg is None:
                self._wake = self.sim.condition(f"{self.name}:wake")
                yield self.sim.any_of(self.queue.wait_not_empty(), self._wake)
                continue
            # at-least-once dedup guard: ids are totally ordered, so a
            # message already folded into the state is skipped for free
            skip_until = getattr(self.worker, "skip_until", -1)
            if msg.msg_id <= max(skip_until, self.worker.last_msg_id):
                continue
            self.in_flight = msg
            yield self.processing_ms / 1000.0  # service time (virtual)
            if self.deleted or self.paused or not self.node.alive:
                # interrupted mid-service (pause, delete, or the node went
                # down under us — a soft partition must not fold state
                # while "offline"): message returns to the queue; the
                # id-dedup guard above makes the eventual redelivery
                # exactly-once
                self.queue.requeue_front(msg)
                self.in_flight = None
                continue
            self.worker.process(msg)  # real JAX state update
            self.in_flight = None
            if self.keep_service_log:
                self.service_log.append((self.sim.now, msg.msg_id))
            self._notify_processed(msg)


class StatefulSetController:
    """Sticky identity bookkeeping: replica name -> live pod (at most one)."""

    def __init__(self):
        self.identities: Dict[str, Optional[str]] = {}

    def claim(self, replica: str, pod_name: str):
        if self.identities.get(replica) is not None:
            raise RuntimeError(
                f"StatefulSet identity {replica} still held by "
                f"{self.identities[replica]}")
        self.identities[replica] = pod_name

    def release(self, replica: str):
        self.identities[replica] = None


class APIServer:
    """Control-plane facade: what the Migration Manager calls."""

    def __init__(self, sim: Sim, broker: Broker, registry: Registry,
                 timings: TimingConstants,
                 topology: Optional[NetworkTopology] = None):
        self.sim = sim
        self.broker = broker
        self.registry = registry
        self.timings = timings
        # default: the flat preset — one dedicated-capacity registry link,
        # bit-identical to the seed's bytes / registry_bw_Bps model
        self.topology = (topology if topology is not None else
                         flat_topology(
                             registry_bw_Bps=timings.registry_bw_Bps))
        self.topology.bind(sim)
        self.nodes: Dict[str, Node] = {}
        self.pods: Dict[str, Pod] = {}
        self.statefulsets = StatefulSetController()
        self.events: List[tuple] = []
        # registry availability (fault injection): while False every
        # node<->registry transfer fails fast with TransferAborted
        self.registry_up = True
        # in-flight registry transfers: (node_name, abort Condition) ->
        # creation site, so node deaths and registry outages can abort
        # exactly the affected flows without leaking callbacks on
        # long-lived conditions.  A dict (insertion-ordered), not a set:
        # set iteration order follows object hashes, and the abort fan-out
        # must not depend on ids
        self._live_transfers: Dict[tuple, Any] = {}
        # migration-event listeners (fault injection phase triggers, test
        # probes): called as fn(kind, t, data) for every MigrationContext
        # emit
        self.migration_listeners: List[Callable[[str, float, dict],
                                               None]] = []
        # rescan signal for the deadline-driven heartbeat monitor: node
        # set changed / node revived (fresh down condition to watch)
        self._hb_wake: Optional[Condition] = None

    def add_migration_listener(self, fn: Callable[[str, float, dict],
                                                  None]) -> None:
        self.migration_listeners.append(fn)
        if self.sim.sanitizer is not None:
            self.sim.sanitizer.check_listener_growth(
                "api migration_listeners", len(self.migration_listeners))

    def remove_migration_listener(self, fn: Callable) -> None:
        if fn in self.migration_listeners:
            self.migration_listeners.remove(fn)

    def _log(self, kind: str, **kw):
        self.events.append((self.sim.now, kind, kw))

    def notify_migration(self, kind: str, t: float, data: dict) -> None:
        for fn in list(self.migration_listeners):
            fn(kind, t, data)

    def _abort_transfers(self, node_name: Optional[str]) -> None:
        """Trigger the abort condition of every in-flight registry
        transfer touching ``node_name`` (None = all of them)."""
        for entry_node, cond in list(self._live_transfers):
            if node_name is None or entry_node == node_name:
                cond.trigger()

    # -- topology --------------------------------------------------------------
    def _hb_rescan(self) -> None:
        if self._hb_wake is not None:
            cond, self._hb_wake = self._hb_wake, None
            cond.trigger()

    def add_node(self, name: str, zone: Optional[str] = None) -> Node:
        """Register a node.  ``zone`` is required for nodes the topology
        does not already know when it spans more than one zone (see
        ``NetworkTopology.ensure_node``)."""
        # register with the topology FIRST: a zone conflict or a missing
        # zone on a multi-zone topology must not leave a half-added node
        self.topology.ensure_node(name, zone=zone)
        node = Node(name, sim=self.sim)
        self.nodes[name] = node
        self._hb_rescan()  # the monitor must watch the new node's down cond
        return node

    def kill_node(self, name: str):
        """Failure injection (hard crash): every pod on the node dies
        instantly, and every in-flight link transfer touching the node
        aborts."""
        node = self.nodes[name]
        node.alive = False
        for pod in list(node.pods.values()):
            pod.stop()
            self.pods.pop(pod.name, None)
        node.pods.clear()
        if node.down is not None:
            node.down.trigger()
        self._abort_transfers(name)
        self._log("node_killed", node=name)

    def partition_node(self, name: str):
        """Failure injection (soft/transient): the node drops off the
        network — its pods stall in place (state intact, nothing folded
        while "offline"; a mid-service message is requeued) and its
        in-flight transfers abort — but unlike :meth:`kill_node` the pods
        survive and resume on :meth:`revive_node`.  Models a network
        partition / kernel hang / reboot-without-data-loss: the flapping
        half of a ``node_flap`` fault."""
        node = self.nodes[name]
        for pod in node.pods.values():
            pod._fluid_sync()  # fold epochs at the exact partition instant
        node.alive = False
        for pod in node.pods.values():
            pod.wake()  # re-enter the loop so it sees node.alive == False
        if node.down is not None:
            node.down.trigger()
        self._abort_transfers(name)
        self._log("node_partitioned", node=name)

    def revive_node(self, name: str):
        """Bring a node back (maintenance over / transient partition healed)
        and wake any pod whose service loop stalled on the dead node."""
        node = self.nodes[name]
        node.alive = True
        node.last_heartbeat = self.sim.now
        node._hb_gen += 1  # invalidate any armed death-detection deadline
        node.down = Condition(self.sim, f"{name}:down")  # re-arm the abort
        for pod in list(node.pods.values()):
            pod.wake()
        self._hb_rescan()  # the monitor must watch the fresh down cond
        self._log("node_revived", node=name)

    # -- registry availability (fault injection) --------------------------------
    def set_registry_up(self, up: bool):
        """Registry outage toggle: while down, every push/pull/prefetch
        fails fast with ``TransferAborted`` and in-flight registry flows
        abort (the artifact registry is a single external dependency —
        when it is unreachable no node can move bytes)."""
        was = self.registry_up
        self.registry_up = up
        if was and not up:
            self._abort_transfers(None)
            self._log("registry_outage_begin")
        elif not was and up:
            self._log("registry_outage_end")

    # -- pod lifecycle (generator sub-processes) --------------------------------
    def create_pod(self, name: str, node_name: str, worker,
                   queue: MessageQueue, *, statefulset_identity=None,
                   processing_ms=None) -> Generator:
        t = self.timings
        yield t.pod_create_s
        node = self.nodes[node_name]
        if not node.alive:
            raise RuntimeError(f"node {node_name} is dead")
        if statefulset_identity is not None:
            self.statefulsets.claim(statefulset_identity, name)
        pod = Pod(name, node, worker, queue, self.sim, t,
                  processing_ms=processing_ms)
        node.pods[name] = pod
        self.pods[name] = pod
        self._log("pod_created", pod=name, node=node_name)
        return pod

    def delete_pod(self, name: str, *, statefulset_identity=None,
                   graceful: bool = True) -> Generator:
        t = self.timings
        pod = self.pods.get(name)
        if pod is not None:
            pod.stop()
        yield t.pod_delete_s if graceful else 0.1
        if statefulset_identity is not None:
            yield t.sts_identity_release_s
            self.statefulsets.release(statefulset_identity)
        if pod is not None:
            pod.node.pods.pop(name, None)
            self.pods.pop(name, None)
        self._log("pod_deleted", pod=name)

    # -- FCC: checkpoint / image / restore --------------------------------------
    def checkpoint_pod(self, pod: Pod) -> Generator:
        """FCC dump: snapshot the worker's state tree (real pytree)."""
        t = self.timings
        yield t.checkpoint_s
        pod._fluid_sync()  # the snapshot instant is migration-relevant
        state = pod.worker.state_tree()
        marker = pod.worker.last_msg_id
        self._log("checkpointed", pod=pod.name, last_msg_id=marker)
        return {"state": state, "last_msg_id": marker}

    def _data_path_cost_s(self, report) -> float:
        """Codec encode + device fingerprint compute for one push."""
        t = self.timings
        return (report.enc_raw_bytes / t.codec_Bps
                + report.fp_bytes / t.fingerprint_Bps)

    def _registry_transfer(self, node_name: Optional[str], nbytes: float,
                           base_s: float, extra_s: float = 0.0) -> Generator:
        """Charge one node<->registry transfer over the topology link.

        Dedicated links (the ``flat`` preset) are charged as one combined
        delay with the exact legacy ``base + bytes/bw + extra`` float
        arithmetic, so flat timelines stay bit-identical to the seed —
        including the seed's semantics that a mid-flight node death does
        NOT interrupt the delay (a dead node still fails fast before the
        transfer starts).  Shared links charge the fixed costs first, then
        join the link as a fair-share flow; if the node dies mid-flight
        the flow aborts with ``TransferAborted`` (the fleet orchestrator's
        guard isolates it)."""
        node = self.nodes.get(node_name) if node_name is not None else None
        if node is not None and not node.alive:
            raise TransferAborted(f"node {node_name} is dead")
        if not self.registry_up:
            raise TransferAborted("registry outage: transfer rejected")
        link = self.topology.registry_link(node_name)
        if not link.shared:
            dur = base_s + nbytes / link.capacity_Bps + extra_s
            if link.latency_s:
                dur += link.latency_s
            link.total_bytes += nbytes
            yield dur
            return
        yield base_s + extra_s
        # re-check after the fixed costs: the node may have died or the
        # registry gone down while they were being charged
        if node is not None and not node.alive:
            raise TransferAborted(f"node {node_name} is dead")
        if not self.registry_up:
            raise TransferAborted("registry outage: transfer rejected")
        # per-transfer abort condition, registered so node deaths and
        # registry outages can fan out to exactly the affected flows (and
        # nothing accumulates on long-lived conditions)
        abort = Condition(self.sim, "xfer-abort")
        entry = (node_name, abort)
        self._live_transfers[entry] = (
            capture_site() if self.sim.sanitizer is not None else None)
        try:
            yield from link.transfer(nbytes, abort=abort)
        finally:
            self._live_transfers.pop(entry, None)

    def build_and_push_image(self, checkpoint: dict, tag: str,
                             node_name: Optional[str] = None,
                             on_pushed: Optional[Callable[[str], None]]
                             = None) -> Generator:
        """Image Manager: OCI assembly + registry push (real bytes) over
        the pushing node's registry link.  ``on_pushed`` fires with the
        image id as soon as the registry holds it — BEFORE the transfer
        is charged, which can abort — so rollback can garbage-collect an
        image whose push died mid-wire."""
        t = self.timings
        yield t.image_build_s
        report = self.registry.push_image(
            {"state": checkpoint["state"]},
            meta={"last_msg_id": int(checkpoint["last_msg_id"]), "tag": tag},
            tag=tag,
        )
        if on_pushed is not None:
            on_pushed(report.image_id)
        yield from self._registry_transfer(
            node_name, report.written_bytes, t.push_base_s,
            extra_s=self._data_path_cost_s(report))
        self._log("image_pushed", tag=tag, image_id=report.image_id,
                  written=report.written_bytes, deduped=report.deduped_bytes)
        return report

    def push_delta_image(self, checkpoint: dict, tag: str,
                         parent_image_id: str, *,
                         compression="none", exact: bool = False,
                         node_name: Optional[str] = None,
                         on_pushed: Optional[Callable[[str], None]]
                         = None) -> Generator:
        """Pre-copy round: delta layer vs the parent image — the wire only
        carries *encoded* chunks the registry doesn't already hold.
        ``compression`` selects the per-leaf delta codec; ``exact=True``
        restricts it to lossless codecs (the pre-copy final flush).
        ``on_pushed`` fires with the image id before the (abortable)
        transfer — see ``build_and_push_image``."""
        t = self.timings
        yield t.delta_build_s
        report = self.registry.push_delta(
            {"state": checkpoint["state"]}, parent_image_id,
            meta={"last_msg_id": int(checkpoint["last_msg_id"]), "tag": tag},
            tag=tag, compression=compression, exact=exact,
        )
        if on_pushed is not None:
            on_pushed(report.image_id)
        yield from self._registry_transfer(
            node_name, report.written_bytes, t.push_base_s,
            extra_s=self._data_path_cost_s(report))
        self._log("delta_pushed", tag=tag, image_id=report.image_id,
                  parent=parent_image_id, delta=report.delta_bytes,
                  wire=report.wire_bytes, written=report.written_bytes,
                  codec=report.codec, lossy=report.lossy)
        return report

    def prefetch_image(self, node_name: str, image_id: str) -> Generator:
        """Warm a node's layer cache while the source keeps serving; the
        final restore then pulls only what prefetching missed."""
        t = self.timings
        node = self.nodes[node_name]
        chunks = self.registry.image_chunks(image_id)
        new_bytes = sum(size for key, size in chunks.items()
                        if key not in node.image_chunks)
        yield from self._registry_transfer(node_name, new_bytes,
                                           t.pull_base_s)
        # cache only after the transfer lands: a concurrent pull to the same
        # node must not ride for free on bytes still in flight
        node.image_chunks.update(chunks)
        self._log("image_prefetched", node=node_name, image_id=image_id,
                  bytes=new_bytes)
        return new_bytes

    def pull_and_restore(self, image_id: str, worker,
                         node_name: Optional[str] = None) -> Generator:
        """Target node: pull from registry, restore worker state.  With
        ``node_name``, the node's layer cache discounts already-held
        chunks (and is updated with the pulled ones)."""
        t = self.timings
        node = self.nodes[node_name] if node_name is not None else None
        trees, pulled = self.registry.pull_image(
            image_id,
            have_chunks=node.image_chunks if node is not None else None)
        yield from self._registry_transfer(node_name, pulled, t.pull_base_s)
        if node is not None:  # cache after the transfer lands (see prefetch)
            node.image_chunks.update(self.registry.image_chunks(image_id))
        yield t.restore_s
        worker.load_state(trees["state"])
        meta = self.registry.image_meta(image_id)
        self._log("restored", image_id=image_id, pulled=pulled,
                  last_msg_id=meta.get("last_msg_id"))
        return meta

    # -- failure detection / reconciliation -------------------------------------
    def start_heartbeats(self, on_node_dead: Callable[[str], None]):
        """Deadline-driven failure detector.

        The seed's monitor ticked every ``heartbeat_interval_s`` forever —
        at fleet scale those ticks dominate the heap.  This version wakes
        only when a node goes down (its ``down`` condition) and arms one
        detection deadline per death, with *unchanged detection times*:
        the tick grid ``s + k*interval`` is reconstructed lazily with the
        same sequential float additions the tick loop performed, the last
        refresh a dead node would have received is the greatest grid tick
        at or before the death instant, and detection fires at the first
        grid tick strictly more than ``heartbeat_timeout_s`` past it.
        A revive bumps the node's generation counter, voiding any armed
        deadline (tests/test_heartbeat.py pins the timelines).
        """
        t = self.timings
        interval = t.heartbeat_interval_s
        timeout = t.heartbeat_timeout_s
        # grid state: greatest conceptual tick <= now (None before the
        # first) and the next one, advanced by sequential float adds so
        # tick values are bit-identical to the legacy `yield interval` loop
        grid = {"last": None, "next": self.sim.now + interval}

        def arm(node: Node) -> None:
            gen = node._hb_gen
            if node._hb_armed_gen == gen:
                return
            if node.last_heartbeat == float("inf"):
                return  # already reported dead (fire-once marker)
            while grid["next"] <= self.sim.now:
                grid["last"] = grid["next"]
                grid["next"] = grid["next"] + interval
            lhb = node.last_heartbeat
            if grid["last"] is not None and grid["last"] > lhb:
                lhb = grid["last"]  # last refresh the tick loop recorded
            node.last_heartbeat = lhb
            tick = grid["next"]
            while not (tick - lhb > timeout):
                tick = tick + interval
            node._hb_armed_gen = gen

            def fire(node=node, gen=gen):
                if node._hb_gen != gen or node.alive:
                    return  # revived before the deadline
                if node.last_heartbeat == float("inf"):
                    return
                node.last_heartbeat = float("inf")  # fire once
                on_node_dead(node.name)

            self.sim.call_at(tick, fire, category="heartbeat")

        def monitor() -> Generator:
            while True:
                for node in self.nodes.values():
                    if not node.alive:
                        arm(node)
                watch = [n.down for n in self.nodes.values()
                         if n.alive and n.down is not None]
                self._hb_wake = self.sim.condition("heartbeat:wake")
                watch.append(self._hb_wake)
                yield self.sim.any_of(*watch)

        self.sim.process(monitor(), name="heartbeat-monitor")

    # -- vectorized fleet telemetry ---------------------------------------------
    def fleet_state(self) -> dict:
        """Numpy snapshot of per-pod state (sorted by pod name): queue
        depth, last-processed id, processed count, busy/serving flags.
        Syncs every pod first, so the arrays reflect the exact current
        instant in both execution regimes.  O(pods) arrays instead of
        O(pods) Python attribute walks per consumer — the orchestrator
        and fleet benchmarks read this at scale."""
        import numpy as np

        names = sorted(self.pods)
        pods = [self.pods[n] for n in names]
        now = self.sim.now
        for p in pods:
            p.queue.sync(now)
            p._fluid_sync()
        return {
            "pods": names,
            "node": [p.node.name for p in pods],
            "queue": [p.queue.name for p in pods],
            "queue_depth": np.array([p.queue.depth() for p in pods],
                                    dtype=np.int64),
            "total_published": np.array(
                [p.queue.total_published for p in pods], dtype=np.int64),
            "last_msg_id": np.array(
                [p.worker.last_msg_id for p in pods], dtype=np.int64),
            "n_processed": np.array(
                [getattr(p.worker, "n_processed", 0) for p in pods],
                dtype=np.int64),
            "busy": np.array([p.busy for p in pods], dtype=bool),
            "serving": np.array([p.serving for p in pods], dtype=bool),
        }


class Cluster:
    """Convenience bundle: sim + broker + registry + api server.

    ``topology`` selects the network model: ``None`` / ``"flat"`` (the
    seed-identical uncontended registry link), another preset name
    (``"two_zone"``, ``"edge_wan"``), a ready ``NetworkTopology``, or a
    factory ``(node_names, registry_bw_Bps) -> NetworkTopology``.

    ``faults`` injects a deterministic failure schedule: a
    ``repro_torch.cluster.faults.FaultSchedule``, a list of ``Fault``s / fault
    spec strings, or ``None`` (no faults — the default).  The schedule is
    armed immediately: timed faults become sim processes, phase-triggered
    faults subscribe to migration events."""

    def __init__(self, registry_root: str,
                 timings: Optional[TimingConstants] = None,
                 num_nodes: int = 3,
                 chunk_bytes: Optional[int] = None,
                 topology=None,
                 faults=None,
                 sanitize: Optional[bool] = None,
                 tiebreak_seed: Optional[int] = None,
                 fluid: Optional[bool] = None,
                 census: Optional[bool] = None):
        self.sim = Sim(sanitize=sanitize, tiebreak_seed=tiebreak_seed,
                       fluid=fluid, census=census)
        self.broker = Broker(self.sim)
        self.registry = Registry(registry_root, chunk_bytes=chunk_bytes)
        self.timings = timings or TimingConstants()
        node_names = [f"node{i}" for i in range(num_nodes)]
        self.topology = make_topology(topology, node_names,
                                      self.timings.registry_bw_Bps)
        self.api = APIServer(self.sim, self.broker, self.registry,
                             self.timings, topology=self.topology)
        for name in node_names:
            self.api.add_node(name)
        self.faults = None
        if faults is not None:
            from repro_torch.cluster.faults import FaultInjector, make_schedule
            self.faults = FaultInjector(self.api, make_schedule(faults))
            self.faults.arm()
