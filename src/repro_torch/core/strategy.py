"""Pluggable migration strategies: registry, base class and the
composable phase primitives strategies are built from.

A strategy is a registered class::

    @register_strategy("my_scheme")
    class MyScheme(MigrationStrategy):
        def run(self, ctx):            # a sim generator
            sec = ctx.attach_secondary()
            push = yield from ctx.transfer(use_precopy=False,
                                           pre_tag="t-pre", full_tag="t")
            ...

``MigrationManager.migrate("my_scheme", ...)`` resolves the name through
the registry — the manager core knows nothing about individual schemes, so
new scenarios are added without touching it.

The building blocks live here too:

  * transfer engines — ``SingleShotTransfer`` (one checkpoint + full image
    push) and ``IterativePrecopyTransfer`` (checkpoint -> delta-push rounds
    with target-node prefetch until the dirty set converges);
  * catch-up disciplines — ``LiveSyncCatchup`` (target chases the live
    source), ``ThresholdCutoffCatchup`` (live sync under the Eq. 5
    deadline, draining to a frozen id once it fires) and
    ``StopThenReplayCatchup`` (source already stopped; bounded replay to
    its last processed id);
  * cutover steps and the listener/condition helpers migrations use to
    observe pod progress without leaking callbacks.

``MigrationContext`` carries the per-migration state (source, target node,
policy, report, secondary queue, listener subscriptions) and exposes the
primitives as methods, so a strategy body reads as its phase pipeline.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Generator, List, Optional, Type

from repro_torch.cluster.cluster import APIServer, Pod
from repro_torch.cluster.sim import Condition, Sim
from repro_torch.core.policy import MigrationPolicy, MigrationReport


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type["MigrationStrategy"]] = {}


class TargetNodeLost(RuntimeError):
    """The migration's target node died (crash or partition) at a point
    where the migration could never make progress again — raised instead
    of hanging forever on a catch-up condition a dead pod cannot satisfy."""


class MigrationError(RuntimeError):
    """A migration failed and its rollback ran; carries the context so
    callers (the orchestrator retry loop) can see what the rollback
    restored.  ``str()`` is the *cause*'s message, so failure reports
    read the same as before the rollback layer existed."""

    def __init__(self, context: "MigrationContext", cause: BaseException):
        super().__init__(f"{type(cause).__name__}: {cause}")
        self.context = context
        self.cause = cause


def register_strategy(name: str) -> Callable[[Type["MigrationStrategy"]],
                                             Type["MigrationStrategy"]]:
    """Class decorator adding a strategy to the global registry."""

    def deco(cls: Type["MigrationStrategy"]) -> Type["MigrationStrategy"]:
        if not issubclass(cls, MigrationStrategy):
            raise TypeError(f"{cls!r} must subclass MigrationStrategy")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_strategy(name: str) -> Type["MigrationStrategy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown migration strategy {name!r}; "
            f"available: {available_strategies()}") from None


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def registry_entries() -> List[Dict[str, Any]]:
    """One row per registered strategy: name, control-plane flags and the
    docstring's first paragraph.  This is the single source for the CLI's
    ``--list-strategies`` output and the README strategy table
    (``tools/check_docs.py`` regenerates and diffs the table from it, so
    the docs cannot drift from the code)."""
    rows = []
    for name in available_strategies():
        cls = _REGISTRY[name]
        doc = (cls.__doc__ or "").strip()
        summary = " ".join(line.strip()
                           for line in doc.split("\n\n")[0].splitlines())
        rows.append({"name": name,
                     "wants_cutoff": cls.wants_cutoff,
                     "handles_identity": cls.handles_identity,
                     "summary": summary})
    return rows


# ---------------------------------------------------------------------------
# Pod-observation helpers (listener bookkeeping + wait conditions)
# ---------------------------------------------------------------------------

def listen(pod: Pod, fn: Callable, subs: List) -> None:
    """Subscribe ``fn`` to the pod's processed events, recording the
    subscription so the migration can deregister it on completion."""
    pod.add_on_processed(fn)
    subs.append((pod, fn))


def unlisten_all(subs: List) -> None:
    for pod, fn in subs:
        pod.remove_on_processed(fn)
    subs.clear()


def sync_condition(sim: Sim, target_pod: Pod, source_pod: Pod,
                   secondary, subs: List) -> Condition:
    """Triggered when target has replayed everything the source has
    processed and the mirror buffer is empty."""
    cond = sim.condition("synced")

    def check(*_):
        if (secondary.depth() == 0
                and target_pod.worker.last_msg_id >= source_pod.worker.last_msg_id):
            cond.trigger()

    listen(target_pod, check, subs)
    listen(source_pod, check, subs)
    check()
    return cond


def drain_condition(sim: Sim, target_pod: Pod, up_to_id: int,
                    secondary, subs: List) -> Condition:
    """Triggered when target has replayed ids <= up_to_id.

    The empty-mirror short-circuit exists for ids the mirror can never
    deliver (messages consumed from the primary before the secondary
    was attached).  It may only fire when no more mirrored traffic can
    arrive for the target: the mirror is empty AND nothing is in
    flight (mid-service) at the target — a momentarily-empty mirror
    while the last mirrored message is still being folded must NOT
    trigger a premature cutover (that dropped the in-flight message's
    state update from the downtime accounting and switched routes
    before the target was caught up)."""
    cond = sim.condition("drained")

    def check(*_):
        if target_pod.worker.last_msg_id >= up_to_id or (
                secondary.depth() == 0 and not target_pod.busy):
            cond.trigger()

    listen(target_pod, check, subs)
    check()
    return cond


# ---------------------------------------------------------------------------
# Per-migration context: state + phase primitives
# ---------------------------------------------------------------------------

class MigrationContext:
    """Everything one migration needs: control-plane handles, the policy,
    the report under construction, and the phase primitives."""

    def __init__(self, manager, source: Pod, target_node: str,
                 identity: Optional[str], policy: MigrationPolicy,
                 strategy_name: str, n: int):
        self.manager = manager
        self.api: APIServer = manager.api
        self.sim: Sim = manager.sim
        self.broker = manager.broker
        self.make_worker = manager.make_worker
        self.primary_queue: str = manager.primary_queue
        self.cutoff = manager.cutoff
        self.policy = policy
        self.source = source
        self.target_node = target_node
        self.identity = identity
        self.n = n
        self.report = MigrationReport(strategy_name, self.sim.now)
        self.report.compression = (
            policy.compression if isinstance(policy.compression, str)
            else str(policy.compression))
        self.subs: List = []   # processed-event listeners, removed on cleanup
        self.secondary = None  # the mirror queue, once attached
        # crash-consistency state: what rollback() needs to undo a half-run
        # migration, and what the retry loop needs to pick up afterwards
        self.target: Optional[Pod] = None    # the target pod, once created
        self.pushed_images: List[str] = []   # every image this attempt pushed
        self.switched = False      # past the commit point (route switched)
        self.closed = False        # cleanup ran (disarms stray timers)
        self.rolled_back = False   # rollback restored the workload
        self.restored_source: Optional[Pod] = None
        self.rollback_error: Optional[BaseException] = None
        if self.sim.sanitizer is not None:
            # this migration now owns the source: if a previous attempt's
            # rollback armed a stale-pause watchpoint on it, disarm it —
            # pausing the source is legitimate again
            self.sim.sanitizer.unprotect_pod(source)

    # -- trace ----------------------------------------------------------------
    def emit(self, kind: str, **data: Any):
        ev = self.report.emit(kind, self.sim.now, **data)
        # fan out to control-plane listeners (fault injection phase
        # triggers, test probes) with the migration's identity attached
        self.api.notify_migration(
            kind, self.sim.now,
            {**data, "queue": self.primary_queue,
             "strategy": self.report.strategy, "n": self.n})
        return ev

    def phase(self, name: str, t0: float) -> None:
        self.emit("phase", phase=name, duration=self.sim.now - t0)

    # -- mirror / conditions --------------------------------------------------
    def attach_secondary(self):
        self.secondary = self.broker.attach_secondary(
            self.primary_queue, f"{self.primary_queue}.sec{self.n}")
        return self.secondary

    def sync_condition(self, target: Pod) -> Condition:
        return sync_condition(self.sim, target, self.source, self.secondary,
                              self.subs)

    def drain_condition(self, target: Pod, up_to_id: int) -> Condition:
        return drain_condition(self.sim, target, up_to_id, self.secondary,
                               self.subs)

    def wait(self, cond: Condition) -> Generator:
        """Block on ``cond``, racing it against target-node death.

        Catch-up and drain conditions are satisfied by the *target pod*
        making progress; a dead target node means they can never trigger,
        so a migration that yielded them bare would hang forever instead
        of failing into the rollback/retry path.  Every discipline and
        cutover wait routes through here."""
        node = self.api.nodes.get(self.target_node)
        if node is None or node.down is None:
            yield cond
            return
        if not node.alive:
            raise TargetNodeLost(f"target node {self.target_node} is down")
        if not cond.triggered:
            yield self.sim.any_of(cond, node.down)
        if not cond.triggered:
            raise TargetNodeLost(
                f"target node {self.target_node} died mid-migration")

    def ensure_target(self, target: Pod) -> None:
        """Fail fast if the target pod can no longer serve (its node died
        or it was killed): committing a cutover onto a dead target would
        silently lose the workload."""
        if target.deleted or not target.node.alive:
            raise TargetNodeLost(
                f"target pod {target.name} lost (node "
                f"{target.node.name} {'dead' if not target.node.alive else 'ok'})")

    def switch_to_primary(self, target: Pod) -> None:
        self.ensure_target(target)  # last check before the commit point
        self.broker.detach_secondary(self.primary_queue, self.secondary.name)
        target.queue = self.broker.queues[self.primary_queue]
        target.wake()  # unblock if it was waiting on the secondary
        self.switched = True

    def cleanup(self) -> None:
        """Always-run teardown: deregister listeners (repeated migrations
        of one lineage must not fire stale checks) and detach the mirror
        if the migration died before cutover (an orphan mirror would
        double-buffer every future publish into a queue nothing drains).
        Sets ``closed`` so stray timers (a cutoff deadline armed for this
        migration) can tell the migration is over and must not touch the
        source again."""
        self.closed = True
        unlisten_all(self.subs)
        if (self.secondary is not None
                and self.broker.is_mirrored(self.primary_queue,
                                            self.secondary.name)):
            self.broker.detach_secondary(self.primary_queue,
                                         self.secondary.name)

    def rollback(self, cause: BaseException) -> Generator:
        """Transactional abort: leave the workload as if this attempt had
        never started.  Steps (all idempotent):

          1. listeners deregistered, the cutoff/sync mirror torn down
             (``cleanup``);
          2. the half-built target pod deleted — releasing a StatefulSet
             identity it claimed; a pod that died with its node leaves
             only identity bookkeeping to clear;
          3. every image this attempt pushed deleted from the registry
             and orphaned chunks garbage-collected (half-pushed delta
             lineages do not leak storage);
          4. the source serving again: resumed in place when it was only
             paused, or re-created from its still-live worker object —
             re-claiming its identity — when the strategy had already
             deleted it (the stop-then-replay paths).

        Sets ``rolled_back`` when the source is provably serving again.
        A dead source node leaves it False: there is nothing to roll back
        *to* — that is the journal/heartbeat recovery path's job, not the
        migration layer's."""
        self.emit("rollback_begin", cause=f"{type(cause).__name__}: {cause}")
        self.cleanup()
        api, source = self.api, self.source
        # -- target remnants --------------------------------------------------
        tgt = self.target
        if tgt is not None and not self.switched:
            identity = (self.identity
                        if self.identity is not None
                        and api.statefulsets.identities.get(self.identity)
                        == tgt.name else None)
            if tgt.name in api.pods:
                yield from api.delete_pod(tgt.name,
                                          statefulset_identity=identity,
                                          graceful=False)
            elif identity is not None:
                # the pod died with its node; only the claim survives
                api.statefulsets.release(identity)
            self.target = None
        # -- registry garbage -------------------------------------------------
        if self.pushed_images:
            removed = sum(api.registry.delete_image(i)
                          for i in reversed(self.pushed_images))
            chunks, freed = api.registry.gc()
            self.emit("rollback_gc", images=removed, chunks=chunks,
                      bytes_freed=freed)
            self.pushed_images.clear()
        # -- source back in service -------------------------------------------
        if not source.deleted:
            if source.paused:
                source.resume()
            self.restored_source = source
            self.rolled_back = True
        elif source.node.alive and source.name not in api.pods:
            # the strategy deleted the source before the failure (the
            # stop-then-replay paths); its worker object still holds the
            # full state, so re-create the pod around it
            identity = None
            if (self.identity is not None
                    and api.statefulsets.identities.get(self.identity)
                    is None):
                identity = self.identity
            pod = yield from api.create_pod(
                source.name, source.node.name, source.worker,
                self.broker.queues[self.primary_queue],
                statefulset_identity=identity,
                processing_ms=source.processing_ms)
            pod.start()
            self.restored_source = pod
            self.rolled_back = True
        if self.rolled_back and self.sim.sanitizer is not None:
            # arm the stale-pause watchpoint: nothing owns this pod now, so
            # any later pause() is a timer that outlived its migration
            self.sim.sanitizer.protect_pod(self.restored_source)
        self.emit("rollback_end", rolled_back=self.rolled_back,
                  restored_source=(self.restored_source.name
                                   if self.restored_source else None))

    # -- transfer phase -------------------------------------------------------
    def transfer(self, use_precopy: bool, pre_tag: str,
                 full_tag: str) -> Generator:
        """Checkpoint-transfer phase via the policy-selected engine."""
        engine = (IterativePrecopyTransfer(pre_tag) if use_precopy
                  else SingleShotTransfer(full_tag))
        push = yield from engine.run(self)
        return push

    def full_transfer(self, tag: str) -> Generator:
        """Checkpoint + full image push, with phase/report accounting.
        Returns (checkpoint dict, PushReport)."""
        rep = self.report
        t0 = self.sim.now
        ckpt = yield from self.api.checkpoint_pod(self.source)  # still serving
        rep.checkpoint_marker = ckpt["last_msg_id"]
        self.phase("checkpoint", t0)

        t0 = self.sim.now
        # the image id is recorded via on_pushed BEFORE the wire transfer,
        # which can abort: a half-pushed image must still be reachable by
        # rollback's garbage collection
        push = yield from self.api.build_and_push_image(
            ckpt, tag, node_name=self.source.node.name,
            on_pushed=self.pushed_images.append)
        rep.image_id = push.image_id
        rep.image_written_bytes = push.written_bytes
        rep.image_deduped_bytes = push.deduped_bytes
        rep.image_raw_bytes += push.delta_bytes
        rep.image_wire_bytes += push.wire_bytes
        self.phase("image_build_push", t0)
        return ckpt, push

    # -- target restoration ---------------------------------------------------
    def restore_target(self, push, queue, *, replay: bool = True,
                       identity: Optional[str] = None) -> Generator:
        """Create the target pod and restore the pushed image into it.
        With ``replay`` the pod consumes at the (possibly batched) replay
        rate until cutover restores the service rate."""
        t0 = self.sim.now
        worker = self.make_worker()
        worker.skip_until = self.report.checkpoint_marker
        proc_ms = self.source.processing_ms
        if replay:
            proc_ms = proc_ms / self.policy.replay_speedup
        target = yield from self.api.create_pod(
            f"{self.source.name}-target-{self.n}", self.target_node, worker,
            queue, statefulset_identity=identity, processing_ms=proc_ms)
        self.target = target  # rollback deletes a half-restored target
        yield from self.api.pull_and_restore(push.image_id, worker,
                                             node_name=self.target_node)
        self.ensure_target(target)  # a flat-link pull ignores node death
        self.phase("service_restoration", t0)
        return target

    # -- cutover / teardown steps ---------------------------------------------
    def finish(self, target: Pod) -> None:
        self.report.t_end = self.sim.now
        self.emit("migration_end", target=target.name,
                  downtime=self.report.downtime)

    def teardown_source(self) -> Generator:
        t0 = self.sim.now
        yield from self.api.delete_pod(self.source.name)
        self.phase("source_teardown", t0)

    # -- telemetry probes (used by adaptive strategies) -----------------------
    def state_nbytes(self) -> int:
        """Approximate serialized size of the source worker's state tree —
        the wire cost of one full checkpoint image."""
        return worker_state_nbytes(self.source.worker)

    def observed_rates(self) -> tuple:
        """(lambda, mu) estimates: the CutoffController's view when one is
        wired (EWMA estimates or operator fallbacks), else a windowed
        recent-arrival-rate estimate on the primary queue and the service
        capacity implied by the pod's processing time."""
        if self.cutoff is not None:
            return self.cutoff.lam, self.cutoff.mu
        q = self.broker.queues[self.primary_queue]
        q.sync(self.sim.now)  # count lazily-drawn arrivals due by now
        lam = recent_arrival_rate(q, self.source, self.sim.now)
        mu = 1000.0 / self.source.processing_ms
        return lam, mu


def recent_arrival_rate(queue, pod, now: float, *,
                        halflife: float = 10.0,
                        max_samples: int = 256) -> float:
    """Windowed/EWMA recent arrival rate (events/s) on a queue at ``now``.

    Replaces the lifetime average ``total_published / now``, which is
    badly stale under diurnal / flash-crowd traffic (a spike an hour ago
    and a spike right now read the same) and biased low for queues whose
    source attached late (it divides by time the queue did not exist).

    Recent arrival timestamps are reconstructed from what the broker and
    consumer still hold at the decision instant — ids are dense, so the
    unconsumed backlog is exactly the *newest* arrivals — extended with
    the consumer's recent service completions when the backlog is short
    (a drained queue folds each message within one service time of its
    arrival, so completion spacing tracks arrival spacing).  The merged
    timestamps feed the same EWMA :class:`~repro_torch.core.cutoff.RateEstimator`
    the CutoffController uses.  With fewer than two recent samples the
    estimate falls back to the lifetime average (exact for a fresh
    queue, and the legacy value when there is nothing better)."""
    from repro_torch.core.cutoff import RateEstimator

    window_s = 6.0 * halflife
    t_min = now - window_s
    backlog = [m.publish_time for m in queue._items if m.publish_time >= t_min]
    samples = backlog
    if len(backlog) < max_samples and pod is not None \
            and getattr(pod, "keep_service_log", False):
        # completions are for *consumed* ids, backlog times for unconsumed
        # ones — disjoint messages, so merging them never double-counts
        svc = [t for t, _ in pod.service_log[-max_samples:] if t >= t_min]
        samples = sorted(svc + backlog)
    samples = samples[-max_samples:]
    if len(samples) < 2:
        return queue.total_published / now if now > 0 else 0.0
    est = RateEstimator(halflife=halflife)
    for t in samples:
        est.observe(t)
    return est.rate


def tree_nbytes(tree: Any) -> int:
    """Approximate serialized size of a state pytree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(tree, (bytes, bytearray)):
        return len(tree)
    return 8  # python scalar


def worker_state_nbytes(worker: Any) -> int:
    """State size of a worker, preferring its own ``state_nbytes()``
    (copy-free) over measuring a full ``state_tree()`` snapshot — workers
    whose snapshots copy large buffers should implement the former."""
    probe = getattr(worker, "state_nbytes", None)
    if callable(probe):
        return int(probe())
    return tree_nbytes(worker.state_tree())


# ---------------------------------------------------------------------------
# Transfer engines
# ---------------------------------------------------------------------------

class TransferEngine:
    """Moves the source's state image to where the target can restore it.
    ``run(ctx)`` returns the final PushReport (and records the checkpoint
    marker on the report)."""

    def run(self, ctx: MigrationContext) -> Generator:
        raise NotImplementedError


class SingleShotTransfer(TransferEngine):
    """One checkpoint + one full image push (the paper's scheme)."""

    def __init__(self, tag: str):
        self.tag = tag

    def run(self, ctx: MigrationContext) -> Generator:
        _, push = yield from ctx.full_transfer(self.tag)
        return push


class IterativePrecopyTransfer(TransferEngine):
    """One full checkpoint+push, then checkpoint -> delta-push rounds while
    the source keeps serving.  Every image is prefetched onto the target
    node, so the final restore pulls ~nothing; the loop stops when the
    inter-round dirty set (messages processed between two consecutive
    checkpoints) converges.  The replay log left for the target is bounded
    by the LAST round's traffic instead of the whole transfer."""

    def __init__(self, tag: str):
        self.tag = tag

    def run(self, ctx: MigrationContext) -> Generator:
        api, sim, rep, pol = ctx.api, ctx.sim, ctx.report, ctx.policy
        source, tag = ctx.source, self.tag
        base = source.worker.last_msg_id  # lineage may predate this migration
        ckpt, push = yield from ctx.full_transfer(f"{tag}-r0")
        t0 = sim.now
        yield from api.prefetch_image(ctx.target_node, push.image_id)
        ctx.phase("precopy_prefetch", t0)
        rep.precopy_round_bytes.append(push.delta_bytes)
        rep.precopy_round_wire_bytes.append(push.wire_bytes)
        rep.precopy_round_dirty.append(ckpt["last_msg_id"] - base)
        marker = ckpt["last_msg_id"]
        ctx.emit("precopy_round", round=0, bytes=push.delta_bytes,
                 wire=push.wire_bytes, dirty=ckpt["last_msg_id"] - base)

        lossy_lineage = False
        prev_dirty: Optional[int] = None
        while rep.precopy_rounds < pol.precopy_max_rounds:
            # phases stay comparable across strategies: dumps are always
            # booked as "checkpoint", only delta build/push/prefetch as
            # the precopy-specific phases
            t0 = sim.now
            ckpt = yield from api.checkpoint_pod(source)
            ctx.phase("checkpoint", t0)
            dirty = ckpt["last_msg_id"] - marker
            if dirty <= pol.precopy_min_dirty:
                # nothing dirtied since the last round (e.g. source already
                # paused by the cutoff): the previous image already holds
                # this exact state — don't pay for a bit-identical push
                break
            t0 = sim.now
            delta = yield from api.push_delta_image(
                ckpt, f"{tag}-r{rep.precopy_rounds + 1}", push.image_id,
                compression=pol.compression, node_name=source.node.name,
                on_pushed=ctx.pushed_images.append)
            yield from api.prefetch_image(ctx.target_node, delta.image_id)
            ctx.phase("precopy_delta", t0)
            push = delta
            marker = ckpt["last_msg_id"]
            lossy_lineage = lossy_lineage or delta.lossy
            rep.precopy_rounds += 1
            rep.precopy_round_bytes.append(delta.delta_bytes)
            rep.precopy_round_wire_bytes.append(delta.wire_bytes)
            rep.precopy_round_dirty.append(dirty)
            rep.image_written_bytes += delta.written_bytes
            rep.image_deduped_bytes += delta.deduped_bytes
            rep.image_raw_bytes += delta.delta_bytes
            rep.image_wire_bytes += delta.wire_bytes
            ctx.emit("precopy_round", round=rep.precopy_rounds,
                     bytes=delta.delta_bytes, wire=delta.wire_bytes,
                     dirty=dirty)
            if (prev_dirty is not None
                    and dirty >= prev_dirty * pol.precopy_converge_ratio):
                break  # dirty set stopped shrinking: steady state reached
            prev_dirty = dirty
        if lossy_lineage:
            # lossy codec rounds warm the wire cheaply, but the image that
            # is actually restored at cutover must decode bit-exactly:
            # flush the residual (truth minus the receiver's lossy
            # reconstruction) with lossless codecs only
            t0 = sim.now
            flush = yield from api.push_delta_image(
                ckpt, f"{tag}-exact", push.image_id,
                compression=pol.compression, exact=True,
                node_name=source.node.name,
                on_pushed=ctx.pushed_images.append)
            yield from api.prefetch_image(ctx.target_node, flush.image_id)
            ctx.phase("precopy_exact_flush", t0)
            push = flush
            # the flush ships the LAST dump, which (with precopy_min_dirty
            # > 0) may be ahead of the last pushed round: the marker must
            # describe the image actually restored
            marker = ckpt["last_msg_id"]
            rep.precopy_rounds += 1
            rep.precopy_round_bytes.append(flush.delta_bytes)
            rep.precopy_round_wire_bytes.append(flush.wire_bytes)
            rep.precopy_round_dirty.append(0)
            rep.image_written_bytes += flush.written_bytes
            rep.image_deduped_bytes += flush.deduped_bytes
            rep.image_raw_bytes += flush.delta_bytes
            rep.image_wire_bytes += flush.wire_bytes
            ctx.emit("precopy_exact_flush", bytes=flush.delta_bytes,
                     wire=flush.wire_bytes)
        rep.checkpoint_marker = marker
        rep.image_id = push.image_id
        return push


# ---------------------------------------------------------------------------
# Catch-up disciplines
# ---------------------------------------------------------------------------

class CatchupDiscipline:
    """How the target catches up with mirrored traffic before cutover.

    ``arm`` runs when accumulation starts (secondary attached, before the
    transfer); ``catchup`` runs after the target is restored and started;
    ``begin_cutover`` pauses the source (or reuses an earlier stop) and
    returns the instant downtime started."""

    def arm(self, ctx: MigrationContext) -> None:
        pass

    def catchup(self, ctx: MigrationContext, target: Pod) -> Generator:
        raise NotImplementedError
        yield  # pragma: no cover

    def begin_cutover(self, ctx: MigrationContext) -> float:
        ctx.source.pause()
        return ctx.sim.now


class LiveSyncCatchup(CatchupDiscipline):
    """Target replays the mirror while the source keeps serving, until it
    has seen everything the source has (paper Fig. 2)."""

    def catchup(self, ctx: MigrationContext, target: Pod) -> Generator:
        yield from ctx.wait(ctx.sync_condition(target))


class ThresholdCutoffCatchup(CatchupDiscipline):
    """Live sync under the Threshold-Based Cutoff (paper Fig. 3, Eq. 5):
    when T_accum hits the deadline, the SOURCE STOPS — even mid-transfer —
    capping the replay log at N <= lam * T_cutoff so that
    T_replay <= T_replay_max by construction."""

    def __init__(self, deadline: float):
        self.deadline = deadline
        self.state: dict = {"fired": False, "pause_time": None, "id": None}

    def arm(self, ctx: MigrationContext) -> None:
        self.fired_cond = ctx.sim.condition("cutoff-fired")
        source, state = ctx.source, self.state

        def _fire():
            if ctx.closed:
                # the migration is over; the deadline correctly disarms
                # itself (the sanitizer counts these — a *missing* guard
                # here is exactly what its stale-pause watchpoint catches)
                if ctx.sim.sanitizer is not None:
                    ctx.sim.sanitizer.note_disarmed_timer()
                return
            if (not state["fired"] and not source.paused
                    and not source.deleted):
                state["fired"] = True
                state["pause_time"] = ctx.sim.now
                source.pause()
                state["id"] = source.worker.last_msg_id
                ctx.emit("cutoff_fired", cutoff_id=state["id"],
                         deadline=self.deadline)
                self.fired_cond.trigger()

        ctx.sim.call_at(ctx.sim.now + self.deadline, _fire)

    def catchup(self, ctx: MigrationContext, target: Pod) -> Generator:
        if self.state["fired"]:
            # source already stopped (deadline expired mid-transfer):
            # bounded replay to the frozen cutoff id
            yield from ctx.wait(ctx.drain_condition(target, self.state["id"]))
            return
        synced = ctx.sync_condition(target)
        yield from ctx.wait(ctx.sim.any_of(synced, self.fired_cond))
        if self.state["fired"] and not synced.triggered:
            # fired mid-catch-up: bounded drain to the frozen id
            yield from ctx.wait(ctx.drain_condition(target, self.state["id"]))

    def begin_cutover(self, ctx: MigrationContext) -> float:
        if self.state["fired"]:
            ctx.report.cutoff_fired = True
            ctx.report.cutoff_id = self.state["id"]
            return self.state["pause_time"]  # downtime began at the pause
        ctx.source.pause()
        return ctx.sim.now


class StopThenReplayCatchup(CatchupDiscipline):
    """Source is already stopped (sticky-identity handoff, paper Fig. 4):
    bounded replay of the mirror up to the source's last processed id."""

    def __init__(self, up_to_id: int):
        self.up_to_id = up_to_id

    def catchup(self, ctx: MigrationContext, target: Pod) -> Generator:
        yield from ctx.wait(ctx.drain_condition(target, self.up_to_id))


# ---------------------------------------------------------------------------
# Strategy base class
# ---------------------------------------------------------------------------

class MigrationStrategy:
    """One migration scheme, expressed as a pipeline of phase primitives.

    Subclass, implement ``run(ctx)`` as a sim generator returning
    ``(report, target_pod)``, and register with ``@register_strategy``.
    Class attributes declare control-plane needs so harnesses and the
    manager stay scheme-agnostic:

      * ``handles_identity`` — may receive a StatefulSet identity handoff;
      * ``wants_cutoff``     — harnesses should provision a
        CutoffController (consulted via ``ctx.cutoff``).
    """

    name: str = "?"                 # set by @register_strategy
    handles_identity: bool = False
    wants_cutoff: bool = False

    def run(self, ctx: MigrationContext) -> Generator:
        raise NotImplementedError
        yield  # pragma: no cover
