"""Zero-downtime serving migration: KV-cache handoff with a dual-serving
window and exactly-once request completion.

Port of ``repro.serving.handoff``: the same control plane, ledger and
hash worker; the engine worker runs the port's model on ``device`` (the
decode-attention kernel on a card), and its checkpoint rounds go through
the fused codec kernels when ``--compression`` asks for a codec.

The paper's migration machinery moves *fold* workers (trainer/consumer
pods) and reports control-plane downtime.  For a serving engine the right
metric is different — SHADOW's observation: what a user perceives is the
*latency* of their in-flight request, so the goal is a handoff in which
no request is ever lost, duplicated, or parked behind a stopped replica.
This module wires the slot-based serving engine into that machinery:

* **Stateful payload** — the engine's per-slot KV-cache lanes *plus* the
  admitted-request log (``serving/engine.py:state_tree``), pre-copied
  over the existing delta/codec wire path.  ``slot_aligned_chunk_bytes``
  picks the registry chunk grid so chunk boundaries never straddle a
  decode lane: a precopy round's fingerprint diff then ships only the
  lanes that actually decoded since the previous round.
* **Dual-serving window** — the ``serving_handoff`` strategy keeps the
  source decoding while the target restores and replays the mirrored
  admission log (standard MS2M catch-up); for a window both replicas are
  decoding the same requests.
* **Exactly-once completion** — both replicas finishing the same request
  is resolved by the :class:`CompletionLedger`: completions are keyed by
  request id and the first one wins; replayed finishes are counted as
  suppressed duplicates, never double-delivered.  Un-admitted queue
  entries re-route to the target through the ordinary queue switch +
  id-dedup path, and a mid-handoff fault rolls back to the still-serving
  source (the rollback machinery) with the ledger again deduping whatever the
  dead target already finished.
* **Latency tracing** — the ledger records per-request submit/complete
  times; :func:`run_serving_experiment` drives an open-loop Poisson
  request stream and reports p50/p99/p999 (``repro_torch.analysis.stats``),
  the headline metric of ``benchmarks/serving_handoff.py``.

The strategy registers itself here and is imported for its side effect at
the bottom of ``core/strategies.py`` — zero edits to the manager core, as
the registry demands.  This module deliberately imports only
``repro_torch.core.strategy`` (the registry layer); the experiment harness
imports the manager lazily.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np

from repro_torch.core.strategy import (
    LiveSyncCatchup,
    MigrationContext,
    MigrationStrategy,
    register_strategy,
)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import leaves


# ---------------------------------------------------------------------------
# Exactly-once completion ledger
# ---------------------------------------------------------------------------

class CompletionLedger:
    """Request-id-keyed completion dedup: at-least-once processing plus
    first-completion-wins delivery equals exactly-once delivery.

    During the dual-serving window (and after a rollback) two replicas
    may legitimately finish the same request; the ledger delivers the
    first finish, suppresses and *counts* every replay, and records
    per-request submit→complete latency for the tail metrics.  The
    exactly-once audit is structural: every submitted id delivered
    (zero lost), the delivered set keyed by id (zero duplicates)."""

    def __init__(self, sim):
        self.sim = sim
        self.submitted: Dict[int, float] = {}          # rid -> t_submit
        self.delivered: Dict[int, Dict[str, Any]] = {}  # rid -> record
        self.duplicates: List[Tuple[int, float, str]] = []

    def submit(self, rid: int) -> None:
        self.submitted[int(rid)] = self.sim.now

    def complete(self, rid: int, by: str = "",
                 tokens: Optional[int] = None) -> bool:
        """Record a finish; returns True iff this was the first one."""
        rid = int(rid)
        if rid in self.delivered:
            self.duplicates.append((rid, self.sim.now, by))
            return False
        t0 = self.submitted.get(rid, 0.0)
        self.delivered[rid] = {"t_submit": t0, "t_complete": self.sim.now,
                               "latency": self.sim.now - t0, "by": by,
                               "n_tokens": tokens}
        return True

    def pending(self) -> List[int]:
        return sorted(set(self.submitted) - set(self.delivered))

    def latencies(self) -> List[float]:
        return [self.delivered[r]["latency"] for r in sorted(self.delivered)]

    @property
    def exactly_once(self) -> bool:
        return (not self.pending()
                and set(self.delivered) <= set(self.submitted))


# ---------------------------------------------------------------------------
# Serving workers (MS2M worker protocol over decode slots)
# ---------------------------------------------------------------------------

class HashServingWorker:
    """Slot-based serving worker without a model: each decode slot is a lane
    of uint64 hash state, each decode round mixes one "token" into every
    active lane, and a request occupies its slot across *messages* (its
    decode budget outlives the admission message) — so a checkpoint
    genuinely carries in-flight requests, exactly what the handoff must
    preserve.  Bit-exact, order-sensitive, cheap: the wide-sweep analogue
    of :class:`~repro_torch.serving.engine.ServingEngine`.

    A message admits one request: wait (synchronously decoding) for a
    free slot, fold the prompt into the lane, then run one decode round.
    Completions go to the shared :class:`CompletionLedger` (a reference
    fold passes ``ledger=None`` and just drops them)."""

    FNV = np.uint64(1099511628211)

    def __init__(self, num_slots: int = 8, lane_words: int = 4096,
                 ledger: Optional[CompletionLedger] = None,
                 name: str = "serving"):
        self.num_slots = num_slots
        self.lane_words = lane_words
        self.ledger = ledger
        self.name = name
        self.lanes = np.zeros((num_slots, lane_words), np.uint64)
        self.slot_req = np.full(num_slots, -1, np.int64)
        self.slot_pos = np.zeros(num_slots, np.int64)
        self.slot_budget = np.zeros(num_slots, np.int64)
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1

    # -- decode ---------------------------------------------------------------
    def _round(self) -> None:
        """One decode round: every active lane mixes one token (ascending
        slot order — deterministic), budgets tick down, exhausted slots
        complete."""
        with np.errstate(over="ignore"):
            for s in np.flatnonzero(self.slot_req >= 0):
                s = int(s)
                pos = int(self.slot_pos[s])
                x = self.lanes[s, pos % self.lane_words]
                mixed = np.uint64(
                    (x ^ np.uint64(self.slot_req[s] + pos + 1)) * self.FNV)
                self.lanes[s, (pos + 1) % self.lane_words] ^= mixed
                self.slot_pos[s] = pos + 1
                self.slot_budget[s] -= 1
                if self.slot_budget[s] <= 0:
                    self._complete(s)

    def _complete(self, s: int) -> None:
        rid = int(self.slot_req[s])
        tokens = int(self.slot_pos[s])
        self.slot_req[s] = -1
        self.slot_pos[s] = 0
        self.slot_budget[s] = 0
        if self.ledger is not None:
            self.ledger.complete(rid, by=self.name, tokens=tokens)

    # -- MS2M worker API ------------------------------------------------------
    def process(self, msg) -> None:
        p = msg.payload
        rid = int(p.get("request_id", msg.msg_id))
        prompt = list(p.get("prompt", [p.get("token", 0)]))
        budget = max(1, int(p.get("max_new_tokens", 8)))
        while True:
            idle = np.flatnonzero(self.slot_req < 0)
            if idle.size:
                s = int(idle[0])
                break
            self._round()  # no free slot: decode until one completes
        with np.errstate(over="ignore"):
            acc = np.uint64(1469598103934665603)
            for tok in prompt:
                acc = np.uint64((acc ^ np.uint64(tok)) * self.FNV)
            self.lanes[s, 0] ^= acc ^ np.uint64(rid + 1)
        self.slot_req[s] = rid
        self.slot_pos[s] = 0
        self.slot_budget[s] = budget
        self._round()
        self.last_msg_id = msg.msg_id
        self.n_processed += 1

    def state_tree(self):
        return {"lanes": self.lanes.copy(),
                "slots": {"request": self.slot_req.copy(),
                          "position": self.slot_pos.copy(),
                          "budget": self.slot_budget.copy()},
                "scalars": {"last_msg_id": np.int64(self.last_msg_id),
                            "n_processed": np.int64(self.n_processed)}}

    def load_state(self, tree) -> None:
        self.lanes = np.asarray(tree["lanes"]).copy()
        self.slot_req = np.asarray(tree["slots"]["request"]).copy()
        self.slot_pos = np.asarray(tree["slots"]["position"]).copy()
        self.slot_budget = np.asarray(tree["slots"]["budget"]).copy()
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])

    def state_equal(self, other, exact: bool = True) -> bool:
        return bool(np.array_equal(self.lanes, other.lanes)
                    and np.array_equal(self.slot_req, other.slot_req)
                    and np.array_equal(self.slot_pos, other.slot_pos)
                    and np.array_equal(self.slot_budget, other.slot_budget)
                    and self.last_msg_id == other.last_msg_id)

    # -- handoff telemetry ----------------------------------------------------
    def slot_table(self) -> List[Dict[str, int]]:
        return [{"slot": int(s), "request_id": int(self.slot_req[s]),
                 "position": int(self.slot_pos[s]),
                 "budget": int(self.slot_budget[s])}
                for s in np.flatnonzero(self.slot_req >= 0)]

    def slot_lane_nbytes(self) -> int:
        return self.lane_words * 8

    def flush(self, max_rounds: int = 100000) -> int:
        """Decode until every admitted request completes (end-of-run
        drain of leftover in-flight slots).  Returns rounds run."""
        n = 0
        while (self.slot_req >= 0).any():
            if n >= max_rounds:
                raise RuntimeError(f"{self.name}: flush did not converge")
            self._round()
            n += 1
        return n


class ServingWorker:
    """MS2M worker adapter around the real :class:`ServingEngine`.

    ``decode_rounds=None`` keeps the engine's legacy semantics (one
    message = admission + full generation, nothing in flight between
    messages).  With ``decode_rounds=k`` the adapter streams instead:
    each message admits its request (draining the waiting queue, so a
    checkpoint never sees an un-snapshottable admission backlog) and
    then runs only ``k`` batched decode rounds — generation spans
    messages and checkpoints genuinely carry mid-generation slots.
    Completions drain into the shared ledger (or stay on the engine when
    ``ledger=None`` — the reference-fold configuration)."""

    def __init__(self, engine: ServingEngine,
                 ledger: Optional[CompletionLedger] = None,
                 decode_rounds: Optional[int] = None):
        self.engine = engine
        self.ledger = ledger
        self.decode_rounds = decode_rounds

    # -- MS2M worker API ------------------------------------------------------
    def process(self, msg) -> None:
        eng = self.engine
        if self.decode_rounds is None:
            eng.process(msg)
        else:
            p = msg.payload
            req = Request(int(p.get("request_id", msg.msg_id)),
                          list(p.get("prompt", [p.get("token", 0)])),
                          int(p.get("max_new_tokens", 8)))
            eng.submit(req)
            while eng.waiting:  # admission backlog is not checkpointable
                eng._engine_step()
            for _ in range(self.decode_rounds):
                if eng.active.any():
                    eng._engine_step()
            eng.last_msg_id = msg.msg_id
            eng.n_processed += 1
        self._drain_completions()

    def _drain_completions(self) -> None:
        if self.ledger is None:
            return  # reference folds keep engine.completions untouched
        while self.engine.completions:
            c = self.engine.completions.pop(0)
            self.ledger.complete(c.request_id, by=self.engine.name,
                                 tokens=len(c.tokens))

    def state_tree(self):
        return self.engine.state_tree()

    def load_state(self, tree) -> None:
        self.engine.load_state(tree)

    def state_equal(self, other, exact: bool = True) -> bool:
        eng = other.engine if isinstance(other, ServingWorker) else other
        return self.engine.state_equal(eng, exact=exact)

    @property
    def name(self) -> str:
        return self.engine.name

    @property
    def last_msg_id(self) -> int:
        return self.engine.last_msg_id

    @last_msg_id.setter
    def last_msg_id(self, v: int) -> None:
        self.engine.last_msg_id = v

    @property
    def n_processed(self) -> int:
        return self.engine.n_processed

    @property
    def skip_until(self) -> int:
        return self.engine.skip_until

    @skip_until.setter
    def skip_until(self, v: int) -> None:
        self.engine.skip_until = v

    # -- handoff telemetry ----------------------------------------------------
    def slot_table(self) -> List[Dict[str, int]]:
        return self.engine.slot_table()

    def slot_lane_nbytes(self) -> int:
        g = 0
        for leaf in leaves(self.engine.cache):
            g = math.gcd(g, leaf.numel() * leaf.element_size()
                         // self.engine.num_slots)
        return g

    def flush(self, max_rounds: int = 100000) -> int:
        n = 0
        eng = self.engine
        while eng.active.any() or eng.waiting:
            if n >= max_rounds:
                raise RuntimeError(f"{eng.name}: flush did not converge")
            eng._engine_step()
            n += 1
        self._drain_completions()
        return n


def slot_aligned_chunk_bytes(worker) -> int:
    """Registry chunk size aligned to the worker's decode lanes: chunk
    boundaries coincide with per-slot KV-lane boundaries, so a delta
    round's fingerprint diff ships exactly the lanes that decoded since
    the previous round — never a clean lane dragged along by a straddling
    chunk."""
    n = int(worker.slot_lane_nbytes())
    if n <= 0:
        raise ValueError(f"worker {worker!r} reports no per-slot state")
    return n


# ---------------------------------------------------------------------------
# The registered strategy
# ---------------------------------------------------------------------------

@register_strategy("serving_handoff")
class ServingHandoff(MigrationStrategy):
    """Serving handoff (beyond paper, SHADOW-style): KV-cache lanes + the
    admitted-request log pre-copy in per-slot-aligned delta chunks while
    BOTH replicas decode (dual-serving window); at cutover, in-flight
    requests hand off per decode slot and a completion ledger dedupes
    replayed finishes — exactly-once completion, tail latency (not
    downtime) as the headline metric.

    The pipeline is the live MS2M shape with pre-copy always on, plus the
    serving-specific telemetry: ``dual_serving_begin`` when the target
    starts decoding alongside the source, ``slot_handoff`` with the
    source's final in-flight slot table at the pause instant.  The source
    pause returns its mid-service admission to the queue front; the
    mirror already holds a copy, and the pod-loop id-dedup plus the
    ledger's first-completion-wins rule make whichever path delivers
    first exactly-once.  Any mid-handoff fault takes the ordinary
    rollback path: the source keeps serving and the ledger suppresses
    whatever the dead target already finished.
    """

    def run(self, ctx: MigrationContext) -> Generator:
        t = ctx.api.timings
        rep = ctx.report
        disc = LiveSyncCatchup()
        sec = ctx.attach_secondary()
        try:
            # per-slot-aligned delta pre-copy: only dirty decode lanes
            # ship per round (chunk grid set by the harness)
            push = yield from ctx.transfer(
                True,
                f"{ctx.primary_queue}-srv-pre{ctx.n}",
                f"{ctx.primary_queue}-srv{ctx.n}")

            target = yield from ctx.restore_target(push, sec, replay=True)

            # -- dual-serving window: both replicas decode ------------------
            t0 = ctx.sim.now
            base_processed = target.worker.n_processed
            ctx.emit("dual_serving_begin", target=target.name,
                     checkpoint_marker=rep.checkpoint_marker)
            target.start()
            yield from disc.catchup(ctx, target)
            ctx.phase("message_replay", t0)

            # -- cutover: per-slot in-flight handoff ------------------------
            t0 = ctx.sim.now
            down0 = disc.begin_cutover(ctx)  # pause: in-flight admission
            #                                  requeues to the primary front
            slot_probe = getattr(ctx.source.worker, "slot_table", None)
            slots = slot_probe() if callable(slot_probe) else []
            ctx.emit("slot_handoff", slots=slots, n_active=len(slots))
            yield t.cutover_coord_s
            yield from ctx.wait(
                ctx.drain_condition(target, ctx.source.worker.last_msg_id))
            ctx.switch_to_primary(target)
            target.processing_ms = ctx.source.processing_ms
            yield t.route_switch_s
            rep.downtime = ctx.sim.now - down0
            ctx.phase("cutover", t0)
            ctx.emit("dual_serving_end", duration=ctx.sim.now - down0)

            yield from ctx.teardown_source()

            rep.replayed_messages = target.worker.n_processed - base_processed
            ctx.finish(target)
            return rep, target
        finally:
            ctx.cleanup()


# ---------------------------------------------------------------------------
# Experiment harness: open-loop Poisson requests + latency tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingResult:
    strategy: str
    rate: float
    report: Optional[Any]            # MigrationReport | None (failed run)
    failed: bool
    failure: Optional[Dict[str, Any]]
    published: int
    delivered: int
    duplicates: int                  # suppressed replayed finishes
    lost: int                        # submitted but never delivered
    exactly_once: bool
    state_verified: Optional[bool]
    latencies: List[float]
    flushed_rounds: int
    downtime: float
    migration_time: float
    listeners_left: int              # pod on_processed listeners at end
    mirrors_left: int                # mirrors still attached to the primary

    def latency(self) -> Dict[str, Any]:
        from repro_torch.analysis.stats import latency_summary
        return latency_summary(self.latencies)

    def row(self) -> Dict[str, Any]:
        row = {
            "strategy": self.strategy,
            "rate": self.rate,
            "failed": self.failed,
            "published": self.published,
            "delivered": self.delivered,
            "duplicates": self.duplicates,
            "lost": self.lost,
            "exactly_once": self.exactly_once,
            "state_verified": self.state_verified,
            "downtime": round(self.downtime, 3),
            "migration_time": round(self.migration_time, 3),
            "latency": self.latency(),
        }
        if self.failed and self.failure is not None:
            row.update({k: self.failure.get(k)
                        for k in ("error", "attempts", "rolled_back",
                                  "source_serving")})
        return row


def serving_reference_fold(make_ref, payloads: List[Dict[str, Any]],
                           upto: int):
    """Correctness oracle: a fresh (ledger-less) serving worker replays
    the published request log 0..upto; its state must equal the live
    worker bit-exactly (ids reassigned 0..upto, matching the broker's
    per-queue monotonic ids)."""
    from repro_torch.broker.broker import Message

    ref = make_ref()
    for i, payload in enumerate(payloads[: upto + 1]):
        ref.process(Message(i, payload, 0.0))
    return ref


def run_serving_experiment(
    strategy: str = "serving_handoff",
    request_rate: float = 8.0,
    *,
    registry_root: str,
    processing_ms: float = 50.0,
    t_migrate: float = 10.0,
    settle_time: float = 5.0,
    seed: int = 0,
    worker: str = "hash",            # "hash" | "engine"
    num_slots: int = 8,
    lane_words: int = 4096,
    decode_rounds: Optional[int] = 1,
    max_seq: int = 128,
    prompt_tokens: Tuple[int, int] = (1, 4),
    max_new_tokens: Tuple[int, int] = (2, 12),
    burst_factor: float = 1.0,
    burst_every: int = 0,
    burst_len: int = 0,
    timings=None,
    topology=None,
    num_nodes: int = 3,
    faults=None,
    allow_failure: bool = False,
    policy=None,
    chunk_bytes: Optional[int] = None,
    verify: bool = True,
    sanitize: Optional[bool] = None,
    tiebreak_seed: Optional[int] = None,
    device="cuda",
) -> ServingResult:
    """One serving migration under an open-loop Poisson request stream.

    Mirrors ``run_migration_experiment``'s shape (boot → migrate at
    ``t_migrate`` → settle → drain), but the workload is a stream of
    generation *requests* (request id = broker message id), the worker is
    a slot-based serving worker sharing one :class:`CompletionLedger`,
    and the result carries per-request latencies plus the exactly-once
    audit.  State verification runs BEFORE the end-of-run flush (the
    reference fold replays admissions only, not the final drain).
    ``device`` holds the engine worker's weights and caches (the hash
    worker has no device state)."""
    # lazy: the manager/orchestrator sit above this module in the import
    # graph (core.strategies imports us for strategy registration)
    from repro_torch.cluster.cluster import Cluster, TimingConstants
    from repro_torch.core.migration import MigrationManager
    from repro_torch.core.policy import MigrationPolicy
    from repro_torch.core.strategy import get_strategy
    from repro_torch.core.workload import open_loop_gaps, request_stream

    if worker not in ("hash", "engine"):
        raise ValueError(f"worker must be 'hash' or 'engine' (got {worker!r})")
    pol = MigrationPolicy.resolve(policy)
    timings = timings or TimingConstants()
    timings = dataclasses.replace(timings, processing_ms=processing_ms)
    if num_nodes < 2:
        raise ValueError("run_serving_experiment needs num_nodes >= 2")

    # -- worker factories (live workers share the ledger; refs do not) ------
    engine_cfg = engine_params = None
    if worker == "engine":
        from repro_torch import configs
        from repro_torch.models import transformer as T

        engine_cfg = configs.get_config("paper_consumer")
        engine_params = T.init_lm(engine_cfg, seed=0, device=device)

    def build(ledger, name: str):
        if worker == "hash":
            return HashServingWorker(num_slots=num_slots,
                                     lane_words=lane_words,
                                     ledger=ledger, name=name)
        eng = ServingEngine(engine_cfg, engine_params, num_slots=num_slots,
                            max_seq=max_seq, name=name)
        return ServingWorker(eng, ledger=ledger, decode_rounds=decode_rounds)

    if chunk_bytes is None:
        chunk_bytes = slot_aligned_chunk_bytes(build(None, "probe"))

    cluster = Cluster(registry_root, timings=timings, num_nodes=num_nodes,
                      chunk_bytes=chunk_bytes, topology=topology,
                      faults=faults, sanitize=sanitize,
                      tiebreak_seed=tiebreak_seed)
    sim, api, broker = cluster.sim, cluster.api, cluster.broker
    primary = broker.declare_queue("requests")
    ledger = CompletionLedger(sim)
    counter = itertools.count()

    def make_worker():
        return build(ledger, f"serving-{next(counter)}")

    def make_ref():
        return build(None, "reference")

    # -- open-loop request producer -----------------------------------------
    rng = np.random.default_rng(seed)
    gaps = open_loop_gaps(rng, request_rate, burst_factor=burst_factor,
                          burst_every=burst_every, burst_len=burst_len)
    reqs = request_stream(rng, prompt_tokens=prompt_tokens,
                          max_new_tokens=max_new_tokens)
    published: List[Dict[str, Any]] = []
    stop_producing = {"flag": False}

    def producer():
        while not stop_producing["flag"]:
            yield next(gaps)
            payload = next(reqs)
            msg = broker.publish("requests", payload)
            ledger.submit(msg.msg_id)
            published.append(payload)

    sim.process(producer(), name="producer")

    # -- source pod -----------------------------------------------------------
    source_worker = make_worker()
    holder: dict = {}

    def boot():
        pod = yield from api.create_pod("serving-0", "node0", source_worker,
                                        primary)
        pod.start()
        holder["pod"] = pod

    sim.process(boot(), name="boot")
    sim.run(until=t_migrate)
    source = holder["pod"]

    cutoff = None
    if get_strategy(strategy).wants_cutoff:
        from repro_torch.core.cutoff import CutoffController

        cutoff = CutoffController(t_replay_max=pol.t_replay_max,
                                  mu_fallback=1000.0 / processing_ms,
                                  lam_fallback=request_rate)

    # -- migration: direct manager when fault-free single-attempt, else the
    # orchestrator's guarded retry loop (identical to run_migration_experiment)
    use_guard = faults is not None or pol.max_attempts > 1 or allow_failure
    report = None
    target = None
    failed = False
    failure: Optional[Dict[str, Any]] = None
    if not use_guard:
        mgr = MigrationManager(api, make_worker, "requests", cutoff=cutoff,
                               policy=pol)
        done = mgr.migrate(strategy, source, "node1")
        sim.run(stop_when=done)
        report, target = done.value
    else:
        from repro_torch.core.orchestrator import (ClusterMigrationOrchestrator,
                                             PodMigrationSpec)

        orch = ClusterMigrationOrchestrator(
            api, make_worker, max_concurrent=1,
            cutoff_factory=(lambda: cutoff) if cutoff is not None else None,
            policy=pol)
        done = orch.migrate_fleet([PodMigrationSpec(
            pod=source, queue="requests", target_node="node1",
            strategy=strategy)])
        sim.run(stop_when=done)
        fleet = done.value
        if fleet.failures:
            failure = dict(fleet.failures[0])
            failed = True
            if not allow_failure:
                raise RuntimeError(
                    f"serving migration failed after "
                    f"{failure['attempts']} attempt(s): {failure['error']}")
        else:
            report, target = fleet.reports[0], fleet.targets[0]

    # -- settle, stop the producer, drain the backlog -------------------------
    sim.run(until=sim.now + settle_time)
    stop_producing["flag"] = True
    sim.run(until=sim.now + 2.0)

    if target is not None:
        live_pod = target
    else:  # failed run: rollback restored the source (possibly re-created)
        live_pod = api.pods.get((failure or {}).get("source_pod")
                                or source.name)
    # bounded host-level drain (not a sim process): advance the clock until
    # the primary queue is empty and nothing is mid-service
    for _ in range(1000):
        if primary.depth() == 0 and (live_pod is None or not live_pod.busy):
            break
        sim.run(until=sim.now + 1.0)

    # -- verification (BEFORE flush), then drain in-flight slots --------------
    state_verified: Optional[bool] = None
    flushed = 0
    if live_pod is not None:
        if verify:
            ref = serving_reference_fold(make_ref, published,
                                         live_pod.worker.last_msg_id)
            state_verified = bool(ref.state_equal(live_pod.worker))
            if report is not None:
                report.state_verified = state_verified
            if failure is not None:
                failure["source_verified"] = state_verified
        flushed = live_pod.worker.flush()
    if failure is not None:
        src = live_pod
        failure["source_serving"] = bool(
            src is not None and not src.deleted and src.node.alive
            and src.serving)

    listeners_left = sum(len(p.on_processed_listeners)
                         for p in api.pods.values())
    mirrors_left = len(broker._mirrors.get("requests", []))

    return ServingResult(
        strategy=strategy,
        rate=request_rate,
        report=report,
        failed=failed,
        failure=failure,
        published=len(published),
        delivered=len(ledger.delivered),
        duplicates=len(ledger.duplicates),
        lost=len(ledger.pending()),
        exactly_once=ledger.exactly_once,
        state_verified=state_verified,
        latencies=ledger.latencies(),
        flushed_rounds=flushed,
        downtime=report.downtime if report is not None else 0.0,
        migration_time=report.migration_time if report is not None else 0.0,
        listeners_left=listeners_left,
        mirrors_left=mirrors_left,
    )
