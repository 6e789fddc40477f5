"""End-to-end migration experiment harness (used by benchmarks, tests and
examples).

One experiment = paper evaluation §IV-B:
  producer --Poisson(λ)--> primary queue --> consumer pod (μ = 1/processing)
  at t_migrate the MigrationManager runs one strategy; we record the
  MigrationReport, then *verify* the migrated state: an independent
  reference consumer folds the full message log 0..last_msg_id from scratch
  and must match the target bit-exactly (allclose for batched replay).

Migration behaviour is configured with one declarative ``MigrationPolicy``;
the legacy ``batched_replay=`` / ``replay_speedup=`` / ``precopy=`` /
``manager_kwargs=`` knobs are still accepted and folded into the policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.cluster.cluster import Cluster, TimingConstants
from repro_torch.core.consumer import StatefulConsumer
from repro_torch.core.cutoff import CutoffController
from repro_torch.core.migration import MigrationManager, MigrationReport
from repro_torch.core.policy import MigrationPolicy
from repro_torch import configs


def open_loop_gaps(rng: np.random.Generator, rate: float, *,
                   burst_factor: float = 1.0, burst_every: int = 0,
                   burst_len: int = 0) -> Iterator[float]:
    """Seeded open-loop inter-arrival generator (virtual seconds).

    The default path draws ``rng.exponential(1.0 / rate)`` per arrival —
    the exact call sequence the experiment producers always made, so
    refactoring them onto this generator is bit-identical for every
    existing seed.  ``burst_every``/``burst_len``/``burst_factor`` add a
    deterministic count-based burst pattern: within every window of
    ``burst_every`` arrivals, the first ``burst_len`` draw at
    ``rate * burst_factor`` (a flash crowd), the rest at ``rate``.
    Open-loop means arrivals never wait on service — queueing delay shows
    up in the latency tail instead of being hidden by backpressure.
    """
    if rate <= 0.0:
        raise ValueError(f"open_loop_gaps needs rate > 0 (got {rate})")
    if burst_every and not 0 < burst_len <= burst_every:
        raise ValueError("need 0 < burst_len <= burst_every for bursts")
    n = 0
    while True:
        r = rate
        if burst_every and (n % burst_every) < burst_len:
            r = rate * burst_factor
        yield float(rng.exponential(1.0 / r))
        n += 1


def modulated_open_loop_gaps(rng: np.random.Generator, rate: float,
                             rate_of_t: Callable[[float], float], *,
                             t0: float = 0.0) -> Iterator[float]:
    """Time-modulated open-loop arrivals: each gap is drawn at the
    instantaneous rate ``rate * rate_of_t(t)`` evaluated at the current
    cumulative arrival time (a stepwise-constant approximation of an
    inhomogeneous Poisson process).  Exactly one ``rng.exponential`` call
    per arrival, same as ``open_loop_gaps`` — the draw *count* is
    schedule-independent, so seeded comparisons across schedules stay
    aligned.  ``rate_of_t`` must be a pure function of time (determinism:
    the reference fold re-walks the same arrival sequence)."""
    if rate <= 0.0:
        raise ValueError(f"modulated_open_loop_gaps needs rate > 0 "
                         f"(got {rate})")
    t = t0
    while True:
        r = max(rate * float(rate_of_t(t)), 1e-9)
        gap = float(rng.exponential(1.0 / r))
        t += gap
        yield gap


def diurnal_rate(period_s: float = 120.0, depth: float = 0.5,
                 phase_s: float = 0.0) -> Callable[[float], float]:
    """Sinusoidal day/night modulation factor: ``1 + depth*sin(...)``
    with the given period.  ``depth`` < 1 keeps the rate positive."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"diurnal depth must be in [0, 1) (got {depth})")
    two_pi = 2.0 * math.pi

    def factor(t: float) -> float:
        return 1.0 + depth * math.sin(two_pi * (t + phase_s) / period_s)

    return factor


def flash_crowd_rate(at_s: float = 30.0, duration_s: float = 20.0,
                     factor: float = 4.0) -> Callable[[float], float]:
    """Step modulation: ``factor``x the base rate inside the window
    ``[at_s, at_s + duration_s)``, 1x outside (a flash crowd)."""

    def f(t: float) -> float:
        return factor if at_s <= t < at_s + duration_s else 1.0

    return f


def make_arrival_gaps(schedule: str, rng: np.random.Generator,
                      rate: float, **kwargs: Any) -> Iterator[float]:
    """Named arrival-schedule factory (the rebalance harness and CLI
    select by name):

      * ``steady``      — exactly ``open_loop_gaps`` (bit-identical to
        every existing seeded producer);
      * ``diurnal``     — ``diurnal_rate(**kwargs)`` modulation;
      * ``flash_crowd`` — ``flash_crowd_rate(**kwargs)`` modulation.
    """
    if schedule == "steady":
        return open_loop_gaps(rng, rate, **kwargs)
    if schedule == "diurnal":
        return modulated_open_loop_gaps(rng, rate, diurnal_rate(**kwargs))
    if schedule == "flash_crowd":
        return modulated_open_loop_gaps(rng, rate,
                                        flash_crowd_rate(**kwargs))
    raise ValueError(f"unknown arrival schedule {schedule!r}; "
                     "available: ['diurnal', 'flash_crowd', 'steady']")

ARRIVAL_SCHEDULES = ("steady", "diurnal", "flash_crowd")


def request_stream(rng: np.random.Generator, *,
                   prompt_tokens: Tuple[int, int] = (1, 4),
                   max_new_tokens: Tuple[int, int] = (2, 12),
                   vocab: int = 2048) -> Iterator[Dict[str, Any]]:
    """Seeded serving-request payload stream: each item is a broker
    payload ``{"prompt": [...], "max_new_tokens": m}`` with prompt length
    and decode budget drawn uniformly from the given inclusive ranges.
    The request id is assigned downstream (the broker message id), so the
    same stream drives both the live run and the reference fold."""
    lo_p, hi_p = prompt_tokens
    lo_m, hi_m = max_new_tokens
    while True:
        n_prompt = int(rng.integers(lo_p, hi_p + 1))
        prompt = [int(t) for t in rng.integers(0, vocab, size=n_prompt)]
        yield {"prompt": prompt,
               "max_new_tokens": int(rng.integers(lo_m, hi_m + 1))}


_FNV_PRIME = 1099511628211
_U64_MASK = (1 << 64) - 1


class HashConsumer:
    """Cheap drop-in for wide sweeps: state = rolling fnv-ish hash of the
    message log.  Still an exact fold (order-sensitive), so migration
    correctness remains fully checkable without model compute."""

    def __init__(self):
        self.digest = np.uint64(1469598103934665603)
        self.pos = 0
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1

    def process(self, msg):
        with np.errstate(over="ignore"):
            x = np.uint64(msg.payload["token"]) ^ np.uint64(msg.msg_id + 1)
            self.digest = np.uint64(
                (self.digest ^ x) * np.uint64(1099511628211))
        self.pos += 1
        self.last_msg_id = msg.msg_id
        self.n_processed += 1

    def process_batch(self, msgs):
        """Batched fold (fluid epochs): Python-int arithmetic masked to 64
        bits is bit-identical to the per-message np.uint64 wrapping above
        and avoids the per-call errstate context at fleet scale."""
        d = int(self.digest)
        last = self.last_msg_id
        n = 0
        for m in msgs:
            mid = m.msg_id
            d = ((d ^ (m.payload["token"] ^ (mid + 1))) * _FNV_PRIME) \
                & _U64_MASK
            last = mid
            n += 1
        self.digest = np.uint64(d)
        self.pos += n
        self.last_msg_id = last
        self.n_processed += n

    def process_pairs(self, pairs):
        """Allocation-free fluid fold over ``(msg_id, payload)`` tuples —
        the arithmetic-side drain path skips Message construction when
        nothing (log, mirror, on_publish) needs the object.  Bit-identical
        to ``process_batch``/``process``."""
        d = int(self.digest)
        last = self.last_msg_id
        n = 0
        for mid, payload in pairs:
            d = ((d ^ (payload["token"] ^ (mid + 1))) * _FNV_PRIME) \
                & _U64_MASK
            last = mid
            n += 1
        self.digest = np.uint64(d)
        self.pos += n
        self.last_msg_id = last
        self.n_processed += n

    def state_tree(self):
        return {"digest": np.uint64(self.digest),
                "scalars": {"pos": np.int64(self.pos),
                            "last_msg_id": np.int64(self.last_msg_id),
                            "n_processed": np.int64(self.n_processed)}}

    def load_state(self, tree):
        self.digest = np.uint64(tree["digest"])
        self.pos = int(tree["scalars"]["pos"])
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])

    def state_equal(self, other, exact: bool = True):
        return (self.digest == other.digest and self.pos == other.pos
                and self.last_msg_id == other.last_msg_id)


@dataclasses.dataclass
class ExperimentResult:
    report: Optional[MigrationReport]
    verified: bool
    published: int
    processed_by_target: int
    lam: float
    mu: float
    downtime: float
    migration_time: float
    # chaos runs (faults + allow_failure=True): a migration that exhausted
    # its retries has report=None and carries the rollback audit instead
    failed: bool = False
    failure: Optional[Dict[str, Any]] = None

    def row(self) -> Dict[str, Any]:
        if self.report is None:
            f = self.failure or {}
            return {
                "strategy": f.get("strategy"),
                "lam": self.lam,
                "mu": self.mu,
                "failed": True,
                "error": f.get("error"),
                "attempts": f.get("attempts"),
                "rolled_back": f.get("rolled_back"),
                "source_serving": f.get("source_serving"),
                "source_verified": f.get("source_verified"),
            }
        return {
            "strategy": self.report.strategy,
            "lam": self.lam,
            "mu": self.mu,
            "migration_time": round(self.migration_time, 3),
            "downtime": round(self.downtime, 3),
            "replayed": self.report.replayed_messages,
            "cutoff_fired": self.report.cutoff_fired,
            "verified": self.verified,
            "state_verified": self.report.state_verified,
            "attempts": self.report.attempts,
            "phases": {k: round(v, 3) for k, v in self.report.phases.items()},
            "image_written_bytes": self.report.image_written_bytes,
            "image_deduped_bytes": self.report.image_deduped_bytes,
            "image_raw_bytes": self.report.image_raw_bytes,
            "image_wire_bytes": self.report.image_wire_bytes,
            "wire_reduction": round(self.report.wire_reduction, 3),
            "compression": self.report.compression,
            "precopy_rounds": self.report.precopy_rounds,
            "precopy_round_bytes": list(self.report.precopy_round_bytes),
            "precopy_round_wire_bytes":
                list(self.report.precopy_round_wire_bytes),
            "precopy_round_dirty": list(self.report.precopy_round_dirty),
        }


def reference_fold(make_worker: Callable, tokens: List[int], upto: int):
    """Independent correctness oracle: a fresh worker folds the published
    token log 0..upto from scratch (ids reassigned 0..upto, matching the
    broker's per-queue monotonic ids)."""
    from repro_torch.broker.broker import Message

    ref = make_worker()
    for i, tok in enumerate(tokens[: upto + 1]):
        ref.process(Message(i, {"token": tok}, 0.0))
    return ref


def make_torch_worker_factory(max_seq: int = 512, device="cuda"):
    """Factory of real-model consumers on ``device`` sharing one params
    tree (weights are immutable infrastructure; only the cache state
    migrates).  Raises at once if ``device`` is CUDA and there is no card."""
    cfg = configs.get_config("paper_consumer")
    dev = resolve_device(device)
    params = None

    def make() -> StatefulConsumer:
        nonlocal params
        if params is None:
            from repro_torch.models import transformer as T
            params = T.init_lm(cfg, seed=0, device=dev)
        return StatefulConsumer(cfg, params, max_seq=max_seq)

    return make, cfg


def resolve_experiment_policy(
    policy: Optional[MigrationPolicy],
    batched_replay: Optional[bool],
    replay_speedup: Optional[float],
    precopy: Optional[bool],
    manager_kwargs: Optional[Dict[str, Any]],
) -> MigrationPolicy:
    """Legacy-knob compatibility: historically ``replay_speedup`` only took
    effect together with ``batched_replay=True`` (a measured batching
    speedup makes no sense for sequential replay), so the fold preserves
    that coupling before handing over one declarative policy."""
    base = MigrationPolicy.resolve(policy, **(manager_kwargs or {}))
    batched = (base.batched_replay if batched_replay is None
               else batched_replay)
    if replay_speedup is not None:
        replay_speedup = replay_speedup if batched else 1.0
    return MigrationPolicy.resolve(
        base, batched_replay=batched_replay, replay_speedup=replay_speedup,
        precopy=precopy)


def run_migration_experiment(
    strategy: str,
    message_rate: float,
    *,
    registry_root: str,
    processing_ms: float = 50.0,
    t_migrate: float = 10.0,
    t_replay_max: float = 45.0,
    seed: int = 0,
    timings: Optional[TimingConstants] = None,
    worker_factory: Optional[Callable] = None,
    settle_time: float = 5.0,
    verify: bool = True,
    chunk_bytes: Optional[int] = None,
    policy: Optional[MigrationPolicy] = None,
    topology=None,                   # preset name | NetworkTopology | factory
    num_nodes: int = 3,
    faults=None,                     # FaultSchedule | list of Fault/specs
    allow_failure: bool = False,     # exhausted retries => result, not raise
    # legacy knobs, folded into the policy (None = unset):
    batched_replay: Optional[bool] = None,
    replay_speedup: Optional[float] = None,
    precopy: Optional[bool] = None,
    manager_kwargs: Optional[Dict[str, Any]] = None,
) -> ExperimentResult:
    pol = resolve_experiment_policy(policy, batched_replay, replay_speedup,
                                    precopy, manager_kwargs)
    timings = timings or TimingConstants()
    timings = dataclasses.replace(timings, processing_ms=processing_ms)
    if num_nodes < 2:
        raise ValueError(
            f"run_migration_experiment needs num_nodes >= 2 (got "
            f"{num_nodes}): the migration target must be a different node")
    cluster = Cluster(registry_root, timings=timings, num_nodes=num_nodes,
                      chunk_bytes=chunk_bytes, topology=topology,
                      faults=faults)
    sim, api, broker = cluster.sim, cluster.api, cluster.broker
    primary = broker.declare_queue("orders")

    make_worker = worker_factory or (lambda: HashConsumer())
    mu = 1000.0 / processing_ms

    # -- adaptive cutoff controller (λ̂/μ̂ EWMA-estimated online) ------------
    cutoff = CutoffController(
        t_replay_max=t_replay_max, mu_fallback=mu, lam_fallback=message_rate,
        batch_speedup=pol.replay_speedup if pol.batched_replay else 1.0)

    # -- producer: Poisson(λ), deterministic --------------------------------
    # an arrival source instead of an inline producer process: draw order
    # (gap, then token — the legacy interleave), stop semantics and arrival
    # arithmetic are identical in both execution modes (docs/scaling.md)
    rng = np.random.default_rng(seed)
    gaps = open_loop_gaps(rng, message_rate)
    published: List[int] = []
    stop_producing = {"flag": False}

    def draw():
        if stop_producing["flag"]:
            return None
        gap = next(gaps)
        return gap, {"token": int(rng.integers(0, 2048))}

    def on_publish(msg):
        published.append(msg.payload["token"])
        cutoff.observe_arrival(msg.publish_time)

    primary.attach_source(draw, on_publish=on_publish)

    # -- source pod -----------------------------------------------------------
    source_worker = make_worker()
    source_holder: dict = {}

    def boot():
        pod = yield from api.create_pod("consumer-0", "node0", source_worker,
                                        primary)
        pod.on_processed = lambda p, m: cutoff.observe_service(sim.now)
        pod.start()
        source_holder["pod"] = pod

    sim.process(boot(), name="boot")
    sim.run(until=t_migrate)
    source = source_holder["pod"]

    # -- migration -------------------------------------------------------------
    # the direct manager path is kept bit-identical for fault-free
    # single-attempt runs; fault/retry runs go through the orchestrator's
    # guarded retry loop (rollback + re-placement excluding failed targets)
    use_guard = faults is not None or pol.max_attempts > 1 or allow_failure
    if not use_guard:
        mgr = MigrationManager(api, make_worker, "orders", cutoff=cutoff,
                               policy=pol)
        done = mgr.migrate(strategy, source, "node1")
        sim.run(stop_when=done)
        report, target = done.value
    else:
        from repro_torch.core.orchestrator import (ClusterMigrationOrchestrator,
                                             PodMigrationSpec)
        orch = ClusterMigrationOrchestrator(
            api, make_worker, max_concurrent=1,
            cutoff_factory=lambda: cutoff, policy=pol)
        done = orch.migrate_fleet([PodMigrationSpec(
            pod=source, queue="orders", target_node="node1",
            strategy=strategy)])
        sim.run(stop_when=done)
        fleet = done.value
        if fleet.failures:
            entry = fleet.failures[0]
            if not allow_failure:
                raise RuntimeError(f"migration failed after "
                                   f"{entry['attempts']} attempt(s): "
                                   f"{entry['error']}")
            sim.run(until=sim.now + settle_time)
            stop_producing["flag"] = True
            primary.halt_source()
            sim.run(until=sim.now + 2.0)
            primary.sync(sim.now)  # land any lazy arrivals <= end-of-run
            from repro_torch.core.orchestrator import audit_failed_spec
            src = audit_failed_spec(api, entry, make_worker, published,
                                    exact=not pol.batched_replay,
                                    verify=verify)
            return ExperimentResult(
                report=None, verified=False, published=len(published),
                processed_by_target=(src.worker.n_processed if src else 0),
                lam=message_rate, mu=mu, downtime=0.0, migration_time=0.0,
                failed=True, failure=entry)
        report, target = fleet.reports[0], fleet.targets[0]

    # -- settle + stop ----------------------------------------------------------
    sim.run(until=sim.now + settle_time)
    stop_producing["flag"] = True
    primary.halt_source()
    sim.run(until=sim.now + 2.0)
    primary.sync(sim.now)  # land any lazy arrivals / fold the target's epoch

    # -- verification: reference fold of the full log --------------------------
    verified = True
    if verify:
        ref = reference_fold(make_worker, published, target.worker.last_msg_id)
        verified = ref.state_equal(target.worker, exact=not pol.batched_replay)
        report.state_verified = bool(verified)

    return ExperimentResult(
        report=report,
        verified=verified,
        published=len(published),
        processed_by_target=target.worker.n_processed,
        lam=message_rate,
        mu=mu,
        downtime=report.downtime,
        migration_time=report.migration_time,
    )
