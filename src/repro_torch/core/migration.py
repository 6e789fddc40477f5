"""The Migration Manager: a thin orchestration core over the strategy
registry (see ``repro_torch.core.strategy`` / ``repro_torch.core.strategies``).

The manager resolves a strategy name through the registry, builds a
``MigrationContext`` (control-plane handles + ``MigrationPolicy`` + the
``MigrationReport`` under construction) and runs the strategy's phase
pipeline as a sim process.  It knows nothing about individual schemes:
adding a scenario means registering a ``MigrationStrategy`` class, not
editing this file.

Configuration is one declarative ``MigrationPolicy`` value; the legacy
constructor knobs (``precopy=``, ``batched_replay=``, ...) are still
accepted and folded into a policy, so pre-registry call sites keep
working unchanged.

Migrations subscribe to pod ``on_processed`` events via removable
listeners and deregister them on completion, so repeated migrations of
the same lineage (what the ClusterMigrationOrchestrator does) never fire
stale sync checks against deleted pods.
"""
from __future__ import annotations

from typing import Any, Callable, Generator, List, Optional

from repro_torch.cluster.cluster import APIServer, Pod
from repro_torch.cluster.sim import Condition, Interrupt
from repro_torch.core.cutoff import CutoffController
from repro_torch.core.policy import MigrationEvent, MigrationPolicy, MigrationReport  # noqa: F401  (re-export)
from repro_torch.core.strategy import (
    MigrationContext,
    MigrationError,
    drain_condition,
    get_strategy,
    listen,
    sync_condition,
    unlisten_all,
)
from repro_torch.core import strategies as _builtin_strategies  # noqa: F401  (registers the built-ins)


class MigrationManager:
    """The paper's Migration Manager: deployed 'on the master node', talks
    to the API server only."""

    def __init__(self, api: APIServer, make_worker: Callable[[], Any],
                 primary_queue: str,
                 cutoff: Optional[CutoffController] = None,
                 policy: Optional[MigrationPolicy] = None,
                 # legacy knobs, folded into the policy (None = unset):
                 batched_replay: Optional[bool] = None,
                 replay_speedup: Optional[float] = None,
                 precopy: Optional[bool] = None,
                 precopy_max_rounds: Optional[int] = None,
                 precopy_converge_ratio: Optional[float] = None,
                 precopy_min_dirty: Optional[int] = None):
        self.api = api
        self.sim = api.sim
        self.broker = api.broker
        self.make_worker = make_worker
        self.primary_queue = primary_queue
        self.cutoff = cutoff
        self.policy = MigrationPolicy.resolve(
            policy,
            batched_replay=batched_replay,
            replay_speedup=replay_speedup,
            precopy=precopy,
            precopy_max_rounds=precopy_max_rounds,
            precopy_converge_ratio=precopy_converge_ratio,
            precopy_min_dirty=precopy_min_dirty,
        )
        self._n = 0

    # -- legacy attribute views (pre-policy call sites read these) -----------
    @property
    def batched_replay(self) -> bool:
        return self.policy.batched_replay

    @property
    def replay_speedup(self) -> float:
        return self.policy.replay_speedup

    @property
    def precopy(self) -> bool:
        return self.policy.precopy

    @property
    def precopy_max_rounds(self) -> int:
        return self.policy.precopy_max_rounds

    # ---------------------------------------------------------------------
    def migration(self, strategy: str, source: Pod, target_node: str,
                  statefulset_identity: Optional[str] = None,
                  policy: Optional[MigrationPolicy] = None) -> Generator:
        """Validate and build one migration as a raw sim generator.

        Callers that need failure isolation (the fleet orchestrator) drive
        this inside their own guarded process; everyone else uses
        ``migrate``.  Validation errors raise here, synchronously.

        Any failure inside the strategy body (an aborted transfer, a dead
        target node, a strategy bug) runs ``MigrationContext.rollback``
        — source serving again, mirror torn down, target remnants and
        half-pushed images gone — and re-raises as ``MigrationError``
        carrying the context, so a failed attempt is a no-op for the
        workload and the retry loop can pick up the restored source.
        """
        cls = get_strategy(strategy)
        if statefulset_identity is not None and not cls.handles_identity:
            # every other strategy deletes the source without releasing the
            # identity, which would leave it claimed by a dead pod forever
            raise ValueError(
                f"strategy {strategy!r} cannot hand off StatefulSet identity "
                f"{statefulset_identity!r}; use 'ms2m_statefulset'")
        # capture the migration number NOW: the generator body runs later,
        # and two concurrent migrations on the same queue would otherwise
        # both read the post-increment _n and attach the same secondary
        self._n += 1
        ctx = MigrationContext(self, source, target_node,
                               statefulset_identity,
                               policy or self.policy, strategy, self._n)
        return self._run_rolled_back(cls, ctx)

    @staticmethod
    def _run_rolled_back(cls, ctx: MigrationContext) -> Generator:
        try:
            result = yield from cls().run(ctx)
            return result
        except Interrupt:
            # kernel control flow (Interrupt subclasses Exception, so the
            # broad handler below would swallow it): the interrupter owns
            # recovery, not the rollback path [SIM001]
            raise
        except Exception as exc:  # noqa: BLE001 — every failure rolls back
            try:
                yield from ctx.rollback(exc)
            except Interrupt:
                raise  # never eat a kernel interrupt mid-rollback [SIM001]
            except Exception as rexc:  # noqa: BLE001
                # rollback itself failed (e.g. the source node died too);
                # surface the original failure, keep the rollback error
                ctx.rollback_error = rexc
            raise MigrationError(ctx, exc) from exc

    def migrate(self, strategy: str, source: Pod, target_node: str,
                statefulset_identity: Optional[str] = None,
                policy: Optional[MigrationPolicy] = None) -> Condition:
        gen = self.migration(strategy, source, target_node,
                             statefulset_identity=statefulset_identity,
                             policy=policy)
        return self.sim.process(
            gen, name=f"migration:{strategy}:{self.primary_queue}:{self._n}")

    # -- condition helpers (kept as methods: tests and external tooling use
    # them against a bare manager; strategies reach them via the context) ----
    def _listen(self, pod: Pod, fn: Callable, subs: List) -> None:
        listen(pod, fn, subs)

    @staticmethod
    def _unlisten_all(subs: List) -> None:
        unlisten_all(subs)

    def _sync_condition(self, target_pod: Pod, source_pod: Pod,
                        secondary, subs: List) -> Condition:
        return sync_condition(self.sim, target_pod, source_pod, secondary,
                              subs)

    def _drain_condition(self, target_pod: Pod, up_to_id: int,
                         secondary, subs: List) -> Condition:
        return drain_condition(self.sim, target_pod, up_to_id, secondary,
                               subs)

    def _switch_to_primary(self, target_pod: Pod, secondary_name: str):
        self.broker.detach_secondary(self.primary_queue, secondary_name)
        target_pod.queue = self.broker.queues[self.primary_queue]
        target_pod.wake()  # unblock if it was waiting on the secondary

    def _detach_if_mirrored(self, secondary_name: str):
        if self.broker.is_mirrored(self.primary_queue, secondary_name):
            self.broker.detach_secondary(self.primary_queue, secondary_name)
