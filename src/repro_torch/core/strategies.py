"""The registered migration strategies (paper §III, Figs. 1-4, plus two
beyond-paper schemes), in order:

  Strategy 0  stop_and_copy     — UMS-style baseline: pause -> checkpoint ->
                                  image -> push -> pull -> restore -> switch.
                                  Downtime == the whole migration (Fig. 5).
  Strategy 1  ms2m_individual   — Fig. 2: secondary queue attached, source
                                  keeps serving; target restores from the
                                  registry image and replays the mirrored log
                                  until *synchronized*, then a short cutover.
                                  Downtime == cutover only.
  Strategy 2  ms2m_cutoff       — Fig. 3: same, plus the Threshold-Based
                                  Cutoff Mechanism: when T_accum exceeds
                                  Eq. 5's T_cutoff, the source is stopped and
                                  the remaining (bounded) log is replayed;
                                  bounded replay <= T_replay_max by
                                  construction.
  Strategy 3  ms2m_statefulset  — Fig. 4: sticky identity forces
                                  stop-before-create: checkpoint+push live,
                                  then stop source, release identity, create
                                  target, restore, replay to the *cutoff
                                  message id*, switch.
  Strategy 4  ms2m_precopy      — beyond-paper (MOSE/SHADOW-style iterative
                                  pre-copy): the IterativePrecopyTransfer
                                  engine always on, so the final replay log
                                  is bounded by ONE delta round's traffic.
                                  The same engine is a policy opt-in
                                  (``MigrationPolicy(precopy=True)``) for
                                  strategies 1-3.
  Strategy 5  ms2m_adaptive     — beyond-paper: picks strategy 1, 2 or 4 at
                                  migrate time from observed lam/mu and
                                  state-size telemetry (registry-only: the
                                  manager core is untouched).
  Strategy 6  serving_handoff   — beyond-paper (SHADOW-style): zero-downtime
                                  serving migration — KV-cache lanes + the
                                  admitted-request log pre-copy in per-slot
                                  chunks, dual-serving window, per-slot
                                  in-flight handoff with exactly-once
                                  completion.  Defined (and registered) in
                                  ``repro_torch.serving.handoff``; imported below
                                  for its registration side effect.

Replay correctness: message ids are totally ordered per queue; the target
skips ids <= the checkpoint marker and replays the rest through the same
jitted fold the source used => bit-exact state (verified by tests and by
every benchmark run via ``verify_against_reference``).
"""
from __future__ import annotations

from typing import Generator, Optional

from repro_torch.core.cutoff import choose_adaptive_strategy
from repro_torch.core.strategy import (
    CatchupDiscipline,
    LiveSyncCatchup,
    MigrationContext,
    MigrationStrategy,
    StopThenReplayCatchup,
    ThresholdCutoffCatchup,
    get_strategy,
    register_strategy,
)


# ---------------------------------------------------------------------------
# Strategy 0: stop-and-copy (baseline; paper Fig. 5)
# ---------------------------------------------------------------------------

@register_strategy("stop_and_copy")
class StopAndCopy(MigrationStrategy):
    """Strategy 0 (Fig. 5): UMS-style stop-and-copy baseline — downtime
    spans the whole checkpoint/push/pull/restore pipeline (~49 s)."""

    def run(self, ctx: MigrationContext) -> Generator:
        t = ctx.api.timings
        rep = ctx.report
        down0 = ctx.sim.now
        ctx.source.pause()  # downtime starts immediately

        push = yield from ctx.transfer(
            False, "", f"{ctx.primary_queue}-sac{ctx.n}")

        target = yield from ctx.restore_target(
            push, ctx.broker.queues[ctx.primary_queue], replay=False)

        t0 = ctx.sim.now
        ctx.ensure_target(target)  # never delete the source for a dead target
        yield from ctx.api.delete_pod(ctx.source.name)
        yield t.route_switch_s
        ctx.ensure_target(target)
        target.start()
        ctx.phase("cutover", t0)

        rep.downtime = ctx.sim.now - down0
        ctx.finish(target)
        return rep, target


# ---------------------------------------------------------------------------
# Strategies 1/2/4: the live MS2M family — one pipeline, three catch-up /
# transfer configurations
# ---------------------------------------------------------------------------

@register_strategy("ms2m_individual")
class MS2MIndividual(MigrationStrategy):
    """Strategy 1 (Fig. 2): live sync via a mirrored secondary queue —
    downtime is the short cutover only (pre-copy opt-in by policy)."""

    def use_precopy(self, ctx: MigrationContext) -> bool:
        return ctx.policy.precopy

    def make_catchup(self, ctx: MigrationContext) -> CatchupDiscipline:
        return LiveSyncCatchup()

    def run(self, ctx: MigrationContext) -> Generator:
        t = ctx.api.timings
        rep = ctx.report
        # build the discipline before the mirror attaches: a misconfigured
        # one (e.g. cutoff without a controller) must fail with no
        # secondary left behind
        disc = self.make_catchup(ctx)
        sec = ctx.attach_secondary()
        # the catch-up discipline arms when accumulation starts: a cutoff
        # deadline is measured from this instant, even mid-transfer
        disc.arm(ctx)
        try:
            push = yield from ctx.transfer(
                self.use_precopy(ctx),
                f"{ctx.primary_queue}-pre{ctx.n}",
                f"{ctx.primary_queue}-ms2m{ctx.n}")

            target = yield from ctx.restore_target(push, sec, replay=True)

            # -- catch-up: target replays the mirror, source keeps serving --
            t0 = ctx.sim.now
            base_processed = target.worker.n_processed
            target.start()
            yield from disc.catchup(ctx, target)
            ctx.phase("message_replay", t0)

            # -- cutover ----------------------------------------------------
            t0 = ctx.sim.now
            down0 = disc.begin_cutover(ctx)
            yield t.cutover_coord_s
            # drain in-flight mirrored messages up to the source's final state
            yield from ctx.wait(
                ctx.drain_condition(target, ctx.source.worker.last_msg_id))
            ctx.switch_to_primary(target)
            target.processing_ms = ctx.source.processing_ms  # service rate
            yield t.route_switch_s
            rep.downtime = ctx.sim.now - down0
            ctx.phase("cutover", t0)

            yield from ctx.teardown_source()

            rep.replayed_messages = target.worker.n_processed - base_processed
            ctx.finish(target)
            return rep, target
        finally:
            ctx.cleanup()


@register_strategy("ms2m_cutoff")
class MS2MCutoff(MS2MIndividual):
    """Strategy 2 (Fig. 3, Eq. 5): live sync bounded by the Threshold-Based
    Cutoff — replay capped at T_replay_max by construction."""

    wants_cutoff = True

    def make_catchup(self, ctx: MigrationContext) -> CatchupDiscipline:
        assert ctx.cutoff is not None, "ms2m_cutoff needs a CutoffController"
        return ThresholdCutoffCatchup(ctx.cutoff.threshold())


@register_strategy("ms2m_precopy")
class MS2MPrecopy(MS2MIndividual):
    """Strategy 4 (beyond paper): iterative delta pre-copy always on —
    full push once, then fingerprint-diffed, codec-compressed delta rounds
    until the dirty set converges; the replay log is one round's traffic."""

    def use_precopy(self, ctx: MigrationContext) -> bool:
        return True


# ---------------------------------------------------------------------------
# Strategy 3: MS2M for StatefulSet pods (paper Fig. 4)
# ---------------------------------------------------------------------------

@register_strategy("ms2m_statefulset")
class MS2MStatefulSet(MigrationStrategy):
    """Strategy 3 (Fig. 4): sticky identity forces stop-before-create —
    checkpoint+push live, stop source, release identity, restore, bounded
    replay to the cutoff message id."""

    handles_identity = True

    def run(self, ctx: MigrationContext) -> Generator:
        t = ctx.api.timings
        rep = ctx.report
        identity = ctx.identity or f"sts-{ctx.source.name}"
        ctx.identity = identity  # rollback re-claims it for the source
        sec = ctx.attach_secondary()
        try:
            # with precopy, BOTH stop-phase costs of Fig. 4 shrink: the
            # final marker is late (bounded replay) and the target node's
            # layer cache is warm (near-zero pull)
            push = yield from ctx.transfer(
                ctx.policy.precopy,
                f"{ctx.primary_queue}-sts-pre{ctx.n}",
                f"{ctx.primary_queue}-sts{ctx.n}")

            # -- stop source after the checkpoint-transfer phase (Fig. 4) --
            down0 = ctx.sim.now
            ctx.source.pause()
            rep.cutoff_id = ctx.source.worker.last_msg_id  # cutoff message id
            disc = StopThenReplayCatchup(rep.cutoff_id)

            t0 = ctx.sim.now
            yield from ctx.api.delete_pod(ctx.source.name,
                                          statefulset_identity=identity)
            ctx.phase("identity_release", t0)

            target = yield from ctx.restore_target(push, sec, replay=True,
                                                   identity=identity)

            # -- replay up to the cutoff message id -------------------------
            t0 = ctx.sim.now
            base_processed = target.worker.n_processed
            target.start()
            yield from disc.catchup(ctx, target)
            ctx.phase("message_replay", t0)

            t0 = ctx.sim.now
            ctx.switch_to_primary(target)
            target.processing_ms = ctx.source.processing_ms
            yield t.route_switch_s
            rep.downtime = ctx.sim.now - down0
            ctx.phase("cutover", t0)

            rep.replayed_messages = target.worker.n_processed - base_processed
            ctx.finish(target)
            return rep, target
        finally:
            ctx.cleanup()


# ---------------------------------------------------------------------------
# Strategy 5: adaptive scheme selection (beyond paper)
# ---------------------------------------------------------------------------

@register_strategy("ms2m_adaptive")
class MS2MAdaptive(MigrationStrategy):
    """Strategy 5 (beyond paper): picks individual / cutoff / pre-copy at
    migrate time from observed lam/mu and state-size telemetry.

    The inputs are what the Migration Manager can already see:

      * lam/mu — the CutoffController's online estimates (or the arrival
        throughput observed on the primary queue when none is wired);
      * the source's state size vs. registry bandwidth — whether transfer
        time is byte-dominated (the pre-copy regime) or dominated by fixed
        control-plane costs.

    The decision math lives in ``cutoff.choose_adaptive_strategy`` (pure,
    unit-testable); this class only gathers inputs and delegates the whole
    pipeline to the chosen registered strategy — zero manager-core edits,
    which is exactly what the registry exists to prove.
    """

    wants_cutoff = True

    def choose(self, ctx: MigrationContext) -> tuple:
        lam, mu = ctx.observed_rates()
        t = ctx.api.timings
        fixed_s = (t.checkpoint_s + t.image_build_s + t.push_base_s
                   + t.pod_create_s + t.pull_base_s + t.restore_s)
        # push (source leg) + pull (target leg), each over its own
        # topology link class; identical legs keep the legacy 2x/bw form
        # so flat-preset decisions stay bit-identical to the seed
        topo = ctx.api.topology
        bw_push = topo.registry_capacity_Bps(ctx.source.node.name)
        bw_pull = topo.registry_capacity_Bps(ctx.target_node)
        nbytes = ctx.state_nbytes()
        if bw_push == bw_pull:
            wire_s = 2.0 * nbytes / bw_push
        else:
            wire_s = nbytes / bw_push + nbytes / bw_pull
        t_replay_max = (ctx.cutoff.t_replay_max if ctx.cutoff is not None
                        else ctx.policy.t_replay_max)
        return choose_adaptive_strategy(
            lam, mu, fixed_s=fixed_s, wire_s=wire_s,
            t_replay_max=t_replay_max, rho_max=ctx.policy.adaptive_rho_max)

    def run(self, ctx: MigrationContext) -> Generator:
        chosen, why = self.choose(ctx)
        ctx.emit("adaptive_choice", chosen=chosen, **why)
        if chosen == "ms2m_cutoff" and ctx.cutoff is None:
            # no controller wired: synthesize one from the observed rates so
            # the threshold discipline still has its Eq. 5 inputs
            from repro_torch.core.cutoff import CutoffController
            lam, mu = ctx.observed_rates()
            ctx.cutoff = CutoffController(
                t_replay_max=ctx.policy.t_replay_max,
                mu_fallback=mu, lam_fallback=max(lam, 1e-9))
        delegate = get_strategy(chosen)()
        result = yield from delegate.run(ctx)
        return result


# Strategy 6 lives with the serving subsystem; importing it here registers
# it alongside the built-ins (the manager core stays untouched).
try:
    from repro_torch.serving.handoff import ServingHandoff  # noqa: E402,F401
except ImportError:
    # repro_torch.serving.handoff is itself mid-import (its import of the
    # registry layer runs this module via the package __init__); its
    # @register_strategy decorator runs when that import resumes.
    pass
