"""Threshold-Based Cutoff Mechanism (paper §III-B, Eqs. 1-5).

M/M/1 model: messages arrive Poisson(λ) and accumulate in the secondary
queue for T_accum; the target replays them at μ_target.

  N_messages = λ · T_accum                                   (Eq. 1)
  T_replay   = N / μ_target = λ · T_accum / μ_target         (Eq. 2)
  T_replay  <= T_replay_max                                  (Eq. 3,4)
  T_cutoff   = T_accum <= T_replay_max · μ_target / λ        (Eq. 5)

Beyond-paper extension (`batched_cutoff_threshold`): a JAX target replays
the log as batched prefill at μ_replay = speedup(B)·μ_target >> μ_target,
so the admissible accumulation window stretches by the measured batching
speedup — the high-λ regime where the paper's MS2M degrades collapses.

Adaptive estimators: λ̂ and μ̂ are EWMA-estimated online from observed
inter-arrival / service times (the paper assumes them known; a production
controller must measure them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


def cutoff_threshold(t_replay_max: float, mu_target: float, lam: float) -> float:
    """Eq. 5.  λ -> 0 gives an unbounded window (cap to +inf)."""
    if lam <= 0.0:
        return math.inf
    return t_replay_max * mu_target / lam


def replay_time_bound(lam: float, t_accum: float, mu_target: float) -> float:
    """Eq. 2 — expected replay time for a given accumulation window."""
    if mu_target <= 0:
        return math.inf
    return lam * t_accum / mu_target


def expected_catchup_time(lam: float, mu: float, backlog: float) -> float:
    """Drain time of a backlog with ongoing arrivals: backlog/(μ-λ);
    infinite at or beyond saturation (the failure mode the paper reports
    for original MS2M as λ -> μ)."""
    if mu <= lam:
        return math.inf
    return backlog / (mu - lam)


def batched_cutoff_threshold(t_replay_max: float, mu_target: float,
                             lam: float, batch_speedup: float) -> float:
    """Eq. 5 with μ_replay = speedup · μ_target (batched/prefill replay)."""
    return cutoff_threshold(t_replay_max, mu_target * max(1.0, batch_speedup), lam)


def stable_for_live_migration(lam: float, mu: float, rho_max: float = 0.95) -> bool:
    """Utilization guard: live (catch-up) migration only converges for
    ρ = λ/μ < 1; above ρ_max, a controller should prefer the cutoff path."""
    return lam < rho_max * mu


def transfer_time_estimate(fixed_s: float, state_bytes: float,
                           bw_Bps: float) -> float:
    """Expected single-shot transfer time: fixed control-plane costs plus
    the wire time of one full state image."""
    return fixed_s + state_bytes / max(bw_Bps, 1.0)


def choose_adaptive_strategy(lam: float, mu: float, *, fixed_s: float,
                             wire_s: float, t_replay_max: float,
                             rho_max: float = 0.9):
    """Decision rule behind the ``ms2m_adaptive`` strategy (pure, so it is
    unit-testable without a cluster).  Returns ``(strategy_name, why)``
    where ``why`` carries the telemetry the decision read.

    The accumulation window of a live MS2M migration is at least the
    transfer time T_xfer = fixed_s + wire_s, so the backlog at restore is
    ~λ·T_xfer and catch-up drains it at (μ - λ):

      * λ >= ρ_max·μ             — live sync cannot converge (the paper's
                                   high-λ failure mode): bound it, cutoff.
      * wire_s > fixed_s         — transfer is byte-dominated: iterative
                                   pre-copy both shrinks the final pull and
                                   bounds replay to one round, pre-copy.
      * catch-up > T_replay_max  — stable but slow: enforce the Eq. 5
                                   bound, cutoff.
      * otherwise                — plain live sync is already cheap.
    """
    t_xfer = fixed_s + wire_s
    backlog = lam * t_xfer
    catchup_s = expected_catchup_time(lam, mu, backlog)
    why = {
        "lam": round(lam, 4), "mu": round(mu, 4),
        "t_transfer": round(t_xfer, 3), "wire_s": round(wire_s, 3),
        "fixed_s": round(fixed_s, 3),
        "expected_catchup_s": (None if math.isinf(catchup_s)
                               else round(catchup_s, 3)),
    }
    if not stable_for_live_migration(lam, mu, rho_max):
        return "ms2m_cutoff", dict(why, reason="unstable_for_live_sync")
    if wire_s > fixed_s:
        return "ms2m_precopy", dict(why, reason="byte_dominated_transfer")
    if catchup_s > t_replay_max:
        return "ms2m_cutoff", dict(why, reason="catchup_exceeds_replay_bound")
    return "ms2m_individual", dict(why, reason="stable_and_cheap")


@dataclasses.dataclass
class RateEstimator:
    """EWMA arrival/service rate estimator (events per second).

    The EWMA is seeded from the first *real* inter-event interval: blending
    the first observation against a fake 0.0 starting rate would bias the
    estimate low for the first several half-lives (warm-up bias), which is
    exactly the window a short migration reads it in.  ``n_obs`` counts
    completed intervals so controllers can gate on evidence, not elapsed
    span.
    """

    halflife: float = 10.0  # seconds of virtual time
    _rate: Optional[float] = None  # None until the first interval lands
    _last_t: Optional[float] = None
    _n_obs: int = 0

    def observe(self, t: float):
        if self._last_t is None:
            self._last_t = t
            return
        dt = max(t - self._last_t, 1e-9)
        self._last_t = t
        inst = 1.0 / dt
        if self._rate is None:
            self._rate = inst  # seed from the first interval, no zero bias
        else:
            alpha = 1.0 - 0.5 ** (dt / self.halflife)
            self._rate += alpha * (inst - self._rate)
        self._n_obs += 1

    @property
    def rate(self) -> float:
        return 0.0 if self._rate is None else self._rate

    @property
    def n_obs(self) -> int:
        """Completed inter-event intervals folded into the estimate."""
        return self._n_obs

    @property
    def has_estimate(self) -> bool:
        return self._rate is not None


@dataclasses.dataclass
class CutoffController:
    """Online controller: tracks λ̂/μ̂ and decides when to cut off.

    ``should_cutoff(t_accum_started, now)`` is consulted by the migration
    manager once accumulation starts; it fires when the accumulation window
    exceeds Eq. 5's bound under the current estimates.
    """

    t_replay_max: float
    mu_fallback: float
    lam_fallback: float
    batch_speedup: float = 1.0
    # use the online λ̂/μ̂ estimates for the threshold (vs operator-supplied
    # fallbacks — the paper assumes λ and μ known); estimates are always
    # *tracked* either way and reported for observability.
    use_estimates: bool = False
    # evidence gate: completed intervals each estimator must have folded
    # before its estimate is trusted.  A *count*, not an elapsed span —
    # two observations 30 s apart are one interval, not convergence.
    min_observations: int = 30
    lam_est: RateEstimator = dataclasses.field(default_factory=RateEstimator)
    mu_est: RateEstimator = dataclasses.field(default_factory=RateEstimator)

    def observe_arrival(self, t: float):
        self._first_obs = min(getattr(self, "_first_obs", t), t)
        self._last_obs = t
        self.lam_est.observe(t)

    def observe_service(self, t: float):
        self._first_obs = min(getattr(self, "_first_obs", t), t)
        self._last_obs = t
        self.mu_est.observe(t)

    def _converged(self, est: RateEstimator) -> bool:
        return est.n_obs >= self.min_observations

    @property
    def lam(self) -> float:
        # explicit is-not-None gating: a legitimately converged tiny rate
        # must be returned, not silently swallowed by float truthiness
        if (self.use_estimates and self._converged(self.lam_est)
                and self.lam_est.has_estimate):
            return self.lam_est.rate
        return self.lam_fallback

    @property
    def mu(self) -> float:
        if (self.use_estimates and self._converged(self.mu_est)
                and self.mu_est.has_estimate):
            return self.mu_est.rate
        return self.mu_fallback

    def threshold(self) -> float:
        return batched_cutoff_threshold(
            self.t_replay_max, self.mu, self.lam, self.batch_speedup)

    def should_cutoff(self, accum_started: float, now: float) -> bool:
        return (now - accum_started) >= self.threshold()
