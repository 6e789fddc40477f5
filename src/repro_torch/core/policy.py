"""Declarative migration configuration and the structured trace stream.

``MigrationPolicy`` is the single knob surface for every migration
strategy: instead of threading ``precopy=``, ``precopy_max_rounds=``,
``batched_replay=``, ``replay_speedup=``, ``manager_kwargs={...}`` through
constructors and harnesses, callers build one policy value and hand it to
``MigrationManager`` / ``ClusterMigrationOrchestrator`` /
``run_*_experiment`` (all of which still accept the legacy kwargs and fold
them into a policy for backward compatibility).

``MigrationEvent`` is the structured trace record: every phase boundary,
pre-copy round, cutoff firing and adaptive decision is appended to
``MigrationReport.events``, and the legacy ``report.phases`` dict is now a
view derived from the event stream rather than ad-hoc bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MigrationPolicy:
    """Everything a strategy may consult about *how* to migrate.

    Strategy selection stays separate (the registry name passed to
    ``migrate(...)``); the policy only parameterizes the phase primitives
    the chosen strategy composes.
    """

    # -- replay discipline ----------------------------------------------------
    batched_replay: bool = False     # target replays via the batched path
    replay_speedup: float = 1.0      # measured mu_replay / mu_target (>= 1)

    # -- iterative pre-copy transfer engine -----------------------------------
    precopy: bool = False            # opt-in for strategies with "policy" mode
    precopy_max_rounds: int = 5
    precopy_converge_ratio: float = 0.9  # stop when dirty >= ratio * previous
    precopy_min_dirty: int = 0       # stop when a round dirties <= this many

    # -- checkpoint data path -------------------------------------------------
    # delta codec for pre-copy rounds: "none" | "xor_rle" | "int8" | "auto",
    # or a {tree name: codec} dict (the registry resolves it against each
    # leaf's dtype/parent; lossy codecs are followed by a lossless
    # exact-flush push before cutover).  NOTE: the cluster migration path
    # pushes one tree named "state", so a dict here must key on "state" —
    # other keys only matter for direct multi-tree Registry pushes
    compression: Any = "none"

    # -- adaptive strategy selection (ms2m_adaptive) --------------------------
    adaptive_rho_max: float = 0.9    # lam/mu above this => live sync unstable
    t_replay_max: float = 45.0       # replay bound when no CutoffController

    # -- crash recovery (orchestrator retry loop) -----------------------------
    # a failed migration is rolled back (source serving again) and, when
    # attempts remain, re-placed by the placement policy with the failed
    # target node excluded.  max_attempts=1 == the legacy fail-once
    # behaviour
    max_attempts: int = 1
    retry_backoff_s: float = 2.0     # wait between attempts

    def __post_init__(self):
        object.__setattr__(self, "replay_speedup",
                           max(1.0, self.replay_speedup))
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        from repro_torch.checkpoint.codecs import validate_compression
        validate_compression(self.compression)

    def evolve(self, **changes: Any) -> "MigrationPolicy":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def resolve(policy: Optional["MigrationPolicy"] = None,
                **legacy: Any) -> "MigrationPolicy":
        """Fold legacy keyword knobs into a policy.

        ``legacy`` values of ``None`` mean "not specified" and leave the
        base policy untouched; anything else overrides it — this is the
        compat shim behind every ``**manager_kwargs``-era call site.
        """
        base = policy or MigrationPolicy()
        changes = {k: v for k, v in legacy.items() if v is not None}
        if not changes:
            return base
        unknown = set(changes) - {f.name for f in dataclasses.fields(base)}
        if unknown:
            raise TypeError(
                f"unknown migration policy knob(s): {sorted(unknown)}")
        return dataclasses.replace(base, **changes)


@dataclasses.dataclass
class MigrationEvent:
    """One structured trace record emitted during a migration."""

    t: float        # virtual time of the event
    kind: str       # "phase" | "precopy_round" | "cutoff_fired" | ...
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, Any]:
        return {"t": round(self.t, 6), "kind": self.kind, **self.data}


@dataclasses.dataclass
class MigrationReport:
    strategy: str
    t_start: float
    t_end: float = 0.0
    downtime: float = 0.0
    checkpoint_marker: int = -1
    cutoff_id: Optional[int] = None
    cutoff_fired: bool = False
    replayed_messages: int = 0
    image_id: str = ""
    image_written_bytes: int = 0
    image_deduped_bytes: int = 0
    # raw-vs-wire accounting across every push of this migration: raw is
    # the dirty bytes a codec-less transfer would move, wire is what the
    # delta codecs actually put on the link
    image_raw_bytes: int = 0
    image_wire_bytes: int = 0
    compression: str = "none"
    state_verified: Optional[bool] = None
    # which attempt (1-based) this report describes: > 1 means earlier
    # attempts failed, were rolled back and retried by the orchestrator
    attempts: int = 1
    # pre-copy telemetry: per-round raw/wire bytes / dirty-message counts
    # (index 0 = the initial full push)
    precopy_rounds: int = 0
    precopy_round_bytes: List[int] = dataclasses.field(default_factory=list)
    precopy_round_wire_bytes: List[int] = dataclasses.field(
        default_factory=list)
    precopy_round_dirty: List[int] = dataclasses.field(default_factory=list)
    # structured trace stream; ``phases`` below is derived from it
    events: List[MigrationEvent] = dataclasses.field(default_factory=list)

    @property
    def migration_time(self) -> float:
        return self.t_end - self.t_start

    @property
    def recovered(self) -> bool:
        """True when this migration succeeded only after at least one
        rolled-back attempt."""
        return self.attempts > 1

    @property
    def wire_reduction(self) -> float:
        """raw / wire bytes across all pushes (1.0 = no codec win)."""
        if self.image_wire_bytes <= 0:
            return 1.0
        return self.image_raw_bytes / self.image_wire_bytes

    def emit(self, kind: str, t: float, **data: Any) -> MigrationEvent:
        ev = MigrationEvent(t=t, kind=kind, data=data)
        self.events.append(ev)
        return ev

    @property
    def phases(self) -> Dict[str, float]:
        """Per-phase durations, aggregated from the event stream (same
        shape the old ad-hoc ``phases`` dict had)."""
        out: Dict[str, float] = {}
        for ev in self.events:
            if ev.kind == "phase":
                name = ev.data["phase"]
                out[name] = out.get(name, 0.0) + ev.data["duration"]
        return out

    def event_rows(self) -> List[Dict[str, Any]]:
        return [ev.row() for ev in self.events]
