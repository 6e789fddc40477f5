"""What a run records for the metric readers: host-clock spans of the
steps and migrations, the served tokens, and the trace's summary."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


class Clock:
    """Seconds since the window opened (``now``; negative in set-up), for
    the harness and for the port's ``CompletionLedger`` (its ``sim``)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def open(self) -> None:
        self.t0 = time.perf_counter()

    @property
    def now(self) -> float:
        return time.perf_counter() - self.t0

    def __call__(self) -> float:
        return self.now


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    engine: str
    kind: str              # "decode" or "train"
    lanes_valid: int = 0   # decode: cached rows the attention reads


@dataclasses.dataclass
class Migration:
    strategy: str
    t_start: float                       # the first checkpoint begins
    checkpoint_index: int = 0            # log entries in the checkpoint
    t_push0: float = 0.0
    t_push1: float = 0.0
    push_bytes: int = 0                  # raw image bytes, or wire bytes
    t_stop: Optional[float] = None       # the source stops serving
    t_last_source: Optional[float] = None
    t_ready: Optional[float] = None      # target restored
    replay_entries: int = 0
    replay_s: float = 0.0
    t_switch: Optional[float] = None
    t_first_target: Optional[float] = None
    cutoff_fired: bool = False
    state_equal: Optional[bool] = None

    @property
    def downtime_s(self) -> Optional[float]:
        if self.t_first_target is None or self.t_last_source is None:
            return None
        return self.t_first_target - self.t_last_source

    @property
    def migration_s(self) -> Optional[float]:
        return None if self.t_switch is None else self.t_switch - self.t_start


@dataclasses.dataclass
class Record:
    workload: str
    run: dict
    traffic: dict
    window_s: float
    steps: List[Step] = dataclasses.field(default_factory=list)
    migrations: List[Migration] = dataclasses.field(default_factory=list)
    # serving: rid -> [(t, token)] served live in the window
    served: Dict[int, List[Tuple[float, int]]] = dataclasses.field(
        default_factory=dict)
    completed: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)   # (t, rid): sessions delivered in the window
    prompt_len: Dict[int, int] = dataclasses.field(default_factory=dict)
    # training: batch ids trained in the window, tokens a batch
    trained: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    tokens_per_batch: int = 0
    trace: Optional[dict] = None
    setup_s: float = 0.0
    checks: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    attempted: int = 0
    failed: int = 0
    # the configuration's model (harness/decoder.py where None): its counts
    model: Optional[object] = None

    def done_migrations(self) -> List[Migration]:
        return [m for m in self.migrations if m.t_switch is not None
                and m.t_switch <= self.window_s]

    def window_steps(self, kinds=("decode", "train")) -> List[Step]:
        return [s for s in self.steps
                if s.kind in kinds and 0.0 <= s.t0 and s.t1 <= self.window_s]


def summary(rec: Record) -> dict:
    """A compact account of the window for standard error: the steps and
    every migration's phases (seconds into the window)."""
    steps = rec.window_steps()
    ms = sorted(1e3 * (s.t1 - s.t0) for s in steps)
    out = {"steps": len(steps),
           "step_ms_mean": sum(ms) / len(ms) if ms else None,
           "step_ms_p10_p50_p90": ([ms[len(ms) // 10], ms[len(ms) // 2],
                                    ms[9 * len(ms) // 10]] if ms else None),
           "completed_s": [round(t, 3) for t, _ in rec.completed],
           "migrations": []}
    for m in rec.migrations:
        out["migrations"].append({
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in dataclasses.asdict(m).items()
            if v is not None and k != "strategy"})
    return out
