"""Runtime leak/race sanitizer for the discrete-event kernel.

Enabled with ``Sim(sanitize=True)`` or ``REPRO_SIM_SANITIZE=1``, the
sanitizer attaches creation-site provenance to kernel objects
(``Condition``, ``Link`` flows, waiting processes) and raises a
:class:`SanitizerViolation` — carrying the offending object's creation
stack — the moment one of these invariants breaks:

  * **callback/listener leak** — a single condition, pod listener list or
    broker mirror list grows past ``max_listeners`` registrations.  Both
    historical leaks (the PR 1 ``on_processed`` listener leak and the
    PR 4 ``any_of`` loser-callback leak) are exactly this signature:
    every migration/wakeup added one entry and nothing ever removed it;
  * **conflicting double-trigger** — a triggered condition is triggered
    again with a *different* payload value.  (Idempotent re-triggers with
    no value are part of the kernel contract and stay legal.)
  * **stale pause** — a pod that a migration rollback restored to service
    is paused again with no migration owning it: the signature of a stale
    cutoff deadline firing after ``MigrationContext.closed`` (the PR 5
    bug class);
  * **dangling waiters / flows at quiescence** — ``Sim.assert_quiescent``
    reports processes parked on conditions that can never trigger and
    link flows still in flight after the heap drained.

The checks are O(1) per kernel operation; with sanitize off the kernel
pays a single ``is None`` test per hook.
"""
from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional, Tuple

_ENV_MAX = "REPRO_SIM_SANITIZE_MAX"
_SKIP_BASENAMES = ("sanitizer.py",)


def capture_site(limit: int = 6) -> Tuple[str, ...]:
    """A compact creation-site stack: innermost-last ``file:line in fn``
    strings, with sanitizer frames dropped."""
    frames = traceback.extract_stack()[:-1]  # drop capture_site itself
    out = []
    for fr in frames:
        base = os.path.basename(fr.filename)
        if base in _SKIP_BASENAMES:
            continue
        out.append(f"{base}:{fr.lineno} in {fr.name}")
    return tuple(out[-limit:])


def format_site(site: Optional[Tuple[str, ...]]) -> str:
    if not site:
        return "<no provenance: sanitize was off at creation>"
    return " -> ".join(site)


class SanitizerViolation(AssertionError):
    """A kernel-hygiene invariant broke.  ``created`` is the offending
    object's creation site, ``site`` the stack of the operation that
    tripped the check."""

    def __init__(self, kind: str, message: str,
                 created: Optional[Tuple[str, ...]] = None,
                 site: Optional[Tuple[str, ...]] = None):
        self.kind = kind
        self.created = created
        self.site = site
        lines = [f"[{kind}] {message}"]
        if created:
            lines.append(f"  created at: {format_site(created)}")
        if site:
            lines.append(f"  detected at: {format_site(site)}")
        super().__init__("\n".join(lines))


# condition-name patterns that legitimately hold waiters/callbacks at
# quiescence: idle service loops parked on queue/wake conditions, node
# down-watchers, and the kernel's own any_of fan-in conditions
DEFAULT_IDLE_SUFFIXES = (":not_empty", ":wake", ":stall", ":down")
DEFAULT_IDLE_NAMES = ("any",)


class SimSanitizer:
    """Per-``Sim`` sanitizer state (see module docstring)."""

    def __init__(self, max_listeners: Optional[int] = None):
        if max_listeners is None:
            max_listeners = int(os.environ.get(_ENV_MAX, "64"))
        self.max_listeners = max_listeners
        # proc -> the untriggered Condition it is parked on (strong refs:
        # bounded by the number of live processes)
        self._waiting: Dict[Any, Any] = {}
        self._links: List[Any] = []
        # pods restored by a migration rollback with no migration owning
        # them: pausing one is the stale-cutoff-deadline bug class
        self._protected_pods: Dict[int, Tuple[Any, Tuple[str, ...]]] = {}
        self.stats: Dict[str, int] = {"conditions": 0, "registrations": 0,
                                      "disarmed_timers": 0}

    # -- provenance -----------------------------------------------------------
    def track_condition(self, cond) -> None:
        self.stats["conditions"] += 1
        cond.created = capture_site()

    def track_link(self, link) -> None:
        link.created = capture_site()
        self._links.append(link)

    # -- callback / listener growth -------------------------------------------
    def on_register_callback(self, cond) -> None:
        """Called after every ``Condition.on_trigger`` registration."""
        self.stats["registrations"] += 1
        n = len(cond._callbacks)
        if n > self.max_listeners:
            raise SanitizerViolation(
                "callback_leak",
                f"condition {cond.name!r} holds {n} callbacks and keeps "
                f"growing — a long-lived condition is accumulating "
                f"registrations nothing detaches (the any_of loser-leak "
                f"signature)",
                created=getattr(cond, "created", None),
                site=capture_site())

    def check_listener_growth(self, owner: str, n: int,
                              created: Optional[Tuple[str, ...]] = None
                              ) -> None:
        """Generic growth tripwire for listener lists outside the kernel
        (pod ``on_processed`` listeners, broker mirrors, migration
        listeners)."""
        if n > self.max_listeners:
            raise SanitizerViolation(
                "listener_leak",
                f"{owner} holds {n} listeners and keeps growing — "
                f"registrations are not being deregistered (the "
                f"on_processed listener-leak signature)",
                created=created, site=capture_site())

    # -- double trigger ---------------------------------------------------------
    def on_retrigger(self, cond, value) -> None:
        """A triggered condition was triggered again.  Value-less (or
        same-value) re-triggers are the kernel's idempotency contract;
        a *conflicting* payload means two owners both believe they
        completed this condition."""
        if value is not None and value is not cond.value:
            raise SanitizerViolation(
                "double_trigger",
                f"condition {cond.name!r} re-triggered with a conflicting "
                f"value {value!r} (already carries {cond.value!r})",
                created=getattr(cond, "created", None),
                site=capture_site())

    # -- waiter bookkeeping -----------------------------------------------------
    def on_wait(self, proc, cond) -> None:
        self._waiting[proc] = cond

    def on_ready(self, proc) -> None:
        self._waiting.pop(proc, None)

    # -- stale-pause watchpoints ------------------------------------------------
    def protect_pod(self, pod) -> None:
        """Arm a watchpoint: ``pod`` was just restored to service by a
        migration rollback; until a new migration claims it (or it is
        stopped), pausing it again means a stale timer outlived its
        migration."""
        self._protected_pods[id(pod)] = (pod, capture_site())

    def unprotect_pod(self, pod) -> None:
        self._protected_pods.pop(id(pod), None)

    def on_pause(self, pod) -> None:
        hit = self._protected_pods.get(id(pod))
        if hit is not None:
            _, restored_at = hit
            raise SanitizerViolation(
                "stale_pause",
                f"pod {pod.name!r} was restored to service by a migration "
                f"rollback and is being paused again with no migration "
                f"owning it — a stale cutoff deadline (or similar timer) "
                f"outlived MigrationContext.closed",
                created=restored_at, site=capture_site())

    def note_disarmed_timer(self) -> None:
        """A context-guarded timer fired after its migration closed and
        correctly disarmed itself (benign; counted for telemetry)."""
        self.stats["disarmed_timers"] += 1

    # -- quiescence -------------------------------------------------------------
    def dangling(self, allow_suffixes=DEFAULT_IDLE_SUFFIXES,
                 allow_names=DEFAULT_IDLE_NAMES) -> List[str]:
        """Human-readable descriptions of every leak visible once the
        event heap has drained: processes parked on conditions that can
        never trigger, and link flows still in flight."""
        out: List[str] = []
        for proc, cond in self._waiting.items():
            if cond.triggered:
                continue
            name = cond.name or ""
            if name in allow_names or name.endswith(allow_suffixes):
                continue
            out.append(
                f"process {proc.name!r} waits forever on condition "
                f"{name!r} (created at: "
                f"{format_site(getattr(cond, 'created', None))})")
        for link in self._links:
            for flow in link._flows:
                out.append(
                    f"link {link.name!r} still carries a flow with "
                    f"{flow.remaining:.0f}/{flow.nbytes:.0f} bytes left "
                    f"(created at: "
                    f"{format_site(getattr(flow, 'created', None))})")
        return out
