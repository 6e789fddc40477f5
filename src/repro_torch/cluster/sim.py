"""Deterministic discrete-event kernel with generator processes.

Processes are Python generators that ``yield`` either a float delay or a
``Condition``; the kernel advances a virtual clock.  All service times are
charged to the virtual clock (so benchmarks are deterministic and fast)
while *real* JAX compute runs inside the handlers (so migrated state is
real, bit-exactly checkable, and measured step times can calibrate the
clock constants).

Two analysis modes (see docs/determinism.md):

  * ``Sim(sanitize=True)`` / ``REPRO_SIM_SANITIZE=1`` — the runtime
    sanitizer: conditions, link flows and waiting processes carry
    creation-site provenance, and leak/race invariants (callback-list
    growth, conflicting double-triggers, dangling waiters at quiescence)
    raise :class:`repro_torch.analysis.sanitizer.SanitizerViolation`;
  * ``Sim(tiebreak_seed=N)`` / ``REPRO_SIM_TIEBREAK=N`` — seeded schedule
    perturbation: the pop order of *equal-timestamp* heap events is
    permuted by a deterministic bijective hash of (event counter, seed).
    Virtual time is untouched; only tie order changes.  Any observable
    divergence under perturbation is a latent scheduling race
    (``tools/sim_perturb.py`` sweeps this).
"""
from __future__ import annotations

import heapq
import itertools
import os
from typing import Any, Callable, Generator, List, Optional

from repro_torch.analysis.sanitizer import (SanitizerViolation, SimSanitizer,
                                      capture_site)

_SANITIZE_ENV = "REPRO_SIM_SANITIZE"
_TIEBREAK_ENV = "REPRO_SIM_TIEBREAK"
_FLUID_ENV = "REPRO_SIM_FLUID"
_CENSUS_ENV = "REPRO_SIM_CENSUS"
_M64 = (1 << 64) - 1

# event-census categories (docs/scaling.md): attribution buckets for
# popped heap events, derived from process names / scheduling sites
CENSUS_CATEGORIES = ("message", "heartbeat", "link", "fault", "other")


def _census_category(name: str) -> str:
    """Classify a process by name prefix for the opt-in event census."""
    if name.startswith(("pod:", "producer", "source:")):
        return "message"
    if name.startswith("heartbeat"):
        return "heartbeat"
    if name.startswith("fault"):
        return "fault"
    return "other"


def _mix64(counter: int, seed: int) -> int:
    """splitmix64 finalizer over (counter, seed): a bijection of the
    counter for any fixed seed, so equal-timestamp events get a
    deterministic, collision-free permuted pop order."""
    z = (counter + (seed + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class Condition:
    """A waitable event; processes yield it to block until triggered."""

    def __init__(self, sim: "Sim", name: str = ""):
        self.sim = sim
        self.name = name
        self.triggered = False
        self.value: Any = None
        self._waiters: List["_Proc"] = []
        self._callbacks: List[Callable] = []
        if sim.sanitizer is not None:
            sim.sanitizer.track_condition(self)

    def on_trigger(self, fn: Callable):
        if self.triggered:
            fn(self.value)
        else:
            self._callbacks.append(fn)
            if self.sim.sanitizer is not None:
                self.sim.sanitizer.on_register_callback(self)

    def detach(self, fn: Callable):
        """Remove a callback registered with ``on_trigger`` (no-op when
        it already fired or was never registered)."""
        try:
            self._callbacks.remove(fn)
        except ValueError:
            pass

    def trigger(self, value: Any = None):
        if self.triggered:
            if self.sim.sanitizer is not None:
                self.sim.sanitizer.on_retrigger(self, value)
            return
        self.triggered = True
        self.value = value
        for proc in self._waiters:
            self.sim._ready(proc, value)
        self._waiters.clear()
        for fn in self._callbacks:
            fn(value)
        self._callbacks.clear()


class _Proc:
    def __init__(self, gen: Generator, name: str):
        self.gen = gen
        self.name = name
        self.cat = _census_category(name)
        self.done = Condition.__new__(Condition)  # filled by Sim.process


class Interrupt(Exception):
    pass


class Sim:
    def __init__(self, sanitize: Optional[bool] = None,
                 tiebreak_seed: Optional[int] = None,
                 fluid: Optional[bool] = None,
                 census: Optional[bool] = None):
        self.now = 0.0
        self._heap: list = []
        self._counter = itertools.count()
        # env fallbacks let harnesses flip the modes on Sims they never
        # construct directly (Cluster builds its own)
        if sanitize is None:
            sanitize = os.environ.get(_SANITIZE_ENV, "") not in ("", "0")
        self.sanitizer: Optional[SimSanitizer] = (
            SimSanitizer() if sanitize else None)
        if tiebreak_seed is None:
            env = os.environ.get(_TIEBREAK_ENV, "")
            tiebreak_seed = int(env) if env else None
        self.tiebreak_seed = tiebreak_seed
        # epoch-batched (fluid) message dynamics: ON by default, with
        # REPRO_SIM_FLUID=0 selecting the legacy per-message-event flow
        # (docs/scaling.md).  The flag only gates an optimization — the
        # observable timeline is bit-identical either way.
        if fluid is None:
            fluid = os.environ.get(_FLUID_ENV, "") != "0"
        self.fluid_enabled = bool(fluid)
        # opt-in event census: count popped heap events per category so
        # perf regressions are attributable (BENCH_sim.json)
        if census is None:
            census = os.environ.get(_CENSUS_ENV, "") not in ("", "0")
        self._census: Optional[dict] = (
            {c: 0 for c in CENSUS_CATEGORIES} if census else None)

    # -- scheduling ----------------------------------------------------------
    def _push(self, t: float, fn: Callable, arg: Any = None,
              cat: str = "other"):
        c = next(self._counter)
        if self.tiebreak_seed is not None:
            c = _mix64(c, self.tiebreak_seed)
        heapq.heappush(self._heap, (t, c, fn, arg, cat))

    def _ready(self, proc: _Proc, value: Any = None):
        if self.sanitizer is not None:
            self.sanitizer.on_ready(proc)
        self._push(self.now, lambda v: self._step(proc, v), value, proc.cat)

    def condition(self, name: str = "") -> Condition:
        return Condition(self, name)

    def any_of(self, *conds: Condition, name: str = "any") -> Condition:
        """Condition triggering when the first of ``conds`` triggers.

        The losers are detached when the winner fires: callers that
        repeatedly build ``any_of`` over long-lived conditions (the fleet
        driver's wakeup loop) must not grow the losers' callback lists
        unboundedly."""
        out = Condition(self, name)
        armed: List[Condition] = []

        def fire(value: Any = None):
            for c in armed:
                if not c.triggered:
                    c.detach(fire)
            armed.clear()
            out.trigger(value)

        for c in conds:
            if c.triggered:
                fire(c.value)
                break
            armed.append(c)
            c.on_trigger(fire)
        return out

    def process(self, gen: Generator, name: str = "") -> Condition:
        """Start a generator process; returns its completion Condition."""
        proc = _Proc(gen, name)
        done = Condition(self, f"done:{name}")
        proc.done = done
        self._push(self.now, lambda v: self._step(proc, v), None, proc.cat)
        return done

    def call_at(self, t: float, fn: Callable, category: str = "other"):
        self._push(max(t, self.now), lambda _: fn(), None, category)

    def call_after(self, delay: float, fn: Callable,
                   category: str = "other"):
        self.call_at(self.now + delay, fn, category=category)

    # -- process stepping ------------------------------------------------------
    def _step(self, proc: _Proc, send_value: Any):
        try:
            yielded = proc.gen.send(send_value)
        except StopIteration as stop:
            proc.done.trigger(stop.value)
            return
        if isinstance(yielded, Condition):
            if yielded.triggered:
                self._ready(proc, yielded.value)
            else:
                yielded._waiters.append(proc)
                if self.sanitizer is not None:
                    self.sanitizer.on_wait(proc, yielded)
        elif isinstance(yielded, (int, float)):
            self._push(self.now + float(yielded),
                       lambda v: self._step(proc, v), None, proc.cat)
        else:
            raise TypeError(f"process {proc.name} yielded {type(yielded)}")

    # -- fair-share flows ------------------------------------------------------
    def link(self, capacity_Bps: float, latency_s: float = 0.0,
             name: str = "link", shared: bool = True) -> "Link":
        return Link(self, capacity_Bps, latency_s=latency_s, name=name,
                    shared=shared)

    # -- run -------------------------------------------------------------------
    def run(self, until: Optional[float] = None,
            stop_when: Optional[Condition] = None):
        census = self._census
        while self._heap:
            if stop_when is not None and stop_when.triggered:
                return
            head = self._heap[0]
            t = head[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            if census is not None:
                census[head[4]] += 1
            head[2](head[3])
        if until is not None:
            self.now = max(self.now, until)

    def stats(self) -> dict:
        """Kernel introspection: clock, heap size and (when the census is
        on — ``Sim(census=True)`` / ``REPRO_SIM_CENSUS=1``) popped-event
        counts per category.  With the census off ``events`` is ``None``
        so callers can tell "not measured" from "zero events"."""
        events = dict(self._census) if self._census is not None else None
        return {"now": self.now,
                "heap_len": len(self._heap),
                "census_enabled": self._census is not None,
                "events": events,
                "events_total": (sum(events.values())
                                 if events is not None else None)}

    # -- quiescence audit ------------------------------------------------------
    def assert_quiescent(self, **allow) -> None:
        """With ``sanitize`` on, raise :class:`SanitizerViolation` if any
        process is parked on a condition that can never trigger or any
        link flow is still in flight now that the heap has drained.
        ``allow`` forwards to :meth:`SimSanitizer.dangling`
        (``allow_suffixes`` / ``allow_names`` tune the idle-pattern
        allowlist).  No-op when the sanitizer is off."""
        if self.sanitizer is None:
            return
        leaks = self.sanitizer.dangling(**allow)
        if leaks:
            raise SanitizerViolation(
                "dangling",
                "leaks at quiescence:\n  " + "\n  ".join(leaks))


class TransferAborted(RuntimeError):
    """An in-flight Link transfer was withdrawn (e.g. an endpoint died)."""


class _Flow:
    __slots__ = ("nbytes", "remaining", "done", "created")

    def __init__(self, sim: Sim, nbytes: float):
        self.nbytes = nbytes
        self.remaining = nbytes
        self.done = Condition(sim, "flow")
        self.created = (capture_site() if sim.sanitizer is not None
                        else None)


class Link:
    """A capacity-limited network link with max-min fair bandwidth sharing.

    Concurrent ``transfer(nbytes)`` flows split the capacity equally;
    remaining bytes and per-flow rate are recomputed on every flow arrival
    and departure (progressive filling).  The schedule is deterministic and
    heap-driven — each recompute arms exactly one next-completion event,
    superseded by a generation counter when the flow set changes — so a
    link never polls.  Work conservation: when a short flow finishes, the
    survivors immediately speed up.

    ``shared=False`` is the dedicated-capacity (legacy) mode: every
    transfer is charged ``nbytes / capacity`` independently, with no
    contention — the ``flat`` topology preset uses it to reproduce the
    uncontended single-registry-link model bit-for-bit.
    """

    _EPS_BYTES = 1e-6  # float-settlement slack when finishing a flow

    def __init__(self, sim: Sim, capacity_Bps: float, latency_s: float = 0.0,
                 name: str = "link", shared: bool = True):
        if capacity_Bps <= 0:
            raise ValueError(f"link {name!r} needs capacity_Bps > 0")
        self.sim = sim
        self.capacity_Bps = float(capacity_Bps)
        self.latency_s = float(latency_s)
        self.name = name
        self.shared = shared
        self.total_bytes = 0.0      # lifetime bytes accepted onto the link
        self.peak_flows = 0
        self.aborted_flows = 0
        self._flows: List[_Flow] = []
        self._last = sim.now
        self._gen = 0
        if sim.sanitizer is not None:
            sim.sanitizer.track_link(self)

    @property
    def n_flows(self) -> int:
        return len(self._flows)

    @property
    def queued_bytes(self) -> float:
        """Bytes still in flight across all active flows (load signal)."""
        self._settle()
        return sum(f.remaining for f in self._flows)

    def rate_per_flow(self) -> float:
        return (self.capacity_Bps / len(self._flows) if self._flows
                else self.capacity_Bps)

    def set_capacity(self, capacity_Bps: float) -> None:
        """Change the link's capacity mid-run (fault injection: a degraded
        or repaired link).  Shared links settle in-flight flows at the old
        rate first, then re-plan the next completion at the new rate, so
        the change takes effect for every active flow at the instant it is
        applied.  Dedicated (unshared) links price each transfer when it
        starts, so a capacity change there affects new transfers only."""
        if capacity_Bps <= 0:
            raise ValueError(f"link {self.name!r} needs capacity_Bps > 0")
        if self.shared:
            self._settle()
            self.capacity_Bps = float(capacity_Bps)
            self._reschedule()
        else:
            self.capacity_Bps = float(capacity_Bps)

    # -- progressive filling ---------------------------------------------------
    def _settle(self) -> None:
        """Credit progress at the rate that held since the last event."""
        now = self.sim.now
        dt = now - self._last
        self._last = now
        if dt <= 0.0 or not self._flows:
            return
        rate = self.capacity_Bps / len(self._flows)
        for f in self._flows:
            f.remaining -= rate * dt

    def _finish_completed(self) -> None:
        still: List[_Flow] = []
        for f in self._flows:
            if f.remaining <= self._EPS_BYTES:
                f.done.trigger()
            else:
                still.append(f)
        self._flows = still

    def _reschedule(self) -> None:
        self._gen += 1
        if not self._flows:
            return
        while True:
            rate = self.capacity_Bps / len(self._flows)
            residual = min(f.remaining for f in self._flows)
            t = self.sim.now + residual / rate
            if t > self.sim.now:
                break
            # the residual is below the clock's float resolution at this
            # timestamp (now + dt == now): arming a tick could never make
            # progress (_settle sees dt == 0), so credit the sub-resolution
            # window synchronously — every flow advances by the residual —
            # and finish what that settles
            for f in self._flows:
                f.remaining -= residual
            self._finish_completed()
            if not self._flows:
                return
        gen = self._gen
        self.sim.call_at(t, lambda: self._on_tick(gen), category="link")

    def _on_tick(self, gen: int) -> None:
        if gen != self._gen:  # superseded by an arrival/departure
            return
        self._settle()
        self._finish_completed()
        self._reschedule()

    # -- the flow API ----------------------------------------------------------
    def transfer(self, nbytes: float, abort: Optional[Condition] = None
                 ) -> Generator:
        """Generator process: move ``nbytes`` across the link, fair-sharing
        with every concurrent flow.  Charges the per-transfer latency
        first.  If ``abort`` (a Condition) triggers mid-flight, the flow is
        withdrawn — survivors speed up — and ``TransferAborted`` raises
        into the calling process.  Returns the elapsed transfer seconds
        (excluding latency)."""
        if abort is not None and abort.triggered:
            raise TransferAborted(f"{self.name}: aborted before start")
        if self.latency_s > 0.0:
            yield self.latency_s
        if nbytes <= 0:
            return 0.0
        self.total_bytes += nbytes
        t0 = self.sim.now
        if not self.shared:  # dedicated capacity: no contention
            duration = nbytes / self.capacity_Bps
            if abort is None:
                yield duration
            else:
                timer = Condition(self.sim, f"{self.name}:xfer")
                self.sim.call_after(duration, timer.trigger, category="link")
                yield self.sim.any_of(timer, abort)
                if not timer.triggered:
                    undelivered = nbytes * (1.0 - (self.sim.now - t0)
                                            / duration)
                    self.total_bytes -= max(0.0, undelivered)
                    self.aborted_flows += 1
                    raise TransferAborted(
                        f"{self.name}: dedicated transfer aborted with "
                        f"{undelivered:.0f}/{nbytes:.0f} bytes left")
            return self.sim.now - t0
        self._settle()
        flow = _Flow(self.sim, float(nbytes))
        self._flows.append(flow)
        self.peak_flows = max(self.peak_flows, len(self._flows))
        self._reschedule()
        if abort is None:
            yield flow.done
        else:
            yield self.sim.any_of(flow.done, abort)
            if not flow.done.triggered:
                self._settle()
                if flow in self._flows:
                    self._flows.remove(flow)
                # total_bytes reports DELIVERED traffic: give back what the
                # withdrawn flow never moved
                self.total_bytes -= max(0.0, flow.remaining)
                self.aborted_flows += 1
                self._reschedule()
                raise TransferAborted(
                    f"{self.name}: transfer aborted with "
                    f"{flow.remaining:.0f}/{nbytes:.0f} bytes left")
        return self.sim.now - t0

    def stats(self) -> dict:
        return {"name": self.name,
                "capacity_Bps": self.capacity_Bps,
                "latency_s": self.latency_s,
                "shared": self.shared,
                "total_bytes": int(self.total_bytes),
                "peak_flows": self.peak_flows,
                "aborted_flows": self.aborted_flows}
