"""Deterministic fault injection for the virtual-time cluster.

Real clusters lose nodes, links, registries and broker channels *mid-
migration*; the paper's pipeline (and the seed sim) assumed the
migration itself succeeds.  This module makes the hard scenarios
reproducible: a :class:`FaultSchedule` is a list of :class:`Fault`
entries fired either at exact sim times or at strategy-phase triggers
("during pre-copy round 2"), armed as sim processes by a
:class:`FaultInjector` (``Cluster(faults=...)`` wires one up; the CLI's
``--fault`` flag parses the same specs).

Fault kinds:

  * ``node_crash``      — hard kill: pods on the node die (``kill_node``);
    with ``duration`` the (empty) node revives afterwards;
  * ``node_flap``       — soft partition: the node drops off the network
    for ``duration`` seconds (pods stall in place, in-flight transfers
    abort) then revives and its pods resume (``partition_node`` /
    ``revive_node``);
  * ``link_degrade``    — the node's registry link runs at ``factor`` x
    capacity for ``duration`` seconds (shared links re-plan in-flight
    flows at the new rate);
  * ``registry_outage`` — every push/pull/prefetch fails fast and
    in-flight registry flows abort for ``duration`` seconds;
  * ``broker_stall``    — a queue (or every queue) stops delivering for
    ``duration`` seconds; publishes still land, so the stall delays but
    never loses messages.

Scheduling:

  * ``at=<t>``     — fire at absolute sim time ``t``;
  * ``phase=<p>``  — fire when a migration emits a matching trace event:
    ``"checkpoint"`` (or any phase name) matches that phase's boundary
    event, ``"precopy_round:2"`` matches pre-copy round 2's completion,
    any other event kind (``"cutoff_fired"``, ...) matches by kind.
    ``after`` delays the firing past the trigger.  Phase triggers fire
    once, on the first match.

``FaultSchedule.random(seed, ...)`` generates a seeded-random schedule —
the same seed always yields the same schedule, so chaos runs are
bit-reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

FAULT_KINDS = ("node_crash", "node_flap", "link_degrade",
               "registry_outage", "broker_stall")

_NODE_KINDS = ("node_crash", "node_flap", "link_degrade")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure: what, where, and when (time or phase)."""

    kind: str
    at: Optional[float] = None       # absolute sim time
    phase: Optional[str] = None      # strategy-phase trigger (see module doc)
    node: Optional[str] = None       # node_crash / node_flap / link_degrade
    queue: Optional[str] = None      # broker_stall (None = every queue)
    duration: float = 0.0            # flap/outage/stall/degrade window
    factor: float = 0.25             # link_degrade capacity multiplier
    after: float = 0.0               # extra delay past a phase trigger

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {list(FAULT_KINDS)}")
        if (self.at is None) == (self.phase is None):
            raise ValueError(
                f"fault {self.kind!r} needs exactly one of at= / phase=")
        if self.kind in _NODE_KINDS and self.node is None:
            raise ValueError(f"fault {self.kind!r} needs node=")
        if self.kind in ("node_flap", "link_degrade", "registry_outage",
                         "broker_stall") and self.duration <= 0:
            raise ValueError(f"fault {self.kind!r} needs duration > 0")
        if self.kind == "link_degrade" and not 0 < self.factor < 1:
            raise ValueError("link_degrade needs 0 < factor < 1")
        if self.phase is not None and self.phase.startswith("precopy_round:"):
            want = self.phase.partition(":")[2]
            try:
                int(want)
            except ValueError:
                raise ValueError(
                    f"fault phase {self.phase!r}: the round after "
                    "'precopy_round:' must be an integer") from None

    def row(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind}
        for f in ("at", "phase", "node", "queue"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        if self.duration:
            out["duration"] = self.duration
        if self.kind == "link_degrade":
            out["factor"] = self.factor
        if self.after:
            out["after"] = self.after
        return out


def parse_fault(spec: str) -> Fault:
    """Parse a CLI fault spec: ``kind@trigger[,key=value,...]``.

    The trigger is an absolute sim time when it parses as a float, else a
    phase spec.  Examples::

        node_flap@12,node=node1,duration=5
        node_crash@8.5,node=node2
        registry_outage@phase:precopy_round:1,duration=8
        link_degrade@20,node=node1,duration=10,factor=0.1
        broker_stall@15,queue=orders,duration=4
    """
    head, *pairs = spec.split(",")
    if "@" not in head:
        raise ValueError(f"fault spec {spec!r}: expected kind@trigger")
    kind, trigger = head.split("@", 1)
    kw: Dict[str, Any] = {}
    if trigger.startswith("phase:"):
        kw["phase"] = trigger[len("phase:"):]
    else:
        try:
            kw["at"] = float(trigger)
        except ValueError:
            kw["phase"] = trigger
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"fault spec {spec!r}: bad pair {pair!r}")
        k, v = pair.split("=", 1)
        k = k.strip()
        if k in ("duration", "factor", "after", "at"):
            kw[k] = float(v)
        elif k in ("node", "queue", "phase"):
            kw[k] = v.strip()
        else:
            raise ValueError(f"fault spec {spec!r}: unknown key {k!r}")
    return Fault(kind=kind.strip(), **kw)


class FaultSchedule:
    """An ordered, immutable collection of faults (sorted by fire time;
    phase-triggered faults keep their declaration order at the end)."""

    def __init__(self, faults: Iterable[Fault] = ()):
        timed = [f for f in faults if f.at is not None]
        phased = [f for f in faults if f.at is None]
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(timed, key=lambda f: f.at) + phased)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def rows(self) -> List[Dict[str, Any]]:
        return [f.row() for f in self.faults]

    @classmethod
    def random(cls, seed: int, *,
               n_faults: int = 3,
               t_window: Tuple[float, float] = (5.0, 60.0),
               nodes: Sequence[str] = (),
               queues: Sequence[str] = (),
               kinds: Sequence[str] = FAULT_KINDS,
               flap_s: Tuple[float, float] = (1.0, 8.0),
               outage_s: Tuple[float, float] = (1.0, 8.0),
               stall_s: Tuple[float, float] = (1.0, 6.0),
               degrade_factor: Tuple[float, float] = (0.05, 0.5),
               degrade_s: Tuple[float, float] = (2.0, 12.0)
               ) -> "FaultSchedule":
        """Seeded-random schedule: same seed => same schedule => (given a
        deterministic workload) the same sim, bit for bit.

        Node-targeted kinds draw from ``nodes`` (pass only target-side
        nodes to keep migration *sources* safe); ``broker_stall`` draws
        from ``queues``.  Kinds that have no candidates are skipped.
        """
        import numpy as np

        rng = np.random.default_rng(seed)
        usable = [k for k in kinds
                  if not (k in _NODE_KINDS and not nodes)
                  and not (k == "broker_stall" and not queues)]
        if not usable:
            return cls(())
        faults: List[Fault] = []
        for _ in range(n_faults):
            kind = usable[int(rng.integers(0, len(usable)))]
            at = float(rng.uniform(*t_window))
            kw: Dict[str, Any] = {"kind": kind, "at": round(at, 3)}
            if kind in _NODE_KINDS:
                kw["node"] = nodes[int(rng.integers(0, len(nodes)))]
            if kind == "node_flap":
                kw["duration"] = round(float(rng.uniform(*flap_s)), 3)
            elif kind == "registry_outage":
                kw["duration"] = round(float(rng.uniform(*outage_s)), 3)
            elif kind == "broker_stall":
                kw["queue"] = queues[int(rng.integers(0, len(queues)))]
                kw["duration"] = round(float(rng.uniform(*stall_s)), 3)
            elif kind == "link_degrade":
                kw["factor"] = round(float(rng.uniform(*degrade_factor)), 3)
                kw["duration"] = round(float(rng.uniform(*degrade_s)), 3)
            faults.append(Fault(**kw))
        return cls(faults)


def make_schedule(faults: Any) -> FaultSchedule:
    """Resolve a faults argument: a ready FaultSchedule, a single Fault or
    spec string, or a list mixing Faults and spec strings."""
    if isinstance(faults, FaultSchedule):
        return faults
    if isinstance(faults, Fault):
        return FaultSchedule([faults])
    if isinstance(faults, str):
        return FaultSchedule([parse_fault(faults)])
    return FaultSchedule([f if isinstance(f, Fault) else parse_fault(f)
                          for f in faults])


class FaultInjector:
    """Arms a FaultSchedule against one APIServer: timed faults become
    ``sim.call_at`` firings, phase faults subscribe to the migration
    event stream.  ``log`` records every action taken, in firing order."""

    def __init__(self, api, schedule: FaultSchedule):
        self.api = api
        self.sim = api.sim
        self.schedule = schedule
        self.log: List[Dict[str, Any]] = []
        self._armed = False
        # overlapping-window bookkeeping: the registry comes back / a queue
        # unstalls / a link regains full capacity only when the LAST
        # overlapping window ends
        self._outage_depth = 0
        self._stall_depth: Dict[str, int] = {}
        self._degraded: Dict[str, List] = {}  # link name -> [base_Bps, depth]
        # nodes a permanent (duration-less) node_crash killed: a revive
        # scheduled by an earlier flap/timed crash must not resurrect them
        self._crashed: set = set()

    # -- arming ---------------------------------------------------------------
    def arm(self) -> "FaultInjector":
        if self._armed:
            return self
        self._armed = True
        phased = []
        for fault in self.schedule:
            if fault.at is not None:
                self.sim.call_at(fault.at,
                                 (lambda f=fault: self._fire(f)))
            else:
                phased.append({"fault": fault, "fired": False})
        if phased:
            def on_event(kind: str, t: float, data: dict):
                for entry in phased:
                    f = entry["fault"]
                    if entry["fired"] or not _phase_match(f.phase, kind,
                                                          data):
                        continue
                    entry["fired"] = True
                    if f.after > 0:
                        self.sim.call_after(f.after,
                                            (lambda f=f: self._fire(f)))
                    else:
                        self._fire(f)

            self.api.add_migration_listener(on_event)
        return self

    # -- firing ---------------------------------------------------------------
    def _note(self, fault: Fault, action: str, **kw):
        self.log.append({"t": round(self.sim.now, 6), "action": action,
                         **fault.row(), **kw})

    def _fire(self, fault: Fault) -> None:
        api = self.api
        if fault.kind == "node_crash":
            node = api.nodes.get(fault.node)
            if node is None or (not node.alive and not node.pods):
                # unknown node, or already hard-dead; a PARTITIONED node
                # (down but pods intact) is still crashable — the kill
                # must land so a pending flap revive cannot resurrect a
                # node this fault declared dead.  A permanent crash on an
                # already-dead node still declares permanence: any revive
                # a TIMED crash scheduled earlier must not undo it
                if fault.duration <= 0 and node is not None:
                    self._crashed.add(fault.node)
                self._note(fault, "skipped")
                return
            api.kill_node(fault.node)
            self._note(fault, "fired")
            if fault.duration > 0:
                self.sim.call_after(fault.duration,
                                    lambda: self._revive(fault))
            else:
                self._crashed.add(fault.node)
        elif fault.kind == "node_flap":
            node = api.nodes.get(fault.node)
            if node is None or not node.alive:
                self._note(fault, "skipped")
                return
            api.partition_node(fault.node)
            self._note(fault, "fired")
            self.sim.call_after(fault.duration, lambda: self._revive(fault))
        elif fault.kind == "link_degrade":
            if fault.node not in api.nodes:
                # an unknown node would silently resolve to the registry's
                # own intra-zone link (zone() falls back to registry_zone)
                # and degrade the wrong link — skip, like the node kinds
                self._note(fault, "skipped")
                return
            link = api.topology.registry_link(fault.node)
            entry = self._degraded.setdefault(link.name,
                                              [link.capacity_Bps, 0])
            entry[1] += 1  # overlapping degrades compose multiplicatively
            link.set_capacity(link.capacity_Bps * fault.factor)
            self._note(fault, "fired", capacity_Bps=link.capacity_Bps)
            self.sim.call_after(fault.duration,
                                lambda: self._restore_link(fault, link))
        elif fault.kind == "registry_outage":
            self._outage_depth += 1
            if self._outage_depth == 1:
                api.set_registry_up(False)
            self._note(fault, "fired")
            self.sim.call_after(fault.duration,
                                lambda: self._end_outage(fault))
        elif fault.kind == "broker_stall":
            queues = ([fault.queue] if fault.queue is not None
                      else sorted(api.broker.queues))
            for q in queues:
                self._stall_depth[q] = self._stall_depth.get(q, 0) + 1
                mq = api.broker.queues.get(q)
                if mq is not None:
                    mq.stall()
            self._note(fault, "fired", queues=queues)
            self.sim.call_after(fault.duration,
                                lambda: self._unstall(fault, queues))

    def _revive(self, fault: Fault) -> None:
        if fault.node in self._crashed:
            self._note(fault, "revive_superseded_by_crash")
            return
        node = self.api.nodes.get(fault.node)
        if node is not None and not node.alive:
            self.api.revive_node(fault.node)
            self._note(fault, "revived")

    def _restore_link(self, fault: Fault, link) -> None:
        entry = self._degraded[link.name]
        entry[1] -= 1
        if entry[1] == 0:
            # last overlapping window over: restore the pre-degrade
            # capacity bit-exactly (no float round-trip through factors)
            link.set_capacity(entry[0])
            del self._degraded[link.name]
        else:
            link.set_capacity(link.capacity_Bps / fault.factor)
        self._note(fault, "restored", capacity_Bps=link.capacity_Bps)

    def _end_outage(self, fault: Fault) -> None:
        self._outage_depth -= 1
        if self._outage_depth == 0:
            self.api.set_registry_up(True)
        self._note(fault, "ended")

    def _unstall(self, fault: Fault, queues: List[str]) -> None:
        for q in queues:
            self._stall_depth[q] -= 1
            if self._stall_depth[q] == 0:
                mq = self.api.broker.queues.get(q)
                if mq is not None:
                    mq.unstall()
        self._note(fault, "ended", queues=queues)


def _phase_match(spec: str, kind: str, data: dict) -> bool:
    """Does an emitted migration event match a phase trigger spec?

    ``"precopy_round:N"`` matches pre-copy round N's completion event;
    a bare phase name (``"checkpoint"``, ``"cutover"``, ...) matches that
    phase's boundary event; anything else matches by event kind
    (``"cutoff_fired"``, ``"migration_end"``, ...).
    """
    if spec.startswith("precopy_round"):
        if kind != "precopy_round":
            return False
        _, _, want = spec.partition(":")
        return not want or data.get("round") == int(want)
    if kind == "phase":
        return data.get("phase") == spec
    return kind == spec
