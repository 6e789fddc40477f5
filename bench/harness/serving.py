"""A serving cell: the port's engine behind ``ServingWorker``, opened on a
replica in full service and migrated at fixed points of the window.

Every slot holds a session when the window opens: its history folded in
set-up by the port's prefill and restored into the engine through its own
``load_state``; a session whose output ends in the window frees its slot,
and no new session is admitted (the replica is being drained).  The
replica's message log is what MS2M replays: one decode round
(``ServingEngine.step``) a message.  The source serves on the main
thread; a migration checkpoints it with ``state_tree`` and pushes, pulls
and restores the target on a second thread (``bench.push``,
``bench.pull``, ``bench.restore``) while the source goes on serving, in
the order of the cell's strategy:

``ms2m_cutoff``: the port's ``CutoffController`` sets the accumulation
deadline (Eq. 5) when the checkpoint is taken.  Once the target is
restored it replays the log beside the source until it has caught up, or
the deadline stops the source first; the target then replays the rest of
the log, is held bit for bit to the stopped source, and takes over.

Every token is timed when the host holds it.  A session's completion is
delivered once, through the port's ``CompletionLedger``; a second
completion of it (by the target, replaying what the source had already
finished) must carry the same tokens.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import program
from harness.cell import load_model
from harness.record import Clock, Migration, Record, Step
from harness.trace import Tracer, span
from harness.traffic import initial_sessions
from harness.weights import draw_params


class Replica:
    """A ServingWorker over its own engine, its steps timed and, while it
    is the primary, its tokens recorded."""

    def __init__(self, cell: "ServeCell", name: str, params):
        t = cell.traffic
        self.cell = cell
        self.engine = program.ServingEngine(cell.cfg, params, t["num_slots"],
                                            t["max_seq"], name=name)
        self.worker = program.ServingWorker(self.engine, ledger=None,
                                            decode_rounds=0)
        self.name = name
        self.applied = 0            # log entries applied
        self._hook()

    def _hook(self) -> None:
        eng, cell = self.engine, self.cell
        step = eng._engine_step

        def timed(forced=None):
            valid = sum(int(eng.positions[s]) + 1 if eng.active[s] else 1
                        for s in range(eng.num_slots))
            t0 = cell.clock.now
            with span("engine_step"):
                out = step(forced)
            t1 = cell.clock.now
            cell.rec.steps.append(Step(t0, t1, self.name, "decode", valid))
            if self is cell.primary:
                cell.last_source_step = t1
                cell.collect(self, t1)
            cell.on_step(t1)
            return out

        eng._engine_step = timed

    def apply(self) -> None:
        """The next message of the log: one decode round."""
        self.engine.step(1)
        self.applied += 1
        self.cell.collect(self, self.cell.clock.now)


class ServeCell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, workload: str = "",
                 model=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.run, self.window_s = config["run"], float(seconds)
        self.device = torch.device(device)
        self.cfg = program.model_config(config)
        self.model = load_model(config) if model is None else model
        self.clock = Clock()
        self.rec = Record(workload, self.run, traffic, self.window_s,
                          model=self.model)
        self.ledger = program.CompletionLedger(self.clock)
        tr = traffic["trace"]
        self.tracer = Tracer(trace, tr["at_s"], tr["seconds"], self.clock)
        self.log = 0                # messages logged: decode rounds
        self.primary: Optional[Replica] = None
        self.mig: Optional[dict] = None
        self.last_source_step = 0.0
        self.delivered: Dict[int, List[int]] = {}
        self.altered: List[int] = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        self.params = draw_params(self.run, self.seed, self.device,
                                  self.model.layout(self.run))
        self.primary = Replica(self, "replica-0", self.params)
        eng = self.primary.engine
        for _ in range(int(self.traffic["warmup_steps"])):
            eng._engine_step()      # every lane decodes: the step's shapes
        self.prompts: Dict[int, List[int]] = {}
        self._fill(eng)
        # the registry's path once at a small size: its thread pools and
        # the fingerprint kernel come up in set-up, not in the window
        reg = program.registry()
        probe = {"x": torch.zeros(1 << 20, device=self.device)}
        reg.pull_image(reg.push_image(probe).image_id)
        program.close_registry(reg)
        self.rec.steps.clear()
        _sync(self.device)

    def _fill(self, eng) -> None:
        """Open the window on a replica in service: every slot holds a
        session whose prompt the port's prefill folded in, restored into
        the engine through its own ``load_state``."""
        sessions = initial_sessions(self.traffic, self.run["vocab_size"],
                                    self.seed)
        first = program.prefill_sessions(
            eng, self.cfg, self.params, [a.prompt for a in sessions],
            int(self.traffic["initial"]["prefill_rows"]))
        n, ms = eng.num_slots, eng.max_seq
        gen = np.zeros((n, ms), np.int32)
        gen[:len(sessions), 0] = first
        pad = n - len(sessions)
        slots = {
            "positions": np.array([len(a.prompt) for a in sessions] + [0] * pad),
            "active": np.array([True] * len(sessions) + [False] * pad),
            "budget": np.array([a.max_new_tokens - 1 for a in sessions] + [0] * pad),
            "last_token": np.array(first + [0] * pad, np.int64),
            "request": np.array([a.request_id for a in sessions] + [-1] * pad),
            "gen_len": np.array([1] * len(sessions) + [0] * pad),
            "gen": gen,
        }
        eng.load_state({"cache": eng.cache, "slots": slots, "scalars": {
            "last_msg_id": np.int64(-1), "n_processed": np.int64(0)}})
        for a, tok in zip(sessions, first):
            self.prompts[a.request_id] = a.prompt
            self.rec.prompt_len[a.request_id] = len(a.prompt)
            self.rec.served[a.request_id] = [(-1.0, tok)]
            self.ledger.submitted[a.request_id] = -1.0

    # ------------------------------------------------------------- tokens
    def collect(self, rep: Replica, t: float) -> None:
        """Record the tokens the primary has newly produced (time ``t``),
        and move every finished request into the ledger."""
        eng = rep.engine
        live = rep is self.primary and t <= self.window_s
        if live:
            for rid, toks in eng.generated.items():
                self._served(rid, toks, t)
        while eng.completions:
            c = eng.completions.pop(0)
            if live:
                self._served(c.request_id, c.tokens, t)
            if self.ledger.complete(c.request_id, by=rep.name,
                                    tokens=len(c.tokens)):
                self.delivered[c.request_id] = list(c.tokens)
                if 0.0 <= t <= self.window_s:
                    self.rec.completed.append((t, c.request_id))
            elif list(c.tokens) != self.delivered.get(c.request_id):
                self.altered.append(c.request_id)

    def _served(self, rid: int, toks: List[int], t: float) -> None:
        seen = self.rec.served.setdefault(rid, [])
        for tok in toks[len(seen):]:
            seen.append((t, int(tok)))

    # ------------------------------------------------------------ the loop
    def on_step(self, t: float) -> None:
        if t < self.window_s:       # the profile closes after the window
            self.tracer.poll(t)
        m = self.mig
        if (m is not None and m["deadline"] is not None and not m["fired"]
                and m["stop_at"] is None and t >= m["deadline"]):
            m["fired"] = True       # the source stops after this message

    def window(self) -> None:
        sched = self.traffic["migrations"]
        due_mig = [sched["first_s"] + i * sched["every_s"]
                   for i in range(int(sched["count"]))]
        self.clock.open()
        self.tracer.arm()
        while True:
            t = self.clock.now
            if t >= self.window_s:
                break
            self.tracer.poll(t)
            if self.mig is None and due_mig and t >= due_mig[0]:
                due_mig.pop(0)
                self._begin_migration()
                continue
            if self.mig is not None and self._migration_step():
                continue
            if self.primary.engine.active.any():
                self._serve()
                continue
            wake = due_mig[0] if due_mig else self.window_s
            time.sleep(max(0.0, min(0.002, wake - t)))
        self.rec.attempted = len(self.ledger.submitted)

    def _serve(self) -> None:
        self.log += 1
        self.primary.apply()
        if self.mig is not None and self.mig["cutoff"] is not None:
            self.mig["cutoff"].observe_arrival(self.clock.now)

    # --------------------------------------------------------- migrations
    def _begin_migration(self) -> None:
        strategy = self.traffic["strategy"]
        k = len(self.rec.migrations)
        rec = Migration(strategy, self.clock.now)
        self.rec.migrations.append(rec)
        m = {"rec": rec, "fired": False, "stop_at": None, "deadline": None,
             "cutoff": None, "thread": None, "error": None, "target": None,
             "ckpt": 0}
        if strategy == "ms2m_cutoff":
            c = self.traffic["cutoff"]
            ctl = program.CutoffController(
                t_replay_max=c["t_replay_max_s"],
                mu_fallback=c["replay_entries_per_s"],
                lam_fallback=c["log_entries_per_s"])
            m["cutoff"] = ctl
            m["deadline"] = rec.t_start + ctl.threshold()
        with span("checkpoint"):
            snapshot = self.primary.worker.state_tree()
        m["ckpt"] = rec.checkpoint_index = self.log
        name = f"replica-{k + 1}"
        th = threading.Thread(target=self._transfer,
                              args=(m, snapshot, name), daemon=True)
        m["thread"] = th
        self.mig = m
        th.start()

    def _transfer(self, m: dict, snapshot, name: str) -> None:
        """Push, pull and restore on the migration's own thread."""
        rec = m["rec"]
        reg = program.registry()
        try:
            with span("push"):
                rec.t_push0 = self.clock.now
                rep = reg.push_image({"state": snapshot})
                reg.store.wait()
                rec.t_push1 = self.clock.now
                rec.push_bytes = rep.total_bytes
            del snapshot
            with span("pull"):
                trees, _ = reg.pull_image(rep.image_id)
            with span("restore"):
                target = Replica(self, name, self.params)
                target.worker.load_state(trees["state"])
                target.applied = m["ckpt"]
                del trees
                _sync(self.device)
            m["target"] = target
            rec.t_ready = self.clock.now
        except BaseException as e:          # noqa: BLE001 - re-raised on the loop
            m["error"] = e
            raise
        finally:
            program.close_registry(reg)

    def _migration_step(self) -> bool:
        """Advance the migration by one move of the main thread; True if
        that move took the thread (the source serves otherwise)."""
        m, rec = self.mig, self.mig["rec"]
        if m["error"] is not None:
            raise RuntimeError("migration transfer failed") from m["error"]
        target = m["target"]
        if m["stop_at"] is None and (m["fired"] or (
                target is not None and target.applied == self.log)):
            # stop the source: the deadline fired, or the target caught up
            m["stop_at"] = self.clock.now
            rec.t_stop = m["stop_at"]
            rec.cutoff_fired = m["fired"]
            src = self.primary.engine
            rec.t_last_source = (self.last_source_step if src.active.any()
                                 else rec.t_stop)
            return True
        if m["stop_at"] is not None:
            if target is None:
                m["thread"].join(timeout=0.002)
                return True
            self._replay(target, self.log)
            self._switch(target)
            return True
        if target is not None and target.applied < self.log:
            self._replay(target, target.applied + 1)   # catch-up, beside the source
            return not self.primary.engine.active.any()
        return False

    def _replay(self, target: Replica, upto: int) -> None:
        m, rec = self.mig, self.mig["rec"]
        t0 = self.clock.now
        with span("replay"):
            while target.applied < upto:
                target.apply()
                rec.replay_entries += 1
                if m["cutoff"] is not None:
                    m["cutoff"].observe_service(self.clock.now)
        rec.replay_s += self.clock.now - t0

    def _switch(self, target: Replica) -> None:
        m, rec = self.mig, self.mig["rec"]
        m["thread"].join()
        with span("verify"):
            rec.state_equal = bool(target.engine.state_equal(
                self.primary.engine, exact=True))
        source = self.primary
        self.primary = target
        rec.t_switch = self.clock.now
        if not target.engine.active.any():
            rec.t_first_target = rec.t_switch
        else:
            n = len(self.rec.steps)
            self._serve()
            rec.t_first_target = next(s.t1 for s in self.rec.steps[n:]
                                      if s.engine == target.name)
        self.mig = None
        source.engine.cache = None

    # ------------------------------------------------------------- after
    def close(self) -> None:
        """After the window: a migration still open keeps its source as the
        primary; its thread is waited for."""
        if self.mig is not None and self.mig["thread"] is not None:
            self.mig["thread"].join()
            self.mig = None
        self.rec.trace = self.tracer.finish()

    def exactly_once(self) -> int:
        """Sessions lost, plus sessions whose served tokens differ from
        what the replica that delivered them completed with, plus second
        completions that differ from the first."""
        in_flight = set(self.primary.engine.request_of_slot.values())
        lost = [r for r in self.ledger.submitted
                if r not in self.ledger.delivered and r not in in_flight]
        altered = [r for r, toks in self.delivered.items()
                   if [t for _, t in self.rec.served.get(r, [])]
                   != toks[:len(self.rec.served.get(r, []))]]
        return len(lost) + len(altered) + len(self.altered)

    def free(self) -> None:
        """Drop the program's state (engines, caches, weights)."""
        self.primary = None
        self.params = None
        self.mig = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)



def sample_requests(cell: ServeCell, n: int) -> List[int]:
    """Requests to judge, drawn from the seed: the one with the most served
    tokens, one served across a migration (where any was), then others."""
    served = {r: v for r, v in cell.rec.served.items() if v}
    if not served:
        return []
    longest = max(served, key=lambda r: (len(served[r]), -r))
    picks = [longest]
    spans = [r for r, v in served.items()
             if any(v[0][0] <= mg.t_start and mg.t_switch is not None
                    and v[-1][0] >= mg.t_switch for mg in cell.rec.migrations)]
    rng = np.random.default_rng(cell.seed % (2 ** 63))
    if spans:
        picks.append(int(rng.choice(sorted(spans))))
    rest = sorted(set(served) - set(picks))
    rng.shuffle(rest)
    picks += rest
    return list(dict.fromkeys(picks))[:n]
