"""A training cell: the port's ``TrainerWorker`` fed batch ids in a closed
loop (the next id the moment a step ends, so a backlog always waits), and
migrated by ``ms2m_statefulset`` at a fixed point of the window.

Set-up builds the worker over the benchmark's weights and drives it
through its first steps by its own ``process``: those steps are the ones
the plain reference follows (loss, first gradient, parameter change).
The same worker then trains through the window.  The migration
checkpoints it (``state_tree``) and pushes the image on a second thread
while it goes on training; then the source stops, the target is built,
pulls and restores the image and replays the batch ids from the
checkpoint to the source's last one, and takes over.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from harness import program
from harness.cell import load_model
from harness.record import Clock, Migration, Record, Step
from harness.trace import Tracer, span
from harness.traffic import TrainBatches
from harness.weights import draw_params, draw_row, flat_leaves, stacked_rows


class Msg:
    __slots__ = ("msg_id", "payload")

    def __init__(self, batch_id: int):
        self.msg_id, self.payload = batch_id, {"batch_id": batch_id}


class TrainCell:
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
        tr = traffic["trace"]
        self.tracer = Tracer(trace, tr["at_s"], tr["seconds"], self.clock)
        self.batches = TrainBatches(traffic, self.run["vocab_size"], seed)
        self.rec.tokens_per_batch = self.batches.tokens_per_batch()
        self.log: List[int] = []
        self.readings: Dict[str, object] = {}
        self.mig: Optional[dict] = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        params = draw_params(self.run, self.seed, self.device,
                             self.model.layout(self.run))
        self.worker = program.trainer(self.cfg, self.traffic, params,
                                      self.batches, "trainer-0", self.device)
        b1 = self.traffic["optimizer"]["b1"]
        losses = []
        for i in range(int(self.traffic["check_steps"])):
            self._apply(self.worker, i)
            losses.append(self.worker.last_loss)
            if i == 0:
                # the first clipped gradient as the optimizer got it, from
                # its first moment (m = (1 - b1) g), kept on the host
                grad = {k: m.float() / (1.0 - b1)
                        for k, m in self._moments("m").items()}
                self.readings["grad_norm"] = {k: float(g.norm())
                                              for k, g in grad.items()}
                self.readings["grad"] = {k: g.cpu() for k, g in grad.items()}
                del grad
        self.readings["loss"] = losses
        self.readings["change_norm"] = self._change_norms()
        self.rec.steps.clear()
        _sync(self.device)

    def _moments(self, which: str) -> Dict[str, torch.Tensor]:
        """path -> the AdamW moment ``which`` of that param leaf."""
        end = "/" + which
        return {k[:-len(end)]: v for k, v in
                flat_leaves(self.worker.opt_state["mu"]).items()
                if k.endswith(end)}

    def _change_norms(self) -> Dict[str, float]:
        """Each leaf's distance from the weights drawn at the start."""
        now = flat_leaves(self.worker.params)
        out = {}
        for path, (shape, scale, rows) in self.model.layout(self.run).items():
            p = now[path]
            if stacked_rows(self.run, rows):
                sq = 0.0
                for g in range(p.shape[0]):
                    w0 = draw_row(self.seed, path, g, shape, scale, p.device)
                    sq += float((p[g] - w0).square().sum())
                out[path] = sq ** 0.5
            else:
                w0 = draw_row(self.seed, path, -1, shape, scale, p.device)
                out[path] = float((p - w0).norm())
        return out

    # ------------------------------------------------------------ the loop
    def _apply(self, worker, batch_id: int, live: bool = False) -> None:
        t0 = self.clock.now
        with span("train_step"):
            worker.process(Msg(batch_id))
        t1 = self.clock.now
        self.rec.steps.append(Step(t0, t1, worker.name, "train"))
        if live and t1 <= self.window_s:
            self.rec.trained.append((t1, batch_id))
        if t1 < self.window_s:      # the profile closes after the window
            self.tracer.poll(t1)

    def window(self) -> None:
        sched = self.traffic["migrations"]
        due_mig = [sched["first_s"] + i * sched["every_s"]
                   for i in range(int(sched["count"]))]
        self.next_id = int(self.traffic["check_steps"])
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
            if self.mig is not None and not self.mig["thread"].is_alive():
                self._cutover()
                continue
            self._next(live=True)
        self.rec.attempted = len(self.rec.trained)

    # --------------------------------------------------------- migrations
    def _begin_migration(self) -> None:
        rec = Migration(self.traffic["strategy"], self.clock.now)
        self.rec.migrations.append(rec)
        with span("checkpoint"):
            snapshot = self.worker.state_tree()
        rec.checkpoint_index = len(self.log)
        m = {"rec": rec, "error": None, "reg": program.registry()}
        m["thread"] = threading.Thread(target=self._push,
                                       args=(m, snapshot), daemon=True)
        self.mig = m
        m["thread"].start()

    def _push(self, m: dict, snapshot) -> None:
        rec, reg = m["rec"], m["reg"]
        try:
            with span("push"):
                rec.t_push0 = self.clock.now
                rep = reg.push_image({"state": snapshot})
                reg.store.wait()
                rec.t_push1 = self.clock.now
            rec.push_bytes = rep.total_bytes
            m["image"] = rep.image_id
        except BaseException as e:          # noqa: BLE001 - re-raised on the loop
            m["error"] = e
            raise

    def _cutover(self) -> None:
        """Stop the source, release its identity, restore the target from
        the pushed image and replay to the cutoff id, then switch."""
        m = self.mig
        rec, reg = m["rec"], m["reg"]
        if m["error"] is not None:
            raise RuntimeError("checkpoint push failed") from m["error"]
        rec.t_stop = self.clock.now
        rec.t_last_source = self.rec.steps[-1].t1 if self.rec.steps else rec.t_stop
        source = self.worker
        upto = len(self.log)
        with span("pull"):
            trees, _ = reg.pull_image(m["image"])
        program.close_registry(reg)
        with span("restore"):
            shells = program.empty_like_tree(source.params)
            target = program.trainer(self.cfg, self.traffic, shells,
                                     self.batches,
                                     f"trainer-{len(self.rec.migrations)}",
                                     self.device)
            del shells
            target.load_state(trees["state"])
            del trees
            _sync(self.device)
        rec.t_ready = self.clock.now
        t0 = self.clock.now
        with span("replay"):
            for batch_id in self.log[rec.checkpoint_index:upto]:
                self._apply(target, batch_id)
                rec.replay_entries += 1
        rec.replay_s = self.clock.now - t0
        with span("verify"):
            rec.state_equal = _same(target, source)
        self.worker = target
        del source
        rec.t_switch = self.clock.now
        self.mig = None
        if rec.t_switch < self.window_s:
            self._next(live=True)
            rec.t_first_target = self.rec.steps[-1].t1

    def _next(self, live: bool) -> None:
        """The next batch id, logged and trained by the primary."""
        self.log.append(self.next_id)
        self._apply(self.worker, self.next_id, live=live)
        self.next_id += 1

    def close(self) -> None:
        if self.mig is not None:
            self.mig["thread"].join()
            program.close_registry(self.mig["reg"])
            self.mig = None
        self.rec.trace = self.tracer.finish()

    def exactly_once(self) -> int:
        """Batch ids not folded exactly once, in order, into the primary."""
        w = self.worker
        want = int(self.traffic["check_steps"]) + len(self.log)
        ok = (w.step == want and w.n_processed == want
              and self.log == list(range(int(self.traffic["check_steps"]),
                                         want)))
        return 0 if ok else max(1, abs(want - w.step))

    def free(self) -> None:
        self.worker = None


def _same(a, b) -> bool:
    """The two workers' params and AdamW moments equal bit for bit."""
    if a.step != b.step:
        return False
    la = flat_leaves({"p": a.params, "o": a.opt_state["mu"]})
    lb = flat_leaves({"p": b.params, "o": b.opt_state["mu"]})
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
