"""MS2M applied to *training* workers.

Port of ``repro.core.trainer_worker``.  The worker's migratable state is
(params, opt_state, step); the "message" is a batch id.  Because the data
pipeline is a pure function of (seed, step) and the train step is
deterministic on the card (fixed-order kernels,
``torch.use_deterministic_algorithms``), the fold
    state_{s+1} = train_step(state_s, batch(s))
is deterministic — so a training worker migrates exactly like a serving
replica: checkpoint image + batch-id journal replay.

The train step updates params and moments in place, so ``state_tree``
returns clones on the worker's device (the source keeps training while
its image is built); a registry push then fingerprints them on the card.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.convert import to_tensor
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as steplib
from repro_torch.tree import leaves, tree_map


class TrainerWorker:
    """Processes batch-id messages; state = (params, opt, step)."""

    def __init__(self, cfg: ModelConfig, tcfg: steplib.TrainStepConfig,
                 dcfg: DataConfig, name: str = "trainer", device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.name = name
        self.device = resolve_device(device)
        self.ds = SyntheticTokenDataset(dcfg)
        self.params = T.init_lm(cfg, seed=0, device=self.device)
        self.opt_state = adamw.adamw_init(self.params, tcfg.opt)
        self.step = 0
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1
        self.last_loss = float("nan")
        self._fn = steplib.build_train_step(cfg, tcfg)

    def process(self, msg) -> None:
        with trace.span("repro_torch.trainer.step"):
            batch_id = int(msg.payload.get("batch_id",
                                           msg.payload.get("token")))
            with trace.span("repro_torch.trainer.dispatch"):
                batch = {k: to_tensor(a, self.device)
                         for k, a in self.ds.batch(batch_id).items()}
                self.params, self.opt_state, metrics = self._fn(
                    self.params, self.opt_state, batch,
                    torch.tensor(self.step, dtype=torch.int32))
            self.step += 1
            with trace.span("repro_torch.trainer.sync"):
                self.last_loss = float(metrics["loss"])
            self.last_msg_id = msg.msg_id
            self.n_processed += 1

    def state_tree(self) -> Dict[str, Any]:
        with trace.span("repro_torch.trainer.state_tree",
                        trace.tree_bytes((self.params, self.opt_state))):
            params = tree_map(torch.clone, self.params)
            opt = tree_map(torch.clone, self.opt_state)
        return {
            "params": params,
            "opt": opt,
            "scalars": {
                "step": np.int64(self.step),
                "last_msg_id": np.int64(self.last_msg_id),
                "n_processed": np.int64(self.n_processed),
            },
        }

    def load_state(self, tree: Dict[str, Any]):
        """Restore from a state tree of numpy arrays (a registry pull, or
        a reference worker's ``state_tree()``) or tensors, copied onto
        this worker's device."""
        with trace.span("repro_torch.trainer.load_state",
                        trace.tree_bytes((tree["params"], tree["opt"]))):
            self.params = tree_map(lambda a: to_tensor(a, self.device),
                                   tree["params"])
            self.opt_state = tree_map(lambda a: to_tensor(a, self.device),
                                      tree["opt"])
        self.step = int(tree["scalars"]["step"])
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])

    def state_equal(self, other: "TrainerWorker", exact: bool = True) -> bool:
        if self.step != other.step or self.last_msg_id != other.last_msg_id:
            return False
        for a, b in zip(leaves(self.params), leaves(other.params)):
            b = b.to(a.device)
            if exact and not torch.equal(a, b):
                return False
            if not exact and not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                return False
        return True
