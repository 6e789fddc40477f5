"""Train / serve step functions.

Port of the step functions of ``repro.train.step``: ``build_train_step``,
``build_decode_step`` and ``build_prefill_step`` return plain functions
with the reference's signatures and results.  The reference jits them;
here they run eagerly.  The train step updates ``params`` and
``opt_state`` in place (``optim.adamw``) and returns them.  The
reference's sharding helpers (``arch_rules``, ``*_shardings``,
``input_specs``) belong to the multi-device port and are not here yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import flatten, leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    unroll: bool = False  # accepted for the reference's API; no effect here
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000


def build_train_step(cfg: ModelConfig, tcfg: TrainStepConfig):
    """-> train_step(params, opt_state, batch, step) -> (params', opt', metrics).

    ``batch`` holds ``tokens`` and ``labels`` tensors on the params'
    device; ``step`` is an int or an integer tensor (the schedule's
    device).  Metrics: ``loss``, ``xent``, ``aux``, ``tokens``,
    ``grad_norm`` and ``lr``."""
    def loss_and_grads(params, batch):
        flat, treedef = flatten(params)
        with torch.enable_grad():
            inputs = [p.detach().requires_grad_() for p in flat]
            loss, metrics = T.lm_loss(unflatten(treedef, inputs), batch, cfg,
                                      remat=tcfg.remat, unroll=tcfg.unroll)
            grads = torch.autograd.grad(loss, inputs)
        return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
                unflatten(treedef, list(grads)))

    def train_step(params, opt_state, batch, step):
        n = tcfg.microbatches
        if n > 1:
            # gradient accumulation in float32, one microbatch's
            # activations live at a time
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            losses, mets = [], []
            for j in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[j]
                      for k, x in batch.items()}
                loss_j, met_j, g = loss_and_grads(params, mb)
                acc = [a + gj.float() for a, gj in zip(acc, leaves(g))]
                losses.append(loss_j)
                mets.append(met_j)
            grads = unflatten(flatten(params)[1], [a / n for a in acc])
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        else:
            loss, metrics, grads = loss_and_grads(params, batch)
        lr = cosine_schedule(step, peak=tcfg.lr_peak,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        params, opt_state, opt_metrics = adamw.adamw_update(
            params, grads, opt_state, tcfg.opt, lr=lr)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def build_decode_step(cfg: ModelConfig, unroll: bool = False):
    def decode_step(params, cache, tokens, positions):
        return T.lm_decode_step(params, tokens, positions, cfg, cache)

    return decode_step


def build_prefill_step(cfg: ModelConfig, unroll: bool = False):
    def prefill_step(params, cache, batch):
        return T.lm_prefill(params, batch, cfg, cache)

    return prefill_step
