"""Train / serve step builders + sharding derivation.

Port of ``repro.train.step``.  ``build_train_step``, ``build_decode_step``
and ``build_prefill_step`` return plain functions with the reference's
signatures and results.  The reference jits them; here they run eagerly.
The train step updates ``params`` and ``opt_state`` in place
(``optim.adamw``) and returns them.

The ``*_shardings`` helpers derive ``NamedSharding``s for every carried
tree from the logical-axis trees (with the shape-aware divisibility
fallback), and ``input_specs`` builds meta-tensor stand-ins for every
model input: nothing is allocated, so a 397.7 B-param config costs no
memory.  ``distribute`` places params, optimizer state, caches and
batches as DTensors on a ``DeviceMesh``; the step functions then run on
them unchanged, each kernel on its local shards (``kernels.ops``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding.rules import (DEFAULT_RULES, AxisRules,
                                        NamedSharding, logical_to_spec,
                                        map_axes)
from repro_torch.tree import flatten, leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    unroll: bool = False  # accepted for the reference's API; no effect here
    param_dtype: str = "float32"  # bfloat16 halves FSDP all-gather bytes
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000


def arch_rules(cfg: ModelConfig) -> AxisRules:
    rules = DEFAULT_RULES
    if cfg.attn_sharding == "seq":
        rules = rules.overriding(seq="model", act_heads=None, act_qout=None)
    if cfg.num_experts and cfg.expert_sharding == "replicated":
        # small-MoE regime: expert weights replicate over `model` (still
        # FSDP-sharded over `data`)
        rules = rules.overriding(experts=None)
    return rules


def decode_rules(cfg: ModelConfig) -> AxisRules:
    """Decode-time activation rules: q is [B,1,H,hd] (tiny) while the KV
    cache's seq axis is model-sharded; decode-time heads are replicated."""
    return arch_rules(cfg).overriding(act_heads=None, act_qout=None)


# ---------------------------------------------------------------------------
# sharding derivation
# ---------------------------------------------------------------------------

def _shardings_from(mesh, axes_tree, shapes_tree, rules):
    return map_axes(
        lambda ax, shp: NamedSharding(
            mesh, logical_to_spec(ax, mesh, rules, dims=tuple(shp.shape))),
        axes_tree, shapes_tree)


def param_shapes_and_axes(cfg: ModelConfig, param_dtype: str = "float32"):
    """-> (meta tensors of the params, their logical axes), from the spec
    tree: no weight is drawn or allocated."""
    dt = None if param_dtype == "float32" else getattr(torch, param_dtype)
    return common.split_params(T.lm_specs(cfg), dt)


def train_state_shardings(cfg: ModelConfig, mesh,
                          opt_cfg: adamw.AdamWConfig,
                          rules: Optional[AxisRules] = None,
                          param_dtype: str = "float32"):
    """-> (param_shapes, param_shardings, opt_shapes, opt_shardings); the
    shapes are meta tensors."""
    rules = rules or arch_rules(cfg)
    p_shapes, p_axes = param_shapes_and_axes(cfg, param_dtype)
    p_shard = _shardings_from(mesh, p_axes, p_shapes, rules)
    o_shapes = adamw.adamw_init(p_shapes, opt_cfg)

    def _mu_axes(ax, shp):
        """Moment axes mirror the parameter's; factored moments drop dims."""
        if opt_cfg.factored and adamw._factorable(shp.shape):
            v = {"row": ax[:-1], "col": ax[:-2] + ax[-1:]}
        else:
            v = ax
        return {"m": ax, "v": v}

    o_axes = {"count": (), "mu": map_axes(_mu_axes, p_axes, p_shapes)}
    o_shard = _shardings_from(mesh, o_axes, o_shapes, rules)
    return p_shapes, p_shard, o_shapes, o_shard


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, tuple]:
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.frontend == "audio_frames":
        axes["frames"] = ("batch", None, "act_embed")
    if cfg.frontend == "image_patches":
        axes["patch_embeds"] = ("batch", None, "act_embed")
        axes["positions"] = (None, "batch", None)  # [3,B,S] m-rope ids
    return axes


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this shape, in the
    reference's dtypes."""
    B, S = shape.batch, shape.seq

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        specs = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S), i32)}
    else:  # decode: one new token, cache of length S
        specs = {"tokens": spec((B, 1), i32), "positions": spec((B, 1), i32)}
    if cfg.frontend == "audio_frames" and shape.kind != "decode":
        specs["frames"] = spec((B, cfg.encoder_seq, cfg.d_model), f32)
    if cfg.frontend == "image_patches" and shape.kind != "decode":
        specs["patch_embeds"] = spec((B, cfg.num_patches, cfg.d_model), f32)
        if cfg.rope_kind == "mrope":
            specs["positions"] = spec((3, B, S), i32)
    return specs


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    rules: Optional[AxisRules] = None):
    rules = rules or arch_rules(cfg)
    axes = batch_logical_axes(cfg, shape)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        ax = axes.get(k)
        if k == "positions":  # [B,1] decode vs [3,B,S] m-rope prefill
            ax = ((None, "batch", None) if spec.dim() == 3
                  else ("batch", None))
        if ax is None:
            ax = ("batch",) + (None,) * (spec.dim() - 1)
        out[k] = NamedSharding(mesh, logical_to_spec(
            ax, mesh, rules, dims=tuple(spec.shape)))
    return out


def cache_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    rules: Optional[AxisRules] = None):
    """-> (the cache's meta tensors, their shardings)."""
    rules = rules or arch_rules(cfg)
    shapes = T.init_cache(cfg, shape.batch, shape.seq, device="meta")
    return shapes, _shardings_from(mesh, T.cache_logical_axes(cfg), shapes,
                                   rules)


def distribute(tree, shardings):
    """Place every tensor of ``tree`` as a DTensor on its sharding's mesh
    and placements (``shardings`` has ``tree``'s structure).  Every rank
    passes the same full tensors; a meta tensor becomes a meta DTensor."""
    from torch.distributed.tensor import distribute_tensor

    flat, treedef = flatten(tree)
    shards = flatten(shardings)[0]
    assert len(flat) == len(shards), (len(flat), len(shards))
    return unflatten(treedef, [
        distribute_tensor(t, s.mesh, list(s.placements))
        for t, s in zip(flat, shards)])


def _dtensor_context(tree):
    """``implicit_replication`` where ``tree`` holds DTensors: the plain
    tensors a step makes (positions, masks, the schedule's lr) then enter
    DTensor ops as replicated; else nothing."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in leaves(tree)):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _like_params(grads, params):
    """Gradients of DTensor params redistributed to their params'
    placements (autograd may leave a contraction's gradient partial)."""
    from torch.distributed.tensor import DTensor

    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(p, DTensor) and g.placements != p.placements
            else g for g, p in zip(grads, params)]


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

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
            grads = _like_params(torch.autograd.grad(loss, inputs), flat)
        return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
                unflatten(treedef, list(grads)))

    def train_step(params, opt_state, batch, step):
        with _dtensor_context(params):
            return _train_step(params, opt_state, batch, step)

    def _train_step(params, opt_state, batch, step):
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
        with _dtensor_context(params):
            return T.lm_decode_step(params, tokens, positions, cfg, cache)

    return decode_step


def build_prefill_step(cfg: ModelConfig, unroll: bool = False):
    def prefill_step(params, cache, batch):
        with _dtensor_context(params):
            return T.lm_prefill(params, batch, cfg, cache)

    return prefill_step
