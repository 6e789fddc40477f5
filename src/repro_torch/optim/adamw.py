"""AdamW built in-repo: decoupled weight decay, global-norm clipping,
optional factored second moment (Adafactor-style).

Port of ``repro.optim.adamw``.  The optimizer state keeps the reference's
tree, ``{"count": int32 scalar, "mu": {leaf: {"m", "v"}}}`` (``v`` is
``{"row", "col"}`` for a factored leaf), so it checkpoints to the same
registry leaves.  ``adamw_update`` writes the new params and moments into
the given tensors **in place** (the reference returns new arrays): at
full width a second copy of params and moments would cost gigabytes.
The per-leaf arithmetic is the reference's, expression for expression.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding.rules import map_axes
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    factored: bool = False  # factored 2nd moment for giant models
    min_factored_dim: int = 128  # unused, as in the reference


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _param_moment_pairs(params, mu):
    """(param, its {"m", "v"} entry) in the reference's leaf order (sorted
    dict keys): ``mu`` has the params' dict structure down to each param."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _param_moment_pairs(params[k], mu[k])
    else:
        yield params, mu


def opt_state_logical_axes(param_axes, cfg: AdamWConfig):
    """Optimizer-state logical axes mirror the parameter axes (FSDP: moments
    shard exactly like their parameter)."""
    def leaf_axes(ax):
        if cfg.factored:
            # factorability needs the shapes: ``train.step`` derives the
            # factored moments' axes from them
            raise NotImplementedError
        return {"m": ax, "v": ax}

    return {"count": (), "mu": map_axes(leaf_axes, param_axes)}


def adamw_init(params, cfg: AdamWConfig):
    mdt = getattr(torch, cfg.moment_dtype)

    def init_leaf(p):
        m = torch.zeros(p.shape, dtype=mdt, device=p.device)
        if cfg.factored and _factorable(p.shape):
            v = {
                "row": torch.zeros(p.shape[:-1], dtype=mdt, device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=mdt,
                                   device=p.device),
            }
        else:
            v = torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"m": m, "v": v}

    device = leaves(params)[0].device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(init_leaf, params),
    }


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _vhat(mu_v, g2, b2, shape):
    """Update + reconstruct the (possibly factored) second moment."""
    if isinstance(mu_v, dict):  # factored
        row = b2 * mu_v["row"] + (1 - b2) * torch.mean(g2, dim=-1)
        col = b2 * mu_v["col"] + (1 - b2) * torch.mean(g2, dim=-2)
        mean_row = torch.mean(row, dim=-1, keepdim=True)
        v_full = (row[..., None] * col[..., None, :]
                  / torch.clamp(mean_row[..., None], min=1e-30))
        return {"row": row, "col": col}, v_full
    v = b2 * mu_v + (1 - b2) * g2
    return v, v


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """-> (params, state, metrics), params float32 leaves.  ``params`` and
    ``state`` are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    state["count"].add_(1)
    count = state["count"].float()
    lr = cfg.lr if lr is None else lr
    b1c = 1 - cfg.b1 ** count
    b2c = 1 - cfg.b2 ** count
    mdt = getattr(torch, cfg.moment_dtype)

    pairs = list(_param_moment_pairs(params, state["mu"]))
    for (p, mu), g in zip(pairs, leaves(grads)):
        # clip_by_global_norm leaf by leaf: the same bits, with no second
        # copy of every gradient alive at once
        g = (g.float() * scale).to(g.dtype).float()
        m = cfg.b1 * mu["m"].float() + (1 - cfg.b1) * g
        v_old = (mu["v"].float() if not isinstance(mu["v"], dict)
                 else {k: x.float() for k, x in mu["v"].items()})
        new_v, v_full = _vhat(v_old, torch.square(g), cfg.b2, p.shape)
        del g, v_old
        step = (m / b1c) / (torch.sqrt(v_full / b2c) + cfg.eps)
        # the moments are stored, and their temporaries freed, before the
        # params' update: a leaf-sized temporary fewer at the peak
        mu["m"].copy_(m.to(mdt))
        if isinstance(mu["v"], dict):
            for k in mu["v"]:
                mu["v"][k].copy_(new_v[k].to(mdt))
        else:
            mu["v"].copy_(new_v.to(mdt))
        del m, new_v, v_full
        new_p = p.float() - lr * (step + cfg.weight_decay * p.float())
        p.copy_(new_p.to(p.dtype))
    return params, state, {"grad_norm": gnorm}
