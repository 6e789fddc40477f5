"""Weights drawn from the seed on the card, in the program's tree layout.

The benchmark makes the weights: each leaf (each layer's row of a stacked
leaf) from its own ``torch.Generator`` on the device, seeded from the run's
seed and the leaf's path, as a normal draw times the leaf's scale cut at
two scales, in float32 (the port serves and trains float32 params with
bf16 compute).  The plain reference draws the same rows again itself, one
layer at a time, so it never reads what the program holds.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from harness.common import mix

GROUPS = "groups/b0"


def padded_vocab(run: dict) -> int:
    """The vocabulary rows the port holds: padded to a multiple of 2048."""
    return math.ceil(run["vocab_size"] / 2048) * 2048


def layout(run: dict) -> Dict[str, Tuple[Tuple[int, ...], float, bool]]:
    """path -> (shape of one row, scale, stacked over the layers): the
    params tree of the port's attention + MLP or MoE decoder, scale 0 for
    a norm's zeros (applied as 1 + scale), fan-in for a product's weight."""
    d, hd = run["d_model"], run["head_dim"]
    H, Hkv, ff = run["num_heads"], run["num_kv_heads"], run["d_ff"]
    V = padded_vocab(run)
    out = {"embed/table": ((V, d), 0.02, False),
           "final_norm": ((d,), 0.0, False)}
    if not run["tie_embeddings"]:
        out["unembed"] = ((V, d), 0.02, False)
    g = GROUPS
    out.update({
        f"{g}/norm1": ((d,), 0.0, True),
        f"{g}/attn/wq": ((d, H * hd), d ** -0.5, True),
        f"{g}/attn/wk": ((d, Hkv * hd), d ** -0.5, True),
        f"{g}/attn/wv": ((d, Hkv * hd), d ** -0.5, True),
        f"{g}/attn/wo": ((H * hd, d), (H * hd) ** -0.5, True),
        f"{g}/norm2": ((d,), 0.0, True),
    })
    if run["family"] == "moe":
        E = run["num_experts"]
        out.update({
            f"{g}/moe/router": ((d, E), 0.02, True),
            f"{g}/moe/w_gate": ((E, d, ff), d ** -0.5, True),
            f"{g}/moe/w_up": ((E, d, ff), d ** -0.5, True),
            f"{g}/moe/w_down": ((E, ff, d), ff ** -0.5, True),
        })
    else:
        out.update({
            f"{g}/mlp/w_gate": ((d, ff), d ** -0.5, True),
            f"{g}/mlp/w_up": ((d, ff), d ** -0.5, True),
            f"{g}/mlp/w_down": ((ff, d), ff ** -0.5, True),
        })
    return out


def draw_row(seed: int, path: str, row: int, shape, scale: float,
             device, out=None) -> torch.Tensor:
    """One leaf (``row`` -1) or one layer's row of a stacked leaf."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    if scale == 0.0:
        return out.zero_()
    gen = torch.Generator(device=out.device)
    gen.manual_seed(mix(seed, "weights", path, row))
    out.normal_(0.0, 1.0, generator=gen)
    return out.mul_(scale).clamp_(-2.0 * scale, 2.0 * scale)


def stacked_rows(run: dict, rows) -> int:
    """The rows of a layout entry's leaf: 0 for one leaf that is not
    stacked (False), ``num_layers`` for True, else the number given."""
    return run["num_layers"] if rows is True else int(rows)


def draw_params(run: dict, seed: int, device, lay=None) -> dict:
    """The whole params tree for the program from ``lay`` (a model's
    layout; this module's ``layout`` where None): stacked leaves with
    their rows on a leading axis, as the port's ``init_lm`` lays them
    out."""
    tree: dict = {}
    lay = layout(run) if lay is None else lay
    for path, (shape, scale, rows) in lay.items():
        G = stacked_rows(run, rows)
        if G:
            t = torch.empty((G,) + shape, dtype=torch.float32, device=device)
            for g in range(G):
                draw_row(seed, path, g, shape, scale, device, out=t[g])
        else:
            t = draw_row(seed, path, -1, shape, scale, device)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def flat_leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """path -> tensor of a nested dict of tensors."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat_leaves(tree[k], path))
        else:
            out[path] = tree[k]
    return out
