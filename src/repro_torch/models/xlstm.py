"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix-memory, parallelizable)
and sLSTM (scalar-memory, strictly sequential) — both with O(1) decode state.

Port of ``repro.models.xlstm``.  A forward from a fresh state (training)
runs the mLSTM and sLSTM kernels through ``ops.mlstm_scan`` and
``ops.slstm_scan``; a call that threads a state (prefill, decode and
append) runs the recurrences of ``kernels.ref`` on every device, as the
reference does.  Params and states keep the reference's keys, shapes,
dtypes and order: the mLSTM state is the tuple ``(C, n, m)``, the sLSTM
state the tuple ``(c, n, h, m)``, all float32.  These functions return
new state tensors and change nothing in place; ``transformer`` writes
them into the stacked cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models.common import (merge_dims, param, rms_norm,
                                      split_dim, zeros_param)
from repro_torch.sharding.rules import \
    with_sharding_constraint_logical as constrain


# ---------------------------------------------------------------------------
# mLSTM block (pre-up-projection, factor 2)
# ---------------------------------------------------------------------------

def _inner(cfg):
    return 2 * cfg.d_model


def init_mlstm_block(cfg):
    d = cfg.d_model
    m = _inner(cfg)
    H = cfg.num_heads
    return {
        "w_up": param((d, m), ("embed", "rec_width")),
        "w_gate": param((d, m), ("embed", "rec_width")),
        "wq": param((m, m), ("rec_width", "qout")),
        "wk": param((m, m), ("rec_width", "qout")),
        "wv": param((m, m), ("rec_width", "qout")),
        "w_if": param((m, 2 * H), ("rec_width", None), scale=0.02),
        "b_if": zeros_param((2 * H,), (None,)),
        "out_norm": zeros_param((m // H,), ("stats",)),
        "w_down": param((m, d), ("rec_width", "embed")),
    }


def _mlstm_qkv(params, u, cfg):
    B, S, m = u.shape
    H = cfg.num_heads
    hd = m // H
    dt = u.dtype
    q, k, v = (split_dim(u @ params[w].to(dt), 2, (H, hd))
               for w in ("wq", "wk", "wv"))
    if_g = u @ params["w_if"].to(dt) + params["b_if"].to(dt)
    i_gate, f_gate = torch.split(if_g.float(), H, dim=-1)  # [B,S,H]
    f_gate = f_gate + 3.0  # forget-gate bias init: remember by default
    return q, k, v, i_gate, f_gate


def mlstm_block_forward(params, x, cfg, state=None):
    """x [B,S,D] -> (out, new_state (C, n, m), or None from the kernel)."""
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    u = constrain(x @ params["w_up"].to(dt), ("batch", "seq", "rec_width"))
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    hs, new_state = ops.mlstm_scan(q, k, v, ig, fg, state)
    hs = rms_norm(hs, params["out_norm"], cfg.norm_eps)  # per-head norm
    hs = merge_dims(hs, 2).to(dt)
    out = (hs * gate) @ params["w_down"].to(dt)
    return constrain(out, ("batch", "seq", "act_embed")), new_state


def mlstm_decode_step(params, x, cfg, state):
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    u = x @ params["w_up"].to(dt)
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    new_state, h = ref.mlstm_decode_step(
        state, q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    h = rms_norm(h[:, None], params["out_norm"], cfg.norm_eps)
    h = merge_dims(h, 2).to(dt)
    out = (h * gate) @ params["w_down"].to(dt)
    return out, new_state


def init_mlstm_state(cfg, batch: int, device="cuda"):
    dev = resolve_device(device)
    m = _inner(cfg)
    H = cfg.num_heads
    hd = m // H
    return (
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=dev),
        torch.zeros((batch, H, hd), dtype=torch.float32, device=dev),
        torch.full((batch, H), ref.NEG_INF, dtype=torch.float32, device=dev),
    )


def mlstm_state_logical_axes():
    return (
        ("batch", "act_kv_heads", "rec_width", None),
        ("batch", "act_kv_heads", "rec_width"),
        ("batch", "act_kv_heads"),
    )


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "z", "o")


def init_slstm_block(cfg):
    d = cfg.d_model
    H = cfg.num_heads
    hb = d // H
    p = {"w_out": param((d, d), ("rec_width", "embed"))}
    for g in _GATES:
        p[f"w_{g}"] = param((d, d), ("embed", "rec_width"))
        # block-diagonal per-head recurrence (xLSTM §2.2)
        p[f"r_{g}"] = param((H, hb, hb), ("act_kv_heads", None, "rec_width"),
                            scale=0.02)
        p[f"b_{g}"] = zeros_param((d,), ("rec_width",))
    return p


def _slstm_inputs(params, x):
    dt = x.dtype
    return {g: x @ params[f"w_{g}"].to(dt) + params[f"b_{g}"].to(dt)
            for g in _GATES}


def slstm_block_forward(params, x, cfg, state=None):
    """x [B,S,D] -> (out, new_state (c, n, h, m), or None from the
    kernel)."""
    pre = _slstm_inputs(params, x)
    hs, new_state = ops.slstm_scan(
        *(pre[g] for g in _GATES), *(params[f"r_{g}"] for g in _GATES),
        state)
    out = hs.to(x.dtype) @ params["w_out"].to(x.dtype)
    return constrain(out, ("batch", "seq", "act_embed")), new_state


def slstm_decode_step(params, x, cfg, state):
    return slstm_block_forward(params, x, cfg, state)


def init_slstm_state(cfg, batch: int, device="cuda"):
    dev = resolve_device(device)
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=dev)

    return (z(), torch.ones((batch, d), dtype=torch.float32, device=dev),
            z(), z())


def slstm_state_logical_axes():
    ax = ("batch", "rec_width")
    return (ax, ax, ax, ax)
