"""Griffin/recurrentgemma recurrent block: gated branch + temporal conv1d +
RG-LRU (arXiv:2402.19427 fig. 2).

Port of ``repro.models.rglru``.  State is O(1) in sequence length — the
architecture family for which MS2M migration is checkpoint-dominant.
Prefill runs the RG-LRU kernel through ``ops.rglru_scan``; a decode step
runs the one-token update of ``ref.rglru_decode_step`` on every device,
as the reference does.  Params and state keep the reference's keys,
shapes and dtypes: ``h`` is float32, ``conv`` comes back in the
activations' dtype (a float32 ``init_rglru_state`` leaf becomes bf16
after a bf16 step, as in the reference).  Unlike the attention cache,
these functions return new state tensors and change nothing in place;
``transformer`` writes them into the stacked cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models.common import param, zeros_param
from repro_torch.sharding.rules import \
    with_sharding_constraint_logical as constrain


def init_rglru_block(cfg):
    d = cfg.d_model
    w = cfg.rglru_width or d
    H = cfg.num_heads
    hb = w // H  # block-diagonal gate head width
    return {
        "w_x": param((d, w), ("embed", "rec_width")),
        "w_gate_branch": param((d, w), ("embed", "rec_width")),
        "conv_w": param((cfg.conv1d_width, w), ("conv", "rec_width"),
                        scale=0.1),
        "conv_b": zeros_param((w,), ("rec_width",)),
        # block-diagonal input/recurrence gates (per-head [hb, hb])
        "gate_a_w": param((H, hb, hb), ("act_kv_heads", None, "rec_width")),
        "gate_x_w": param((H, hb, hb), ("act_kv_heads", None, "rec_width")),
        "gate_a_b": zeros_param((w,), ("rec_width",)),
        "gate_x_b": zeros_param((w,), ("rec_width",)),
        # a-parameter initialized so a = sigmoid(Λ) spans ~[0.9, 0.999]
        "a_param": param((w,), ("rec_width",), scale=0.5),
        "w_out": param((w, d), ("rec_width", "embed")),
    }


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv over time.  x [B,S,W]; w [K,W]; state
    [B,K-1,W] -> (out [B,S,W], new state [B,K-1,W] in x's dtype).  The
    taps are summed in the reference's order, in x's dtype."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, W]
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b[None, None, :], new_state


def _block_gates(params, x, cfg):
    """Block-diagonal gate projections. x [B,S,W] -> (gate_a, gate_x)."""
    H = cfg.num_heads
    B, S, W = x.shape
    xh = common.split_dim(x, 2, (H, W // H))
    ga = torch.einsum("bshi,hij->bshj", xh, params["gate_a_w"].to(x.dtype))
    gx = torch.einsum("bshi,hij->bshj", xh, params["gate_x_w"].to(x.dtype))
    ga = common.merge_dims(ga, 2) + params["gate_a_b"].to(x.dtype)
    gx = common.merge_dims(gx, 2) + params["gate_x_b"].to(x.dtype)
    return ga, gx


def _branches(params, x, cfg, conv_state):
    """-> (gelu gate branch, conv output u, gate_a, gate_x, new conv)."""
    dt = x.dtype
    # jax.nn.gelu's default is the tanh approximation
    gate_branch = F.gelu(x @ params["w_gate_branch"].to(dt),
                         approximate="tanh")
    u = constrain(x @ params["w_x"].to(dt), ("batch", "seq", "rec_width"))
    u, new_conv = _conv1d(u, params["conv_w"].to(dt), params["conv_b"].to(dt),
                          conv_state)
    ga, gx = _block_gates(params, u, cfg)
    return gate_branch, u, ga, gx, new_conv


def rglru_block_forward(params, x, cfg, state=None):
    """x [B,S,D] -> (out [B,S,D], new_state {h, conv}).

    state: {"h": [B,W] f32, "conv": [B,K-1,W]} or None (zeros)."""
    gate_branch, u, ga, gx, new_conv = _branches(
        params, x, cfg, None if state is None else state["conv"])
    h0 = None if state is None else state["h"]
    hs, h_last = ops.rglru_scan(u, params["a_param"], ga, gx, h0)
    hs = constrain(hs, ("batch", "seq", "rec_width"))
    out = (hs * gate_branch) @ params["w_out"].to(x.dtype)
    return (constrain(out, ("batch", "seq", "act_embed")),
            {"h": h_last, "conv": new_conv})


def rglru_decode_step(params, x, cfg, state):
    """x [B,1,D] -> (out [B,1,D], new_state)."""
    dt = x.dtype
    gate_branch, u, ga, gx, new_conv = _branches(params, x, cfg,
                                                 state["conv"])
    h = ref.rglru_decode_step(state["h"], u[:, 0], params["a_param"],
                              ga[:, 0], gx[:, 0])
    out = (h[:, None, :].to(dt) * gate_branch) @ params["w_out"].to(dt)
    return out, {"h": h, "conv": new_conv}


def init_rglru_state(cfg, batch: int, device="cuda"):
    dev = resolve_device(device)
    w = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                            dtype=torch.float32, device=dev),
    }


def rglru_state_logical_axes():
    return {"h": ("batch", "rec_width"), "conv": ("batch", None, "rec_width")}
