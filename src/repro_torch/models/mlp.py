"""Dense FFN: SwiGLU (default) or plain activation MLP (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import param
from repro_torch.sharding.rules import \
    with_sharding_constraint_logical as constrain


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(cfg, d_ff: int = 0):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": param((d, ff), ("embed", "mlp")),
        "w_down": param((ff, d), ("mlp", "embed")),
    }
    if cfg.mlp_gated:
        p["w_gate"] = param((d, ff), ("embed", "mlp"))
    return p


def mlp_forward(params, x, cfg):
    dt = x.dtype
    up = constrain(x @ params["w_up"].to(dt), ("batch", "seq", "act_mlp"))
    if cfg.mlp_gated:
        gate = _act(cfg.mlp_act)(x @ params["w_gate"].to(dt))
        h = up * constrain(gate, ("batch", "seq", "act_mlp"))
    else:
        h = _act(cfg.mlp_act)(up)
    return constrain(h @ params["w_down"].to(dt), ("batch", "seq", "act_embed"))
