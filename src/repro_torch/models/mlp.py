"""Dense FFN: SwiGLU (default) or plain activation MLP (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import param


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(cfg, d_ff: int = 0):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": param((d, ff)),
        "w_down": param((ff, d)),
    }
    if cfg.mlp_gated:
        p["w_gate"] = param((d, ff))
    return p


def mlp_forward(params, x, cfg):
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if cfg.mlp_gated:
        h = up * _act(cfg.mlp_act)(x @ params["w_gate"].to(dt))
    else:
        h = _act(cfg.mlp_act)(up)
    return h @ params["w_down"].to(dt)
