"""Shared layers: initializers, norms, RoPE, embeddings.

Port of ``repro.models.common``.  Params are plain dicts of tensors (the
reference's ``ParamLeaf`` sharding tags have no counterpart here).
Initializers draw from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same weights on every device; they will not match JAX's
threefry draws (tests load the reference's weights through
``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def param(gen: torch.Generator, shape: Sequence[int],
          scale: Optional[float] = None, dtype=torch.float32):
    """Truncated-normal init with fan-in scaling (scale=None) or constant std."""
    shape = tuple(shape)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
        scale = 1.0 / np.sqrt(max(1, fan_in))
    init = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(init, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (scale * init).to(dtype)


def zeros_param(shape: Sequence[int], dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def soft_cap(x, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


# ---------------------------------------------------------------------------
# rotary position embeddings (default rope)
# ---------------------------------------------------------------------------

def _rope_angles(positions, dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, dim/2] (fp32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10_000.0, fraction: float = 1.0):
    """x [B,S,H,D]; positions [B,S].  ``fraction`` < 1 rotates only the first
    ``fraction*D`` dims (chatglm-style partial / "2d" rope)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos, sin = _rope_angles(positions, rot, theta)  # [B,S,rot/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def rope_for(cfg, x, positions, local: bool):
    """Dispatch on cfg.rope_kind (``default`` and ``none`` are ported)."""
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind != "default":
        raise NotImplementedError(
            f"rope_kind {cfg.rope_kind!r} is not ported yet to repro_torch")
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    return apply_rope(x, positions, theta)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg):
    return {"table": param(gen, (cfg.padded_vocab, cfg.d_model), scale=0.02)}


def embed(params, ids, cfg):
    table = params["table"].to(cfg.compute_dtype)
    x = table[ids]
    return x * math.sqrt(cfg.d_model)


def unembed(params, x, cfg, table=None):
    """Logits via the (tied) embedding table or a dedicated head."""
    t = table if table is not None else params["table"]
    return torch.einsum("bsd,vd->bsv", x, t.to(x.dtype))
