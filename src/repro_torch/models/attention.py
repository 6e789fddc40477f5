"""GQA attention block: params, RoPE dispatch and KV-cache management.

Port of ``repro.models.attention`` for the decode paths (``attn_decode``,
``attn_append``) with a float KV cache.  The reference's sharding
constraints have no counterpart here, and the int8 KV cache is not
ported yet.

The reference returns a new cache from every call (JAX arrays are
immutable).  Here the decode and append paths write the new K/V/pos
slots into the cache tensors **in place** and return the same dict:
rewriting a 4 MiB cache for one slot per token would multiply the decode
path's memory traffic.  Callers that keep a cache while the fold goes on
must clone it (``StatefulConsumer.state_tree`` does).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.models import common
from repro_torch.models.common import param


def init_attention(gen: torch.Generator, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": param(gen, (d, qdim)),
        "wk": param(gen, (d, kvdim)),
        "wv": param(gen, (d, kvdim)),
        "wo": param(gen, (qdim, d)),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = common.zeros_param((hd,))
        p["k_norm"] = common.zeros_param((hd,))
    return p


def _project_qkv(params, x, kv_x, cfg):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,Skv,Hkv,hd] (pre-RoPE)."""
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, cfg.num_heads, hd)
    k = (kv_x @ params["wk"].to(dt)).reshape(B, Skv, cfg.num_kv_heads, hd)
    v = (kv_x @ params["wv"].to(dt)).reshape(B, Skv, cfg.num_kv_heads, hd)
    if cfg.use_qk_norm:
        q = common.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, seq: int, *, local: bool = False,
                  dtype=None, device="cpu"):
    """Cache for one attention layer.  Local layers keep a ring buffer of
    ``window`` slots; global layers keep the full horizon."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported yet to repro_torch")
    S = min(seq, cfg.window) if local else seq
    hd = cfg.resolved_head_dim
    dt = dtype or getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
    shape = (batch, S, cfg.num_kv_heads, hd)
    return {
        "pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def attn_append(params, x, positions, cfg, cache, *, local: bool):
    """Append a chunk of k tokens to the cache (in place) and attend over it.

    x [B,k,D]; positions [B,k] absolute.  The batched-replay path: one call
    folds k messages with chunk-parallel attention instead of k sequential
    decode steps.
    """
    B, K, _ = x.shape
    q, k, v = _project_qkv(params, x, x, cfg)
    if cfg.rope_kind != "none":
        q = common.rope_for(cfg, q, positions, local)
        k = common.rope_for(cfg, k, positions, local)
    S_cache = cache["k"].shape[1]
    slots = positions % S_cache  # [B,k]
    b_idx = torch.arange(B, device=x.device)[:, None]
    cache["k"][b_idx, slots] = k.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = v.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = positions.to(torch.int32)
    out = _ref.chunk_attention(
        q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), q_pos=positions,
        k_pos=cache["pos"], window=cfg.window if local else 0)
    out = out.reshape(B, K, -1) @ params["wo"].to(x.dtype)
    return out, cache


def attn_decode(params, x, positions, cfg, cache, *, local: bool):
    """One-token decode.  x [B,1,D]; positions [B,1] absolute positions.

    Writes the token's K/V/pos slot into ``cache`` in place, then attends
    over the whole cache (so at least one slot is always valid)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, x, cfg)
    if cfg.rope_kind != "none":
        q = common.rope_for(cfg, q, positions, local)
        k = common.rope_for(cfg, k, positions, local)
    S_cache = cache["k"].shape[1]
    pos_scalar = positions[:, -1]
    slot = pos_scalar % S_cache  # ring for local layers
    b_idx = torch.arange(B, device=x.device)
    cache["k"][b_idx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][b_idx, slot] = pos_scalar.to(torch.int32)
    k_pos = cache["pos"]
    if local:
        k_pos = torch.where(pos_scalar[:, None] - k_pos < cfg.window, k_pos, -1)
    out = ops.decode_attention(q, cache["k"].to(x.dtype),
                               cache["v"].to(x.dtype), pos_scalar, k_pos)
    out = out.reshape(B, 1, -1) @ params["wo"].to(x.dtype)
    return out, cache
