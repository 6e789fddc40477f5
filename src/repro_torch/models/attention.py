"""GQA attention block: params, RoPE dispatch and KV-cache management.

Port of ``repro.models.attention``: full-sequence attention
(``attn_forward``, train, prefill, the encoder and cross-attention over
``kv_x``, through ``ops.attention``), prompt prefill into the cache
(``prefill_into_cache``) and the decode paths (``attn_decode``,
``attn_append``) with a float or an int8 KV cache.  Positions are [B,S],
or [3,B,S] M-RoPE ids, whose temporal component (index 0) keys the cache
slots, as in the reference.  The reference's activation sharding
constraints are kept (``constrain``): no-ops on plain tensors, a
redistribution of a DTensor.  Two strategies (cfg.attn_sharding):
"heads" shards query heads over ``model``, "seq" the sequence (for archs
whose head counts don't divide the axis); decode shards the KV cache
along its sequence axis (``kv_seq``).

The reference returns a new cache from every call (JAX arrays are
immutable).  Here the prefill, decode and append paths write the new
K/V/pos slots into the cache tensors **in place** and return the same dict:
rewriting a 4 MiB cache for one slot per token would multiply the decode
path's memory traffic.  Callers that keep a cache while the fold goes on
must clone it (``StatefulConsumer.state_tree`` does).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.models import common
from repro_torch.models.common import param
from repro_torch.sharding.rules import (DEFAULT_RULES,
                                        with_sharding_constraint_logical)


def _act_rules(cfg):
    if cfg.attn_sharding == "seq":
        return DEFAULT_RULES.overriding(
            seq="model", act_heads=None, act_qout=None, act_kv_heads=None)
    return DEFAULT_RULES


def constrain(x, axes, cfg):
    return with_sharding_constraint_logical(x, axes, _act_rules(cfg))


def init_attention(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": param((d, qdim), ("embed", "qout")),
        "wk": param((d, kvdim), ("embed", "kv_out")),
        "wv": param((d, kvdim), ("embed", "kv_out")),
        "wo": param((qdim, d), ("qout", "embed")),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = common.zeros_param((hd,), ("stats",))
        p["k_norm"] = common.zeros_param((hd,), ("stats",))
    return p


def _project_qkv(params, x, kv_x, cfg):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,Skv,Hkv,hd] (pre-RoPE)."""
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = common.split_dim(x @ params["wq"].to(dt), 2, (cfg.num_heads, hd))
    k, v = (common.split_dim(kv_x @ params[w].to(dt), 2,
                             (cfg.num_kv_heads, hd)) for w in ("wk", "wv"))
    if cfg.use_qk_norm:
        q = common.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend(params, x, positions, cfg, *, local: bool, causal: bool,
            kv_x=None, kv_positions=None):
    """Attention of x [B,S,D] over itself, or over ``kv_x`` [B,Skv,D]
    (cross-attention: no RoPE) -> (output [B,S,D], k, v), k and v after
    RoPE (what a prefill writes into the cache)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    q, k, v = _project_qkv(params, x, kv_x, cfg)
    if kv_x is x and cfg.rope_kind != "none":
        q = common.rope_for(cfg, q, positions, local)
        k = common.rope_for(
            cfg, k, positions if kv_positions is None else kv_positions, local)
    q = constrain(q, ("batch", "seq", "act_heads", None), cfg)
    window = cfg.window if local else 0
    if (local and cfg.attn_sharding == "seq" and kv_x is x
            and S % max(window, 1) == 0):
        # local-window layers keep K/V seq-sharded (the reference's halo
        # exchange); the attention kernel gathers what it needs
        k = constrain(k, ("batch", "seq", "act_kv_heads", None), cfg)
        v = constrain(v, ("batch", "seq", "act_kv_heads", None), cfg)
    else:
        k = constrain(k, ("batch", None, "act_kv_heads", None), cfg)
        v = constrain(v, ("batch", None, "act_kv_heads", None), cfg)
    out = ops.attention(q, k, v, causal=causal, window=window)
    out = constrain(out, ("batch", "seq", "act_heads", None), cfg)
    out = common.merge_dims(out, 2) @ params["wo"].to(x.dtype)
    return constrain(out, ("batch", "seq", "act_embed"), cfg), k, v


def attn_forward(params, x, positions, cfg, *, local: bool = False,
                 causal: bool = True, kv_x=None, kv_positions=None):
    """Full-sequence attention (train / prefill / encoder / cross)."""
    return _attend(params, x, positions, cfg, local=local, causal=causal,
                   kv_x=kv_x, kv_positions=kv_positions)[0]


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, seq: int, *, local: bool = False,
                  dtype=None, device="cuda"):
    """Cache for one attention layer.  Local layers keep a ring buffer of
    ``window`` slots; global layers keep the full horizon.

    ``cfg.kv_cache_dtype == "int8"`` stores blockwise-quantized K/V: int8
    values and one bf16 scale per (slot, kv head)."""
    device = resolve_device(device)
    S = min(seq, cfg.window) if local else seq
    hd = cfg.resolved_head_dim
    shape = (batch, S, cfg.num_kv_heads, hd)
    cache = {"pos": torch.full((batch, S), -1, dtype=torch.int32,
                               device=device)}
    if cfg.kv_cache_dtype == "int8":
        dt = torch.int8
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                      device=device)
    else:
        dt = dtype or getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
    cache["k"] = torch.zeros(shape, dtype=dt, device=device)
    cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def kv_cache_logical_axes(local: bool = False, quantized: bool = False):
    axes = {
        "k": ("batch", "kv_seq", "act_kv_heads", None),
        "v": ("batch", "kv_seq", "act_kv_heads", None),
        "pos": ("batch", "kv_seq"),
    }
    if quantized:
        axes["k_scale"] = ("batch", "kv_seq", "act_kv_heads")
        axes["v_scale"] = ("batch", "kv_seq", "act_kv_heads")
    return axes


def _quantize_kv(x):
    """x [..., hd] -> (int8 values, bf16 scale [...]): the scale is
    max|x| / 127 (at least 1e-8), the values round half to even.

    Both divisions are tensor by tensor: CUDA divides a tensor by a
    Python scalar as a product with its reciprocal, which can round a
    scale one ulp away from the reference's true division."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(cache, dt):
    """The cache's K and V in ``dt`` (an int8 cache times its scales, the
    product taken in ``dt``)."""
    if "k_scale" not in cache:
        return cache["k"].to(dt), cache["v"].to(dt)
    k = cache["k"].to(dt) * cache["k_scale"].to(dt)[..., None]
    v = cache["v"].to(dt) * cache["v_scale"].to(dt)[..., None]
    return k, v


def _cache_entries(cache, k, v):
    """The leaves a K/V write stores: quantized for an int8 cache."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _local_as(x, mesh, pl):
    """``x`` (a DTensor, or a plain tensor taken as replicated) as this
    rank's shard of placements ``pl``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, pl).to_local()


def _slot_shard(leaf):
    """A DTensor cache leaf [B,S,...] -> (its local shard, the first
    global slot the shard holds, the placements of a value [B,n,...]
    whole along its slots: the leaf's batch and head shards kept)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = leaf.device_mesh
    pl = tuple(leaf.placements)
    local = leaf.to_local()
    coord = mesh.get_coordinate()
    chunk = 0
    for m, p in enumerate(pl):  # major to minor, as DTensor splits
        if p == Shard(1):
            chunk = chunk * mesh.size(m) + coord[m]
    return (local, chunk * local.shape[1],
            [Replicate() if p == Shard(1) else p for p in pl])


def _write_prefix(leaf, value):
    """``leaf[:, :n] = value`` (n = value.shape[1]), in place.  A
    DTensor's slot-sharded leaf cannot be sliced in place; each rank
    writes the slots its shard holds."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        leaf[:, :value.shape[1]] = value
        return
    local, s0, vpl = _slot_shard(leaf)
    value = _local_as(value, leaf.device_mesh, vpl)
    hi = min(s0 + local.shape[1], value.shape[1])
    if hi > s0:
        local[:, :hi - s0] = value[:, s0:hi]


def _write_slots(leaf, b_idx, slots, value):
    """``leaf[b_idx, slots] = value`` (slots [B] or [B,k]), in place.  On
    a DTensor (DTensor has no in-place rule for this scatter) each rank
    writes the entries its shard holds, one token column at a time; a
    row whose slot lies on another rank rewrites its own slot's value."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(leaf, DTensor):
        leaf[b_idx, slots] = value
        return
    if slots.dim() == 1:
        slots, value = slots[:, None], value[:, None]
    mesh = leaf.device_mesh
    local, s0, vpl = _slot_shard(leaf)
    value = _local_as(value, mesh, vpl)
    slots = _local_as(slots, mesh, [p if p == Shard(0) else Replicate()
                                    for p in leaf.placements]) - s0
    inside = (slots >= 0) & (slots < local.shape[1])
    slots = slots.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    for j in range(slots.shape[1]):
        old = local[rows, slots[:, j]]
        keep = inside[:, j].reshape((-1,) + (1,) * (old.dim() - 1))
        local[rows, slots[:, j]] = torch.where(keep, value[:, j], old)


def prefill_into_cache(params, x, positions, cfg, cache, *, local: bool):
    """Run full attention over the prompt AND write its K/V/pos into the
    cache (in place).  A prompt of at least ``S_cache`` tokens keeps its
    last ``S_cache`` positions, rolled so that position p sits at slot
    ``p % S_cache`` (the ring slot decode writes).  Slots are keyed by the
    temporal component of [3,B,S] M-RoPE ids."""
    out, k, v = _attend(params, x, positions, cfg, local=local, causal=True)
    pos1d = positions[0] if positions.dim() == 3 else positions
    S_cache = cache["k"].shape[1]
    S = x.shape[1]
    entries = {**_cache_entries(cache, k, v), "pos": pos1d}
    for name, a in entries.items():
        a = a.to(cache[name].dtype)
        if S >= S_cache:
            shift = (S - S_cache) % S_cache
            a = torch.roll(a[:, S - S_cache:], shift, dims=1)
        _write_prefix(cache[name], a)
    return out, cache


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
    for name, a in _cache_entries(cache, k, v).items():
        _write_slots(cache[name], b_idx, slots, a.to(cache[name].dtype))
    _write_slots(cache["pos"], b_idx, slots, positions.to(torch.int32))
    k_all, v_all = _dequantize_kv(cache, x.dtype)
    out = _ref.chunk_attention(
        q, k_all, v_all, q_pos=positions, k_pos=cache["pos"],
        window=cfg.window if local else 0)
    out = common.merge_dims(out, 2) @ params["wo"].to(x.dtype)
    return out, cache


def attn_decode(params, x, positions, cfg, cache, *, local: bool):
    """One-token decode.  x [B,1,D]; positions [B,1] absolute positions,
    or [3,B,1] M-RoPE ids (the temporal one keys the slot).

    Writes the token's K/V/pos slot into ``cache`` in place, then attends
    over the whole cache (so at least one slot is always valid)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, x, cfg)
    if cfg.decode_heads_replicated:
        # flash-decode layout: q replicated over `model`
        q, k, v = (with_sharding_constraint_logical(
            t, ("batch", None, None, None), DEFAULT_RULES) for t in (q, k, v))
    if cfg.rope_kind != "none":
        q = common.rope_for(cfg, q, positions, local)
        k = common.rope_for(cfg, k, positions, local)
    S_cache = cache["k"].shape[1]
    pos_scalar = (positions[:, -1] if positions.dim() == 2
                  else positions[0, :, -1])
    slot = pos_scalar % S_cache  # ring for local layers
    b_idx = torch.arange(B, device=x.device)
    for name, a in _cache_entries(cache, k[:, 0], v[:, 0]).items():
        _write_slots(cache[name], b_idx, slot, a.to(cache[name].dtype))
    _write_slots(cache["pos"], b_idx, slot, pos_scalar.to(torch.int32))
    k_pos = cache["pos"]
    if local:
        k_pos = torch.where(pos_scalar[:, None] - k_pos < cfg.window, k_pos, -1)
    k_all, v_all = _dequantize_kv(cache, x.dtype)
    out = ops.decode_attention(q, k_all, v_all, pos_scalar, k_pos)
    out = common.merge_dims(out, 2) @ params["wo"].to(x.dtype)
    return out, cache
