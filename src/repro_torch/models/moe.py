"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

Port of ``repro.models.moe``: top-k softmax gating with a Switch-style
load-balancing auxiliary loss and a capacity factor; tokens past an
expert's capacity drop (their residual passes through).  Dispatch and
combine are sorts and gathers, the expert products three batched
einsums over ``[.., E, C, D]`` buffers.

The reference's sharding constraints on the expert buffers (experts
over ``model``: expert parallelism) are kept; they are no-ops on plain
tensors.

Determinism: the local route (the default) is scatter-free, sorts,
``torch.gather`` and a reshape-sum, so it gives the same bits on every
run on either device.  The global route's dispatch writes each kept
entry to its own slot (``index_put_`` with accumulation, deterministic
under the package's deterministic mode; every real slot receives one
entry), and its combine un-sorts the entries and sums each token's K in
a fixed order instead of the reference's scatter-add.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models import mlp as _mlp
from repro_torch.models.common import merge_dims, param, split_dim
from repro_torch.sharding.rules import (batch_axes, logical_to_spec,
                                        on_local_shards)
from repro_torch.sharding.rules import (
    with_sharding_constraint_logical as constrain)


def init_moe(cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": param((d, E), ("embed", "experts"), scale=0.02),
        # fan-in is shape[0], as in the reference: the expert stacks are
        # scaled by 1/sqrt(E), not 1/sqrt(d)
        "w_gate": param((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w_up": param((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w_down": param((E, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.shared_expert:
        p["shared"] = _mlp.init_mlp(cfg)
    return p


def expert_capacity(cfg, tokens: int) -> int:
    cap = int(tokens * cfg.num_experts_per_tok * cfg.capacity_factor
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def moe_forward(params, x, cfg):
    """x [B,S,D] -> (out [B,S,D], aux_loss scalar)."""
    if cfg.moe_routing == "local":
        return _moe_forward_local(params, x, cfg)
    return _moe_forward_global(params, x, cfg)


def _expert_axes(cfg):
    return "act_experts" if cfg.expert_sharding == "model" else None


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values
    in index order (a stable descending sort; ``torch.topk`` documents no
    order for ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _router(params, xf, cfg):
    """shared: logits/top-k/aux over a flat token dim (batched or global)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xf @ params["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_ids = top_k(probs, K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    one_hot_top1 = F.one_hot(gate_ids[..., 0], E).float()
    aux = E * torch.mean(one_hot_top1.reshape(-1, E).mean(0)
                         * probs.reshape(-1, E).mean(0))
    aux = aux + 1e-3 * torch.mean(torch.logsumexp(logits, -1) ** 2)
    return gate_w, gate_ids, aux


def _experts(params, expert_in, dt, lead: str, axes):
    """The three expert products over ``expert_in`` [..., E, C, D]
    (``lead``: the einsum letters of its axes before E; ``axes``: the
    buffers' logical axes).

    On DTensors they run on every rank's local shards: the buffers as
    ``axes`` place them, each expert stack split over E as they are and
    whole over D and F.  DTensor's own einsum can view a gradient whose
    local layout is not its global strides' (the 2x16x16 dry-run's
    train cells, run as 32x16), and fails."""
    wg, wu, wd = (params[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    expert_in = constrain(expert_in, axes)
    products = functools.partial(_expert_products, lead=lead)
    if not isinstance(expert_in, DTensor):
        return products(expert_in, wg, wu, wd)
    mesh = expert_in.device_mesh
    spec = logical_to_spec(axes, mesh, dims=expert_in.shape)
    w_spec = (spec[len(lead)], None, None)
    return on_local_shards(products, mesh, (expert_in, wg, wu, wd),
                           (spec, w_spec, w_spec, w_spec), spec)


def _expert_products(expert_in, wg, wu, wd, *, lead: str):
    h = F.silu(torch.einsum(f"{lead}ecd,edf->{lead}ecf", expert_in, wg))
    h = h * torch.einsum(f"{lead}ecd,edf->{lead}ecf", expert_in, wu)
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, wd)


def _take(a, idx):
    """``take_along_axis`` on axis 1 of ``a`` [B, N, D] with ``idx`` [B, M]."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def _local_plan(gate_ids, *, E: int, K: int, C: int):
    """The local route's dispatch and combine indices, per batch row, from
    the expert picks [B,S,K] -> (tok, hit) [B,E*C]: the token each expert
    slot reads and whether it holds one; (slot, kept) [B,S*K]: the slot
    each sorted entry sits at and whether it fit; inv_order [B,S*K]: the
    inverse of the sort."""
    B, S, _ = gate_ids.shape
    dev = gate_ids.device
    flat_e = gate_ids.reshape(B, S * K)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    inv_order = torch.sort(order, dim=-1, stable=True).indices
    e_s = torch.gather(flat_e, 1, order)
    t_s = order // K  # token id of sorted entry (entries are token-major)

    # run starts per expert: starts[b,e] = first sorted index of expert e
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(e_s, experts, side="left")

    # dispatch: slot (e,c) <- sorted entry starts[e]+c
    src = starts[:, :, None] + torch.arange(C, device=dev)  # [B,E,C]
    src_flat = src.reshape(B, E * C)
    in_range = src_flat < S * K
    src_safe = torch.clamp(src_flat, max=S * K - 1)
    e_at_src = torch.gather(e_s, 1, src_safe)
    hit = in_range & (e_at_src == torch.arange(E * C, device=dev) // C)
    tok = torch.where(hit, torch.gather(t_s, 1, src_safe), 0)  # [B,E*C]

    # combine: sorted entry i sits at slot e_s*C + rank
    rank = (torch.arange(S * K, device=dev)
            - torch.gather(starts, 1, e_s))
    kept = rank < C  # capacity overflow drops (token keeps its residual)
    slot = torch.where(kept, e_s * C + rank, 0)
    return tok, hit, slot, kept, inv_order


def _moe_forward_local(params, x, cfg):
    """Grouped local routing, formulated scatter-free: every bookkeeping op
    is batched over the batch-row axis and is a sort or a gather.

      dispatch: entries sorted by expert are contiguous runs; slot (e,c)
                reads entry ``starts[e]+c`` (a gather, not a scatter).
      combine:  un-sort by the inverse permutation and sum the K expert
                contributions per token (reshape + sum, not a scatter).
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = expert_capacity(cfg, S)  # per-row capacity
    dt = x.dtype

    gate_w, gate_ids, aux = _router(params, x, cfg)  # [B,S,K]
    plan = functools.partial(_local_plan, E=E, K=K, C=C)
    if isinstance(gate_ids, DTensor):
        # DTensor has no rule for searchsorted; the plan is per batch row,
        # so each rank plans its own rows
        mesh = gate_ids.device_mesh
        b = batch_axes(mesh, B)
        tok, hit, slot, kept, inv_order = on_local_shards(
            plan, mesh, (gate_ids,), ((b, None, None),), ((b, None),) * 5)
    else:
        tok, hit, slot, kept, inv_order = plan(gate_ids)

    # ---- dispatch as a gather: slot (e,c) <- sorted entry starts[e]+c ----
    gathered = _take(x, tok)
    expert_in = split_dim(gathered * hit[..., None].to(dt), 1, (E, C))

    expert_out = _experts(params, expert_in, dt, "b",
                          ("batch", _expert_axes(cfg), None, None))

    # ---- combine as a gather: sorted entry i sits at slot e_s*C + rank ----
    flat_out = merge_dims(expert_out, 1)
    per_entry = _take(flat_out, slot) * kept[..., None].to(dt)
    # un-sort back to token-major order and fold the K contributions
    unsorted = _take(per_entry, inv_order)
    w = gate_w.to(dt)
    out = torch.einsum("bskd,bsk->bsd", split_dim(unsorted, 1, (S, K)), w)

    if cfg.shared_expert:
        out = out + _mlp.mlp_forward(params["shared"], x, cfg)
    return constrain(out, ("batch", "seq", "act_embed")), aux


def _global_plan(gate_ids, *, E: int, K: int, C: int):
    """The global route's dispatch and combine indices over one token pool,
    from the expert picks [T,K] -> order: the stable sort of the T*K
    entries by expert; t_s: the token of each sorted entry; keep: whether
    it fit; slot: where it sits (E*C, the dump slot, where it did not);
    inv_order: the inverse of the sort.  All [T*K]."""
    T = gate_ids.shape[0]
    flat_e = gate_ids.reshape(-1)  # [T*K], entry t*K + k
    order = torch.sort(flat_e, stable=True).indices
    e_s = flat_e[order]
    t_s = order // K
    seg_start = torch.searchsorted(e_s, e_s, side="left")
    pos = torch.arange(T * K, device=gate_ids.device) - seg_start  # rank
    keep = pos < C
    slot = torch.where(keep, e_s * C + pos, E * C)  # E*C = dump slot
    inv_order = torch.sort(order, stable=True).indices
    return order, t_s, keep, slot, inv_order


def _dispatch(xf, t_s, keep, slot, *, E: int, C: int):
    """Each kept entry's token written to its slot -> expert_in [E,C,D]."""
    gathered = xf[t_s] * keep[:, None].to(xf.dtype)  # [T*K, D]
    buf = torch.zeros((E * C + 1, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf.index_put_((slot,), gathered, accumulate=True)
    return buf[: E * C].reshape(E, C, xf.shape[1])


def _combine(flat_out, gate_w, order, keep, slot, inv_order, *, K: int):
    """Each sorted entry's expert output, weighted, un-sorted to token-major
    order, each token's K summed in a fixed order -> [T, D]."""
    EC, D = flat_out.shape
    w_s = gate_w.reshape(-1)[order]
    vals = flat_out[torch.clamp(slot, max=EC - 1)]
    vals = vals * (w_s * keep).to(flat_out.dtype)[:, None]
    return vals[inv_order].reshape(-1, K, D).sum(1)


def _moe_forward_global(params, x, cfg):
    """Baseline: one global token pool (global sort).

    On DTensors the token pool and the plan are replicated on every rank
    (the reference's sharded global route lowers to full-token-buffer
    collectives): DTensor has no rule for ``searchsorted`` or the
    in-place ``index_put_``, so the plan, the dispatch and the combine
    run on every rank's replicated local tensors; the expert products
    stay sharded over ``act_experts``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = expert_capacity(cfg, T)
    dt = x.dtype
    xf = x.reshape(T, D)

    # the reference inlines _router's computation here (a flat [T,E])
    gate_w, gate_ids, aux = _router(params, xf, cfg)  # [T,K]

    plan = functools.partial(_global_plan, E=E, K=K, C=C)
    dispatch = functools.partial(_dispatch, E=E, C=C)
    combine = functools.partial(_combine, K=K)
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    r1, r2 = (None,), (None, None)  # replicated
    if mesh is not None:
        order, t_s, keep, slot, inv_order = on_local_shards(
            plan, mesh, (gate_ids,), (r2,), (r1,) * 5)
        expert_in = on_local_shards(dispatch, mesh, (xf, t_s, keep, slot),
                                    (r2, r1, r1, r1), (None,) * 3)
    else:
        order, t_s, keep, slot, inv_order = plan(gate_ids)
        expert_in = dispatch(xf, t_s, keep, slot)

    expert_out = _experts(params, expert_in, dt, "",
                          ("act_experts", None, None))

    # ---- combine: un-sort to token-major order, sum each token's K ----
    args = (expert_out.reshape(E * C, D), gate_w, order, keep, slot,
            inv_order)
    out = (combine(*args) if mesh is None else on_local_shards(
        combine, mesh, args, (r2, r2) + (r1,) * 4, r2))

    if cfg.shared_expert:
        out = out + _mlp.mlp_forward(params["shared"], x, cfg).reshape(T, D)
    return constrain(out.reshape(B, S, D), ("batch", "seq", "act_embed")), aux
