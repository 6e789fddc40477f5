"""The LM of every architecture: dense attention, MoE, the RG-LRU hybrid,
xLSTM, the encoder-decoder and the M-RoPE VLM backbone.

Port of ``repro.models.transformer`` for patterns of attention, RG-LRU,
mLSTM and sLSTM mixers with MLPs, MoE FFNs or none (paper_consumer,
smollm_360m, the dense family, granite_moe_1b_a400m,
llama4_maverick_400b_a17b, recurrentgemma_2b, xlstm_350m), with
whisper_large_v3's encoder (stub audio frames plus sinusoidal positions,
bidirectional), cross-attention in every decoder layer and learned
decoder positions, and qwen2_vl_72b's stub image patches spliced in at
token 1 through ``patch_adapter`` with [3,B,S] M-RoPE ids: training
(``lm_forward``, ``lm_loss``) and serving (``init_cache``,
``lm_prefill``, ``lm_decode_step``, ``lm_append``).  The reference scans
stacked per-group params with ``lax.scan``; here a Python loop walks the
groups, indexing the same stacked tensors (so ``unroll`` changes
nothing).  Params and caches keep the reference's tree keys, stacking,
shapes and dtypes (they become checkpoint registry leaves).

Remat: ``"none"`` keeps every activation; ``"dots"`` and ``"full"``
checkpoint each layer group (``torch.utils.checkpoint``, non-reentrant,
with a selective policy).  ``"dots"`` is the reference's
``dots_with_no_batch_dims_saveable``: it saves the output of every
product with no batch dims (``x @ W`` against a 2-D weight, which
dispatches as ``aten.mm`` after a view) and recomputes everything else in
the backward pass: batched products (``aten.bmm``: the expert and RG-LRU
gate einsums, the plain attention's), norms, activations, casts, gathers,
and every hand-written kernel's forward (a kernel launch is no dispatcher
op, so the policy never sees it: the recompute launches it again into
fresh outputs, as a ``pallas_call`` is no dot to the reference's policy).
``"full"`` saves nothing (``nothing_saveable``).  The recompute stops
once it has what the backward needs, so neither policy reruns a group's
last product, which only the group's output reads; where that product
has no batch dims, ``dots`` saves its output all the same (one
activation a group the reference's DCE drops).  Recomputation is
deterministic, so the numbers do not change.

Prefill, decode and append update the cache tensors in place and return
the same cache dict (see ``repro_torch.models.attention``).  A recurrent
layer's new state (RG-LRU ``{h, conv}``, mLSTM ``(C, n, m)``, sLSTM ``(c,
n, h, m)``: dicts and tuples as in the reference, so the flattened leaves
line up with its cache) is copied into its group's slice of the stacked
leaves; where a leaf's dtype differs (the ``conv`` leaf starts float32 and
comes back in the activations' dtype, as in the reference), the stacked
leaf is first replaced by one of the new dtype.  An encoder-decoder's
prefill writes the encoder's output into the cache's ``enc_out`` leaf;
decode and append read it, and recompute the cross-attention K/V from it
in every decoder layer, as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models import attention, common, mlp, moe, rglru, xlstm
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.common import param, zeros_param
from repro_torch.sharding.rules import map_axes
from repro_torch.sharding.rules import (
    with_sharding_constraint_logical as constrain)
from repro_torch.tree import flatten, tree_map, unflatten

MIXERS_WITH_KV = (BlockKind.ATTN_GLOBAL, BlockKind.ATTN_LOCAL)


class _Recurrent(NamedTuple):
    """A recurrent mixer: its block's params key, and its functions.
    ``forward`` takes a sequence (from a state, or fresh for training),
    ``decode`` one token; both return the layer's new state."""
    key: str
    init_block: Callable
    init_state: Callable
    forward: Callable
    decode: Callable


_RECURRENT = {
    BlockKind.RGLRU: _Recurrent(
        "rglru", rglru.init_rglru_block, rglru.init_rglru_state,
        rglru.rglru_block_forward, rglru.rglru_decode_step),
    BlockKind.MLSTM: _Recurrent(
        "mlstm", xlstm.init_mlstm_block, xlstm.init_mlstm_state,
        xlstm.mlstm_block_forward, xlstm.mlstm_decode_step),
    BlockKind.SLSTM: _Recurrent(
        "slstm", xlstm.init_slstm_block, xlstm.init_slstm_state,
        xlstm.slstm_block_forward, xlstm.slstm_decode_step),
}
MIXERS = MIXERS_WITH_KV + tuple(_RECURRENT)
FFNS = (BlockKind.MLP, BlockKind.MOE, BlockKind.NONE)
DEC_POSITIONS = 8192  # learned decoder positions (whisper), ids taken mod


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a block kind the model does not know."""
    for mixer, ffn in cfg.pattern:
        if mixer not in MIXERS or ffn not in FFNS:
            raise ValueError(
                f"{cfg.name}: block ({mixer.value}, {ffn.value}) is no "
                "mixer (attention, RG-LRU, mLSTM or sLSTM) with an FFN (an "
                "MLP, an MoE FFN or none)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg, mixer: BlockKind, ffn: BlockKind, cross: bool = False):
    """One block's leaf specs: attention, RG-LRU, mLSTM or sLSTM, then
    cross-attention where ``cross`` (an encoder-decoder's decoder), with
    an MLP, an MoE FFN or none (``check_ported`` admits no other)."""
    blk: Dict[str, Any] = {"norm1": zeros_param((cfg.d_model,), ("embed",))}
    if mixer in MIXERS_WITH_KV:
        blk["attn"] = attention.init_attention(cfg)
    else:
        rec = _RECURRENT[mixer]
        blk[rec.key] = rec.init_block(cfg)
    if cross:
        blk["cross_attn"] = attention.init_attention(cfg)
        blk["norm_cross"] = zeros_param((cfg.d_model,), ("embed",))
    if ffn == BlockKind.MLP:
        blk["norm2"] = zeros_param((cfg.d_model,), ("embed",))
        blk["mlp"] = mlp.init_mlp(cfg)
    elif ffn == BlockKind.MOE:
        blk["norm2"] = zeros_param((cfg.d_model,), ("embed",))
        blk["moe"] = moe.init_moe(cfg)
    return blk


def _top_specs(cfg):
    """The specs of the leaves outside the layer groups."""
    d = cfg.d_model
    top: Dict[str, Any] = {"embed": common.init_embedding(cfg),
                           "final_norm": zeros_param((d,), ("embed",))}
    if not cfg.tie_embeddings:
        top["unembed"] = param((cfg.padded_vocab, d), ("vocab", "embed"),
                               scale=0.02)
    if cfg.is_encoder_decoder:
        top["encoder"] = {"final_norm": zeros_param((d,), ("embed",))}
        # learned decoder positions (whisper), capped at 8192 and tiled
        top["dec_pos_embed"] = param((DEC_POSITIONS, d), (None, "embed"),
                                     scale=0.02)
    if cfg.frontend == "image_patches":
        top["patch_adapter"] = param((d, d), ("embed", "act_embed"),
                                     scale=0.02)
    return top


def lm_specs(cfg: ModelConfig):
    """The whole params tree as ``Leaf`` specs, the group leaves stacked
    over a leading ``layers`` axis: the tree ``init_lm`` draws, with the
    reference's logical axes (``common.split_params`` splits it)."""
    check_ported(cfg)
    top = _top_specs(cfg)

    def groups(G: int, cross: bool):
        return {f"b{i}": common.stack_leaves(
                    _init_block(cfg, mixer, ffn, cross), G)
                for i, (mixer, ffn) in enumerate(cfg.pattern)}

    top["groups"] = groups(cfg.num_groups, cfg.is_encoder_decoder)
    if cfg.is_encoder_decoder:
        top["encoder"]["groups"] = groups(cfg.num_encoder_layers, False)
    return top


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights for ``seed`` on ``device`` (``common.draw``: drawn on
    the host on torch's intra-op thread count of threads, the same bits
    for every device and thread count).

    Each group's params are stacked over groups: each stacked leaf is
    allocated once, on ``device``, and every group's row of it is drawn
    as ``groups/b<i>/<keys>[<group>]``, block by block, straight into it
    (through one block-sized host buffer a thread for the card).  So the
    host never holds the model (31 GB for codeqwen1_5_7b in float32).
    An encoder-decoder's encoder stacks ``num_encoder_layers`` groups
    (``encoder/groups``, no cross-attention) beside its ``final_norm``."""
    check_ported(cfg)
    dev = resolve_device(device)
    top = _top_specs(cfg)
    params = common.allocate(top, device=dev)
    items = [(name, leaf, t) for (name, leaf), (_, t)
             in zip(common.leaf_paths(top), common.leaf_paths(params))]

    def stack_groups(node, path: str, G: int, cross: bool):
        node["groups"] = {}
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            spec = _init_block(cfg, mixer, ffn, cross)
            stacked = node["groups"][f"b{i}"] = common.allocate(spec, (G,),
                                                                dev)
            for (name, leaf), (_, t) in zip(
                    common.leaf_paths(spec, f"{path}/b{i}"),
                    common.leaf_paths(stacked)):
                items.extend((common.leaf_name(name, g), leaf, t[g])
                             for g in range(G))

    stack_groups(params, "groups", cfg.num_groups, cfg.is_encoder_decoder)
    if cfg.is_encoder_decoder:
        stack_groups(params["encoder"], "encoder/groups",
                     cfg.num_encoder_layers, False)
    common.draw(seed, items)
    return params


# ---------------------------------------------------------------------------
# block application / forward / loss (train)
# ---------------------------------------------------------------------------

REMAT = ("none", "dots", "full")
# the products with no batch dims: what ``dots`` saves
NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the output of a product with no batch dims,
    recompute any other op."""
    return (CheckpointPolicy.MUST_SAVE if op in NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def save_nothing(ctx, op, *args, **kwargs):
    """``remat="full"``: recompute every op."""
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat: str):
    """The selective checkpoint's contexts for ``remat``."""
    return create_selective_checkpoint_contexts(
        save_dots if remat == "dots" else save_nothing)


def _apply_block(blk, x, positions, cfg, i: int, *, enc_out=None,
                 causal: bool = True):
    """Full-sequence (train/prefill-without-cache) block application."""
    mixer, ffn = cfg.pattern[i]
    h = common.rms_norm(x, blk["norm1"], cfg.norm_eps)
    if mixer in MIXERS_WITH_KV:
        y = attention.attn_forward(blk["attn"], h, positions, cfg,
                                   local=mixer == BlockKind.ATTN_LOCAL,
                                   causal=causal)
    else:
        rec = _RECURRENT[mixer]
        y, _ = rec.forward(blk[rec.key], h, cfg)
    x = _cross(blk, x + y, positions, cfg, enc_out)
    x, aux = _ffn(blk, x, cfg, ffn)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _cross(blk, x, positions, cfg, enc_out):
    """``x`` plus the block's cross-attention of its normed ``x`` over
    ``enc_out`` (non-causal, no RoPE), where it has one."""
    if enc_out is None or "cross_attn" not in blk:
        return x
    h = common.rms_norm(x, blk["norm_cross"], cfg.norm_eps)
    return x + attention.attn_forward(blk["cross_attn"], h, positions, cfg,
                                      causal=False, kv_x=enc_out)


def _ffn(blk, x, cfg, ffn: BlockKind):
    """``x`` plus the block's FFN of its normed ``x`` -> (x, the MoE's aux
    loss, or None for an MLP or no FFN)."""
    if ffn == BlockKind.NONE:
        return x, None
    h = common.rms_norm(x, blk["norm2"], cfg.norm_eps)
    if ffn == BlockKind.MLP:
        return x + mlp.mlp_forward(blk["mlp"], h, cfg), None
    y, aux = moe.moe_forward(blk["moe"], h, cfg)
    return x + y, aux


def _run_groups(groups, x, positions, cfg, *, enc_out=None, causal=True,
                remat: str = "none", n_positions=None, unroll: bool = False):
    """Apply the stacked group params in order -> (x, aux).

    The stacked tensors are unbound once, so their gradient is one stack
    of the per-group gradients.  ``remat`` other than ``"none"``
    checkpoints each group under its policy (``save_dots``,
    ``save_nothing``)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}; one of {REMAT}")
    npos = n_positions or len(cfg.pattern)
    flat, treedef = flatten(groups)
    per_group = [t.unbind(0) for t in flat]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(flat[0].shape[0]):
        group_params = unflatten(treedef, [t[g] for t in per_group])

        def inner(x, group_params=group_params):
            a = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(npos):
                x, ai = _apply_block(group_params[f"b{i}"], x, positions,
                                     cfg, i, enc_out=enc_out, causal=causal)
                a = a + ai
            return x, a

        if remat == "none":
            x, a = inner(x)
        else:
            x, a = checkpoint(inner, x, use_reentrant=False,
                              context_fn=lambda: _remat_context(remat))
        aux = aux + a
    return x, aux


def _splice(x, update, start: int):
    """``x`` with ``update`` written along axis 1 from ``start``, with
    ``jax.lax.dynamic_update_slice``'s semantics: the start is clamped to
    [0, S - P], and an update longer than ``x`` is a ``TypeError``."""
    S, P = x.shape[1], update.shape[1]
    if P > S:
        raise TypeError(f"an update of {P} along axis 1 does not fit an "
                        f"operand of {S}")
    start = max(0, min(start, S - P))
    return torch.cat([x[:, :start], update, x[:, start + P:]], dim=1)


def _embed_inputs(params, batch, cfg):
    """tokens (+ the stub patch embeddings through ``patch_adapter``,
    written from token 1) -> x [B,S,D], positions: the batch's ([B,S], or
    [3,B,S] M-RoPE ids), else 0..S-1 [B,S]."""
    x = common.embed(params["embed"], batch["tokens"], cfg)
    positions = batch.get("positions")
    if positions is None:
        B, S = batch["tokens"].shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    if cfg.frontend == "image_patches" and "patch_embeds" in batch:
        pe = (batch["patch_embeds"].to(x.dtype)
              @ params["patch_adapter"].to(x.dtype))
        x = _splice(x, pe, 1)
    return constrain(x, ("batch", "seq", "act_embed")), positions


def _add_dec_positions(params, x, ids):
    """``x`` plus the learned decoder positions at ``ids`` mod 8192 (ids
    [1,S] or [B,S] against x [B,S,D]), gathered by ``index_select`` (a
    deterministic backward on CUDA), in x's dtype."""
    pe = params["dec_pos_embed"].to(x.dtype)
    idx = (ids % pe.shape[0]).reshape(-1)
    if isinstance(pe, DTensor) and not isinstance(idx, DTensor):
        # a plain index taken as replicated gives index_select a wrong
        # gradient under DTensor; an explicitly replicated one does not
        idx = DTensor.from_local(idx, pe.device_mesh,
                                 [Replicate()] * pe.device_mesh.ndim,
                                 run_check=False)
    return x + pe.index_select(0, idx).reshape(*ids.shape, -1)


def _encode(params, batch, cfg):
    """The encoder over the stub audio frames [B,F,D]: frames in the
    compute dtype plus sinusoidal positions in the frames' dtype, the
    encoder groups non-causal, then its final norm."""
    frames = batch["frames"].to(cfg.compute_dtype)
    B, F = frames.shape[:2]
    pos = common.sinusoidal_positions(F, cfg.d_model).to(
        device=frames.device, dtype=frames.dtype)
    x = constrain(frames + pos[None], ("batch", "seq", "act_embed"))
    positions = torch.arange(F, dtype=torch.int32,
                             device=x.device)[None].expand(B, F)
    enc = params["encoder"]
    x, _ = _run_groups(enc["groups"], x, positions, cfg, causal=False)
    return common.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _decoder_inputs(params, batch, cfg):
    """-> (x [B,S,D], positions, enc_out or None): the embedded prompt, and
    for an encoder-decoder the encoder's output and the decoder positions
    0..S-1 added."""
    enc_out = (_encode(params, batch, cfg) if cfg.is_encoder_decoder
               else None)
    x, positions = _embed_inputs(params, batch, cfg)
    if cfg.is_encoder_decoder:
        ids = torch.arange(x.shape[1], device=x.device)[None]
        x = _add_dec_positions(params, x, ids)
    return x, positions, enc_out


def lm_forward(params, batch, cfg: ModelConfig, *, remat: str = "none",
               unroll: bool = False):
    """batch: tokens [B,S] (+frames/patch_embeds/positions). -> (logits,
    aux)."""
    x, positions, enc_out = _decoder_inputs(params, batch, cfg)
    x, aux = _run_groups(params["groups"], x, positions, cfg,
                         enc_out=enc_out, remat=remat, unroll=unroll)
    return _logits(params, x, cfg), aux


def lm_loss(params, batch, cfg: ModelConfig, *, remat: str = "none",
            unroll: bool = False):
    """Next-token cross-entropy with masking; returns (loss, metrics)."""
    logits, aux = lm_forward(params, batch, cfg, remat=remat, unroll=unroll)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = -(ll * mask).sum() / denom
    loss = xent + cfg.router_aux_coef * aux
    return loss, {"xent": xent, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode / append
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Decode cache: per-pattern-position trees stacked over groups."""
    check_ported(cfg)
    dev = resolve_device(device)
    G = cfg.num_groups
    cache = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer in MIXERS_WITH_KV:
            one = attention.init_kv_cache(
                cfg, batch, seq, local=(mixer == BlockKind.ATTN_LOCAL),
                device=dev)
        else:
            one = _RECURRENT[mixer].init_state(cfg, batch, device=dev)
        cache[f"b{i}"] = tree_map(
            lambda a: a[None].repeat((G,) + (1,) * a.dim()), one)
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=cfg.compute_dtype,
            device=dev)
    return cache


def _block_cache_axes(cfg, i: int):
    mixer, _ = cfg.pattern[i]
    if mixer in MIXERS_WITH_KV:
        return attention.kv_cache_logical_axes(
            quantized=cfg.kv_cache_dtype == "int8")
    if mixer == BlockKind.RGLRU:
        return rglru.rglru_state_logical_axes()
    if mixer == BlockKind.MLSTM:
        return xlstm.mlstm_state_logical_axes()
    if mixer == BlockKind.SLSTM:
        return xlstm.slstm_state_logical_axes()
    raise ValueError(mixer)


def cache_logical_axes(cfg: ModelConfig):
    """The logical axes of ``init_cache``'s tree: each block's, behind the
    stacked ``layers`` axis, and ``enc_out`` for an encoder-decoder."""
    axes = {f"b{i}": map_axes(lambda a: ("layers",) + a,
                              _block_cache_axes(cfg, i))
            for i in range(len(cfg.pattern))}
    if cfg.is_encoder_decoder:
        axes["enc_out"] = ("batch", None, "act_embed")
    return axes


def _logits(params, x, cfg):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["unembed"] if "unembed" in params
             else params["embed"]["table"])
    # float32 sums of the compute dtype's products: a product of two bf16
    # values is exact in float32, so this is the reference's einsum with
    # ``preferred_element_type=float32``
    logits = torch.einsum("bsd,vd->bsv", x.float(), table.to(x.dtype).float())
    logits = common.soft_cap(logits, cfg.logits_softcap)
    return constrain(logits, ("batch", None, "act_vocab"))


# per serving call, the attention variant (it updates its cache slice in
# place); a recurrent mixer runs its ``decode`` for a decode step and its
# ``forward`` otherwise, and returns the layer's new state
_ATTN_MIXES = {"prefill": attention.prefill_into_cache,
               "decode": attention.attn_decode,
               "append": attention.attn_append}


def _store_state(cache, key: str, g: int, new) -> None:
    """Write a recurrent layer's new state (a dict or a tuple of tensors)
    into group ``g`` of ``cache[key]``'s stacked leaves, replacing a leaf
    whose dtype the state changed."""
    stacked = cache[key]
    names = list(stacked) if isinstance(stacked, dict) else range(len(new))
    leaves = {n: stacked[n] for n in names}
    for n in names:
        if leaves[n].dtype != new[n].dtype:
            leaves[n] = leaves[n].to(new[n].dtype)
        leaves[n][g].copy_(new[n])
    if isinstance(stacked, dict):
        stacked.update(leaves)
    else:
        cache[key] = tuple(leaves[n] for n in names)


def _run_layers(params, x, positions, cfg, cache, kind: str, enc_out=None):
    """Apply every layer in order, updating ``cache``; ``kind`` is the
    serving call (``prefill``, ``decode`` or ``append``); ``enc_out``, the
    encoder's output that cross-attention attends over."""
    attn_mix = _ATTN_MIXES[kind]
    for g in range(cfg.num_groups):
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            blk = tree_map(lambda a: a[g], params["groups"][f"b{i}"])
            layer_cache = tree_map(lambda a: a[g], cache[f"b{i}"])
            h = common.rms_norm(x, blk["norm1"], cfg.norm_eps)
            if mixer in MIXERS_WITH_KV:
                y, _ = attn_mix(blk["attn"], h, positions, cfg, layer_cache,
                                local=mixer == BlockKind.ATTN_LOCAL)
            else:
                rec = _RECURRENT[mixer]
                mix = rec.decode if kind == "decode" else rec.forward
                y, new = mix(blk[rec.key], h, cfg, layer_cache)
                _store_state(cache, f"b{i}", g, new)
            x = _cross(blk, x + y, positions, cfg, enc_out)
            x, _ = _ffn(blk, x, cfg, ffn)  # the MoE's aux is dropped
    return x


def lm_decode_step(params, tokens, positions, cfg: ModelConfig, cache):
    """One decode step.  tokens [B,1]; positions [B,1] -> (logits, cache).

    ``cache`` is updated in place and returned."""
    x = common.embed(params["embed"], tokens, cfg)
    if cfg.is_encoder_decoder:
        x = _add_dec_positions(params, x, positions[:, :1])
    x = constrain(x, ("batch", None, "act_embed"))
    x = _run_layers(params, x, positions, cfg, cache, "decode",
                    cache.get("enc_out"))
    return _logits(params, x, cfg), cache


def lm_append(params, tokens, positions, cfg: ModelConfig, cache):
    """Fold a chunk of k tokens into an existing cache (batched replay).

    tokens [B,k]; positions [B,k] absolute.  Equivalent to k sequential
    lm_decode_step calls up to softmax-reduction order.  ``cache`` is
    updated in place and returned.
    """
    x = common.embed(params["embed"], tokens, cfg)
    if cfg.is_encoder_decoder:
        x = _add_dec_positions(params, x, positions)
    x = constrain(x, ("batch", "seq", "act_embed"))
    x = _run_layers(params, x, positions, cfg, cache, "append",
                    cache.get("enc_out"))
    return _logits(params, x, cfg), cache


def lm_prefill(params, batch, cfg: ModelConfig, cache, unroll: bool = False):
    """Process a full prompt, producing logits and a populated cache.

    Full-sequence attention (the flash kernel on the card) plus the cache
    writes, the RG-LRU scan (its kernel on the card) from the cached
    state, and the mLSTM and sLSTM recurrences from the cached state (no
    kernel: as in the reference, only a fresh-state sequence reaches
    those), layer by layer.  An encoder-decoder first runs its encoder
    (the flash kernel, non-causal) and writes its output into the cache's
    ``enc_out`` leaf, which every decoder layer's cross-attention then
    reads.  ``cache`` is updated in place and returned.
    """
    x, positions, enc_out = _decoder_inputs(params, batch, cfg)
    if enc_out is not None:
        leaf = cache.get("enc_out")
        if (leaf is not None and leaf.shape == enc_out.shape
                and leaf.dtype == enc_out.dtype):
            leaf.copy_(enc_out)
        else:
            cache["enc_out"] = enc_out
    x = _run_layers(params, x, positions, cfg, cache, "prefill", enc_out)
    return _logits(params, x, cfg), cache
