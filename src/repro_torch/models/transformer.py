"""Decoder LM, dense attention pattern: the paper consumer's model.

Port of the serving half of ``repro.models.transformer`` for dense
attention + MLP patterns: ``init_lm``, ``init_cache``, ``lm_decode_step``,
``lm_append`` and ``_logits``.  The reference scans stacked per-group
params with ``lax.scan``; here a Python loop walks the groups, indexing
the same stacked tensors.  Params and caches keep the reference's tree
keys, stacking, shapes and dtypes (the cache leaves become checkpoint
registry leaves).

Decode and append update the cache tensors in place and return the same
cache dict (see ``repro_torch.models.attention``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models import attention, common, mlp
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.common import param, zeros_param
from repro_torch.tree import tree_map

MIXERS_WITH_KV = (BlockKind.ATTN_GLOBAL, BlockKind.ATTN_LOCAL)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of a config this port does not run yet."""
    for mixer, ffn in cfg.pattern:
        if mixer not in MIXERS_WITH_KV or ffn not in (BlockKind.MLP,
                                                      BlockKind.NONE):
            raise NotImplementedError(
                f"{cfg.name}: block ({mixer.value}, {ffn.value}) is not "
                "ported yet to repro_torch (dense attention + MLP only)")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and modality frontends are not "
            "ported yet to repro_torch")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg, ffn: BlockKind):
    """One attention block (``check_ported`` admits no other mixer)."""
    blk: Dict[str, Any] = {"norm1": zeros_param((cfg.d_model,)),
                           "attn": attention.init_attention(gen, cfg)}
    if ffn == BlockKind.MLP:
        blk["norm2"] = zeros_param((cfg.d_model,))
        blk["mlp"] = mlp.init_mlp(gen, cfg)
    return blk


def _stack(trees):
    """Stack same-structured trees along a new leading ``layers`` axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _init_groups(gen, cfg, n_groups: int):
    """Stacked per-position block params: {'b0': stacked, 'b1': ...}."""
    return {f"b{i}": _stack([_init_block(gen, cfg, ffn)
                             for _ in range(n_groups)])
            for i, (_, ffn) in enumerate(cfg.pattern)}


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights from a seeded ``torch.Generator``, on ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": common.init_embedding(gen, cfg),
        "groups": _init_groups(gen, cfg, cfg.num_groups),
        "final_norm": zeros_param((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = param(gen, (cfg.padded_vocab, cfg.d_model),
                                  scale=0.02)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# serving: cache init / decode / append
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Decode cache: per-pattern-position trees stacked over groups."""
    check_ported(cfg)
    dev = resolve_device(device)
    G = cfg.num_groups
    cache = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        one = attention.init_kv_cache(
            cfg, batch, seq, local=(mixer == BlockKind.ATTN_LOCAL), device=dev)
        cache[f"b{i}"] = {k: a[None].repeat((G,) + (1,) * a.dim())
                          for k, a in one.items()}
    return cache


def _logits(params, x, cfg):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["unembed"] if "unembed" in params
             else params["embed"]["table"])
    logits = torch.einsum("bsd,vd->bsv", x, table.to(x.dtype)).float()
    return common.soft_cap(logits, cfg.logits_softcap)


def _run_layers(params, x, positions, cfg, cache, mix):
    """Apply every layer in order; ``mix`` is the attention variant
    (``attn_decode`` or ``attn_append``), which updates ``cache``."""
    for g in range(cfg.num_groups):
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            blk = tree_map(lambda a: a[g], params["groups"][f"b{i}"])
            layer_cache = {k: a[g] for k, a in cache[f"b{i}"].items()}
            h = common.rms_norm(x, blk["norm1"], cfg.norm_eps)
            y, _ = mix(blk["attn"], h, positions, cfg, layer_cache,
                       local=mixer == BlockKind.ATTN_LOCAL)
            x = x + y
            if ffn == BlockKind.MLP:
                h = common.rms_norm(x, blk["norm2"], cfg.norm_eps)
                x = x + mlp.mlp_forward(blk["mlp"], h, cfg)
    return x


def lm_decode_step(params, tokens, positions, cfg: ModelConfig, cache):
    """One decode step.  tokens [B,1]; positions [B,1] -> (logits, cache).

    ``cache`` is updated in place and returned."""
    x = common.embed(params["embed"], tokens, cfg)
    x = _run_layers(params, x, positions, cfg, cache, attention.attn_decode)
    return _logits(params, x, cfg), cache


def lm_append(params, tokens, positions, cfg: ModelConfig, cache):
    """Fold a chunk of k tokens into an existing cache (batched replay).

    tokens [B,k]; positions [B,k] absolute.  Equivalent to k sequential
    lm_decode_step calls up to softmax-reduction order.  ``cache`` is
    updated in place and returned.
    """
    x = common.embed(params["embed"], tokens, cfg)
    x = _run_layers(params, x, positions, cfg, cache, attention.attn_append)
    return _logits(params, x, cfg), cache
