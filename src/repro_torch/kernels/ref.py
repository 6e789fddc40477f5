"""Plain PyTorch versions of the attention functions the port needs.

Counterpart of ``repro.kernels.ref``.  ``decode_attention`` is the plain
version of the CUDA decode kernel (``kernels/decode_attention.py``): the
CPU path of ``ops.decode_attention`` and the comparison the kernel is held
to on the card.  ``chunk_attention`` carries batched replay
(``attention.attn_append``); it has no kernel, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def attn_scale(head_dim: int) -> float:
    """``1/sqrt(D)`` rounded as the reference computes it (in float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _in_dtype_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and widen back: a product in ``dtype`` with
    float32 accumulation (the reference's ``preferred_element_type``)."""
    return x.to(dtype).float()


def chunk_attention(q, k_cache, v_cache, *, q_pos, k_pos, window: int = 0):
    """Multi-token append attention over a populated KV cache.

    q [B,k,H,D] (a chunk of k new tokens already written into the cache);
    caches [B,S,Hkv,D]; q_pos [B,k]; k_pos [B,S] (slot positions, -1 empty).
    Causality/window masking is positional, so ring-buffer caches work.
    """
    B, K, H, D = q.shape
    Hkv = k_cache.shape[2]
    g = H // Hkv
    qg = (q.float() * attn_scale(D)).reshape(B, K, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
    valid = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window and window > 0:
        valid &= q_pos[:, :, None] - k_pos[:, None, :] < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return o.reshape(B, K, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, q_pos, k_pos):
    """Single-token attention over a KV cache.

    q [B,1,H,D]; caches [B,S,Hkv,D]; q_pos [B] current position; k_pos [B,S]
    cache slot positions (-1 = empty).  Slots are valid where
    ``0 <= k_pos <= q_pos``; masked scores are ``NEG_INF``, not ``-inf``.
    """
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    g = H // Hkv
    qg = (q.float() * attn_scale(D)).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bkhd->bhgk", _in_dtype_f32(qg, k_cache.dtype),
                     k_cache.float())
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])  # [B,S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", _in_dtype_f32(p, v_cache.dtype),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)
