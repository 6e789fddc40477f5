"""Plain PyTorch versions of the attention functions the port needs.

Counterpart of ``repro.kernels.ref``.  ``decode_attention`` is the plain
version of the CUDA decode kernel (``kernels/decode_attention.py``) and
``naive_attention`` that of the CUDA flash kernel
(``kernels/flash_attention.py``) and ``naive_rglru`` that of the CUDA
RG-LRU kernel (``kernels/rglru.py``): the CPU paths of
``ops.decode_attention``, ``ops.attention`` and ``ops.rglru_scan``, and
the comparisons the kernels are held to on the card.
``chunk_attention`` carries batched replay (``attention.attn_append``)
and ``rglru_decode_step`` the one-token recurrence of a decode step;
neither has a kernel, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def attn_scale(head_dim: int) -> float:
    """``1/sqrt(D)`` rounded as the reference computes it (in float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _in_dtype_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and widen back: a product in ``dtype`` with
    float32 accumulation (the reference's ``preferred_element_type``)."""
    return x.to(dtype).float()


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-materialization GQA attention.  q [B,Sq,H,D]; k/v [B,Sk,Hkv,D].

    Query i attends to key j where ``i >= j`` (``causal``) and, for
    ``window`` > 0, ``i - j < window``; masked scores are ``NEG_INF``, not
    ``-inf`` (a row with no valid key averages V, as in the reference).
    q is scaled by ``attn_scale(D)`` before the product, as the kernel
    does; the softmax is float32 and the output has q's dtype.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = (q.float() * attn_scale(D)).reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window and window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


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


# ---------------------------------------------------------------------------
# RG-LRU (griffin / recurrentgemma)
# ---------------------------------------------------------------------------

def _rglru_gates(x, a_param, gate_a, gate_x, c: float):
    """-> (a_t, gated) in float32: the recurrence's decay and input term,
    neither depending on h.  ``exp(2 * log_at)``, not ``a_t ** 2``, as in
    the reference."""
    log_a = F.logsigmoid(a_param.float())
    r = torch.sigmoid(gate_a.float())
    i = torch.sigmoid(gate_x.float())
    log_at = c * r * log_a
    a_t = torch.exp(log_at)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12))
    return a_t, beta * (i * x.float())


def naive_rglru(x, a_param, gate_a, gate_x, h0=None, *, c: float = 8.0):
    """Real-Gated Linear Recurrent Unit (arXiv:2402.19427 eq. 1-4).

    x, gate_a, gate_x [B,S,W] (one dtype); a_param [W] (a = sigmoid);
    h0 [B,W] or None (zeros).  ``h_t = a_t * h_{t-1} + gated_t`` walked in
    order in float32, a product and then a sum (two roundings).  Returns
    (h_seq [B,S,W] in x's dtype, h_last [B,W] float32).
    """
    B, S, W = x.shape
    a_t, gated = _rglru_gates(x, a_param, gate_a, gate_x, c)
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(S):
        h = a_t[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rglru_decode_step(h, x, a_param, gate_a, gate_x, *, c: float = 8.0):
    """One-token RG-LRU update.  h [B,W] float32; x/gates [B,W] -> h'."""
    a_t, gated = _rglru_gates(x, a_param, gate_a, gate_x, c)
    return a_t * h.float() + gated
