"""Plain PyTorch versions of the functions the port's kernels compute.

Counterpart of ``repro.kernels.ref``.  ``decode_attention`` is the plain
version of the CUDA decode kernel (``kernels/decode_attention.py``),
``naive_attention`` that of the CUDA flash kernel
(``kernels/flash_attention.py``), ``naive_rglru`` that of the CUDA
RG-LRU kernel (``kernels/rglru.py``), ``chunkwise_mlstm`` that of the
CUDA mLSTM kernel (``kernels/mlstm.py``) and ``naive_slstm`` with no
state that of the CUDA sLSTM kernel (``kernels/slstm.py``): the CPU
paths of ``ops.decode_attention``, ``ops.attention``, ``ops.rglru_scan``,
``ops.mlstm_scan`` and ``ops.slstm_scan``, and the comparisons the
kernels are held to on the card.  ``chunk_attention`` carries batched
replay (``attention.attn_append``), ``rglru_decode_step`` the one-token
recurrence of a decode step, and ``naive_mlstm``, ``mlstm_decode_step``
and ``naive_slstm`` the xLSTM recurrences that thread a serving state;
none of these has a kernel, as in the reference.
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


# ---------------------------------------------------------------------------
# mLSTM and sLSTM (xLSTM)
# ---------------------------------------------------------------------------

def _mlstm_update(C, n, m, q, k, v, logi, logf):
    """One step of the stabilized mLSTM recurrence, in float32.  C
    [B,H,Dv,Dk], n [B,H,D], m [B,H]; q (scaled)/k/v [B,H,D]; gates [B,H]
    -> ((C, n, m), h [B,H,D])."""
    m_new = torch.maximum(logf + m, logi)
    fe = torch.exp(logf + m - m_new)
    ie = torch.exp(logi - m_new)
    C = fe[..., None, None] * C + ie[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = fe[..., None] * n + ie[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, q))
    den = torch.maximum(den, torch.exp(-m_new))  # max(|n q|, exp(-m))
    return (C, n, m_new), num / den[..., None]


def naive_mlstm(q, k, v, i_gate, f_gate, state=None):
    """Matrix-LSTM (arXiv:2405.04517 §2.3), stabilized recurrent form.

    q,k,v: [B,S,H,D]; i_gate,f_gate: [B,S,H] (pre-activations).
      C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
      h_t = C_t q_t / max(|n_t^T q_t|, exp(-m_t))
    with the m_t log-stabilizer from the paper.  state (C [B,H,Dv,Dk], n
    [B,H,D], m [B,H]) float32, or None (zeros, m = NEG_INF).  Returns (h
    [B,S,H,D] float32, state): float32 whatever q's dtype, as the
    reference's recurrence returns it.
    """
    B, S, H, D = q.shape
    scale = attn_scale(D)
    q = q.float() * scale
    k = k.float()
    v = v.float()
    logf = F.logsigmoid(f_gate.float())  # [B,S,H]
    logi = i_gate.float()
    if state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    hs = []
    for t in range(S):
        (C, n, m), h = _mlstm_update(C, n, m, q[:, t], k[:, t], v[:, t],
                                     logi[:, t], logf[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_decode_step(state, q, k, v, i_gate, f_gate):
    """One-token mLSTM update.  q/k/v [B,H,D]; gates [B,H] -> (state, h
    [B,H,D] float32)."""
    C, n, m = state
    scale = attn_scale(q.shape[-1])
    return _mlstm_update(C, n, m, q.float() * scale, k.float(), v.float(),
                         i_gate.float(), F.logsigmoid(f_gate.float()))


def chunkwise_mlstm(q, k, v, i_gate, f_gate, chunk: int = 128):
    """The mLSTM from a fresh state in the chunkwise-parallel form: the
    plain version of the CUDA mLSTM kernel (``kernels/mlstm.py``), a
    transcription of the reference's Pallas kernel body.

    q/k/v [B,S,H,D]; gates [B,S,H] -> h [B,S,H,D] in q's dtype.  Per
    chunk of T steps, with b the inclusive cumsum of log f and F = b[-1]:
      m_t  = max(b_t + m_in, max_{j<=t}(b_t - b_j + logi_j))
      S    = (q k^T) * exp(b_t - b_j + logi_j - m_t), j <= t
      h_t  = (S v + e_t q C^T) / max(|sum_j S + e_t q.n|, exp(-m_t)),
             e_t = exp(b_t + m_in - m_t)
    then C, n, m carry to the next chunk with m_out = max(F + m_in,
    max_j(F - b_j + logi_j)).  The chunk size sets the sum order, so
    ``ops.mlstm_scan`` picks it as the reference does.
    """
    B, S, H, D = q.shape
    T = min(chunk, S)
    if S % T:
        raise ValueError(f"S={S} is not a multiple of the chunk {T}")
    scale = float(np.float32(1.0 / D ** 0.5))  # the kernel's sm_scale
    qt = q.float().transpose(1, 2) * scale  # [B,H,S,D]
    kt = k.float().transpose(1, 2)
    vt = v.float().transpose(1, 2)
    logi = i_gate.float().transpose(1, 2)  # [B,H,S]
    logf = F.logsigmoid(f_gate.float()).transpose(1, 2)
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    idx = torch.arange(T, device=q.device)
    tri = idx[:, None] >= idx[None, :]
    outs = []
    for c0 in range(0, S, T):
        qc, kc, vc = (a[:, :, c0:c0 + T] for a in (qt, kt, vt))
        li = logi[:, :, c0:c0 + T]
        b = torch.cumsum(logf[:, :, c0:c0 + T], dim=-1)
        Fc = b[..., -1]
        intra = b[..., :, None] - b[..., None, :] + li[..., None, :]
        intra = torch.where(tri, intra, NEG_INF)
        m_t = torch.maximum(b + m[..., None], intra.amax(-1))
        Sm = (qc @ kc.transpose(-1, -2)) * torch.exp(intra - m_t[..., None])
        Sm = torch.where(tri, Sm, 0.0)
        inter = torch.exp(b + m[..., None] - m_t)
        num = Sm @ vc + inter[..., None] * (qc @ C.transpose(-1, -2))
        den = Sm.sum(-1) + inter * (qc @ n[..., None])[..., 0]
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        outs.append(num / den[..., None])
        m_out = torch.maximum(Fc + m, (Fc[..., None] - b + li).amax(-1))
        w = torch.exp(Fc[..., None] - b + li - m_out[..., None])
        decay = torch.exp(Fc + m - m_out)
        C = decay[..., None, None] * C + (vc * w[..., None]).transpose(
            -1, -2) @ kc
        n = decay[..., None] * n + (w[..., None] * kc).sum(-2)
        m = m_out
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def naive_slstm(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o, state=None):
    """Scalar-LSTM with exponential gating + block-diagonal (per-head)
    recurrent mixing, as in arXiv:2405.04517 §2.2.

    x_* : [B,S,W] input pre-activations; r_* : [H, hb, hb] per-head
    recurrent weights applied to h_{t-1} (W = H*hb).  state (c, n, h, m)
    [B,W] float32 each, or None (c = 0, n = 1, h = 0, m = 0).  Returns
    (h_seq in x_i's dtype, state).  With ``state=None`` this is the plain
    version of the CUDA sLSTM kernel (``kernels/slstm.py``).
    """
    B, S, W = x_i.shape
    H, hb = r_i.shape[0], r_i.shape[1]
    if H * hb != W:
        raise ValueError(f"H={H} x hb={hb} != W={W}")
    rs = [r.float() for r in (r_i, r_f, r_z, r_o)]

    def rec(h, r):  # [B,W] x [H,hb,hb] -> [B,W]
        return torch.einsum("bhi,hij->bhj", h.reshape(B, H, hb),
                            r).reshape(B, W)

    if state is None:
        def z():
            return torch.zeros((B, W), dtype=torch.float32,
                               device=x_i.device)
        c, n, h, m = z(), z() + 1.0, z(), z()
    else:
        c, n, h, m = state
    hs = []
    for t in range(S):
        zi, zf, zz, zo = (x[:, t].float() + rec(h, r)
                          for x, r in zip((x_i, x_f, x_z, x_o), rs))
        m_new = torch.maximum(zf + m, zi)
        ie = torch.exp(zi - m_new)
        fe = torch.exp(zf + m - m_new)
        c = fe * c + ie * torch.tanh(zz)
        n = fe * n + ie
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(x_i.dtype), (c, n, h, m)
