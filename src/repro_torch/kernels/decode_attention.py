"""CUDA kernel for single-token (decode) attention over a KV cache.

Port of ``repro.kernels.decode_attention`` (a Pallas TPU kernel) to a
hand-written split-KV kernel for Hopper, ``csrc/decode_attention.cu``;
the source says what bounds it and how its design meets that.  Its plain
PyTorch version is ``repro_torch.kernels.ref.decode_attention``, which
``ops.decode_attention`` runs for CPU tensors.

The launch plan is a pure function of the cache length, so a given shape
always reduces in the same order: replay stays bit-exact on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attn_scale

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)

MAX_HEAD_DIM = 256
_MAX_SPLITS = 64    # splits per (batch row, kv head)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


def split_plan(S: int):
    """-> (keys per split, number of splits): runs of a multiple of 32
    keys, at most ``_MAX_SPLITS`` of them."""
    split_len = 32 * -(-S // (32 * _MAX_SPLITS))
    return split_len, -(-S // split_len)


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("decode_attention_launch",
                             [i, p, p, p, p, p, p, p, p,
                              i, i, i, i, i, i, i, ctypes.c_float, p])
    return _entry


def decode_attention(q, k_cache, v_cache, q_pos, k_pos):
    """q [B,1,H,D]; caches [B,S,Hkv,D]; q_pos [B]; k_pos [B,S] -> [B,1,H,D].

    Launches the CUDA kernel; every tensor must lie on one CUDA device.
    """
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError("decode_attention kernel needs CUDA tensors "
                         "(ops.decode_attention runs the plain version on CPU)")
    B, one, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}; "
                         f"the kernel takes one of {list(_DTYPE_CODES)}")
    if min(B, S, Hkv, D) < 1 or H % Hkv or D > MAX_HEAD_DIM:
        raise ValueError(f"B={B} S={S} H={H} Hkv={Hkv} D={D}: need "
                         f"non-empty inputs, Hkv | H, D <= {MAX_HEAD_DIM}")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q_pos.shape != (B,) or k_pos.shape != (B, S):
        raise ValueError(f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    tensors = (q, k_cache, v_cache, q_pos, k_pos)
    if (any(t.device != q.device for t in tensors)
            or q.device.index != torch.cuda.current_device()):
        raise ValueError("decode_attention inputs must lie on the current "
                         "CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention inputs must be contiguous")
    split_len, n_split = split_plan(S)
    part_acc = torch.empty((B, H, n_split, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, D, split_len, n_split, attn_scale(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("decode_attention", err)
    LAUNCHES += 1
    return out
