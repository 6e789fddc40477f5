"""CUDA kernel for single-token (decode) attention over a KV cache.

Port of ``repro.kernels.decode_attention`` (a Pallas TPU kernel) to a
hand-written kernel for Hopper, ``csrc/decode_attention.cu``: one launch
a call, a thread-block cluster per (batch row, kv head, tile of query
heads), no workspace in device memory.  The source says what bounds it
and how its design meets that.  Its plain PyTorch version is
``repro_torch.kernels.ref.decode_attention``, which
``ops.decode_attention`` runs for CPU tensors.

The launch plan (``decode_plan``) is a pure function of the shape, and
the kernel combines its partials in a fixed order with no atomics, so a
given shape always reduces in the same order: replay stays bit-exact on
the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attn_scale

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)

MAX_HEAD_DIM = 256
WARPS = 8            # warps per CTA (csrc: kWarps)
MAX_CLUSTER = 8      # CTAs per cluster, the portable limit (kMaxCluster)
MAX_HEADS = 5        # query heads per tile (kMaxHeads)
SMS = 132            # an H100 SXM's streaming multiprocessors
HEAD_KEYS = 8        # a head's fixed work for a warp, in keys (decode_plan)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


class DecodePlan(NamedTuple):
    cluster: int          # CTAs per cluster, each a contiguous run of keys
    keys_per_warp: int    # a warp's contiguous sub-run
    heads_per_tile: int   # query heads a cluster scores against one read
    n_tiles: int          # tiles of query heads per kv head
    lanes_per_key: int    # lanes that read one key row together
    vec: int              # elements one lane loads at once (16 bytes, or 1)


def decode_plan(B: int, S: int, Hkv: int, g: int, D: int,
                itemsize: int) -> DecodePlan:
    """The launch plan for q [B,1,Hkv*g,D] over a [B,S,Hkv,D] cache of
    ``itemsize``-byte elements.

    A key row is read in 16-byte pieces where D allows, by the fewest
    lanes, a power of two and at least 4, that cover it (where D does not
    allow, one element a lane, by the whole warp).  The query heads of a
    kv head go in balanced tiles of at most ``MAX_HEADS``, and each (batch
    row, kv head, tile) gets a cluster of CTAs (at most ``MAX_CLUSTER``)
    whose warps split the keys evenly, a multiple of a load's keys each; a
    cluster keeps no CTA without keys.  Of the tilings, the plan takes the
    one that gives a warp the least work, fewer tiles on a tie: its keys
    times its heads, where each head also costs the warp fixed work (its
    q, its share of the merges and combines) counted as ``HEAD_KEYS``
    keys.  Only tilings that fit one wave count: a CTA of 8 warps at about 200
    registers a thread fills an SM's registers, and a cluster is placed
    whole within a GPC (14 to 18 SMs on an H100 SXM), so clusters ask for
    at most three quarters of the SMs, single CTAs at most all of them."""
    vec = 16 // itemsize if D % (16 // itemsize) == 0 else 1
    pieces = D // vec
    lanes = 32 if vec == 1 else min(32, max(4, 1 << (pieces - 1).bit_length()))
    per_load = 32 // lanes
    best = None
    for n_tiles in range(-(-g // MAX_HEADS), g + 1):
        heads = -(-g // n_tiles)
        if -(-g // heads) != n_tiles:
            continue  # the same balanced tiles as a smaller n_tiles
        units = B * Hkv * n_tiles
        ctas = max(1, min(MAX_CLUSTER, 3 * SMS // (4 * units)))
        if units * ctas > SMS and best is not None:
            continue
        keys_per_warp = per_load * -(-S // (ctas * WARPS * per_load))
        cluster = -(-S // (WARPS * keys_per_warp))
        plan = DecodePlan(cluster, keys_per_warp, heads, n_tiles, lanes, vec)
        work = heads * (keys_per_warp + HEAD_KEYS)
        if best is None or work < best[0]:
            best = (work, plan)
    return best[1]


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("decode_attention_launch",
                             [i, p, p, p, p, p, p, i, i, i, i, i,
                              i, i, i, i, i, i, ctypes.c_float, p])
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
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("decode_attention caches must be 16-byte aligned")
    plan = decode_plan(B, S, Hkv, H // Hkv, D, q.element_size())
    out = torch.empty_like(q)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), B, S, H, Hkv, D, *plan, attn_scale(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("decode_attention", err)
    LAUNCHES += 1
    return out
