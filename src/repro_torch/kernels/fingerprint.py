"""Chunk fingerprints: a CUDA kernel for stage 1, plain PyTorch beside it.

Port of ``repro.kernels.fingerprint``; the construction is the same and
the results are bit-identical:

  * a leaf's raw bytes are reinterpreted as 32-bit words and laid out as
    ``[n_chunks, rows, 128]`` (``chunked_words``, chunk boundaries on the
    registry's raw-byte chunk grid);
  * stage 1 (``fingerprint_lanes``, the kernel in
    ``csrc/fingerprint.cu``): per chunk, each lane accumulates
    ``sum_r w[r, j] * (mix32((r + 1) * 0x9E3779B1) | 1)`` mod 2^32;
  * stage 2 (``collapse_lanes``, plain torch on the leaf's device): the
    128 lanes collapse to ``FP_WORDS`` words under four seeded weightings.

Torch has no CUDA uint32 arithmetic and its CPU uint32 lacks ``add``,
``sum`` and ``>>``, so words travel as ``int32`` bit patterns and the
plain versions compute in int64 holding values in ``[0, 2^32)``, with
products split so that nothing overflows.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

LANES = 128          # stage-1 fingerprint width
FP_WORDS = 4         # final fingerprint words per chunk (4 x u32 = 128 bit)
_GOLD = 0x9E3779B1   # 2^32 / golden ratio (Weyl constant)
_COLLAPSE_SEEDS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_MASK32 = 0xFFFFFFFF

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)
_entry = None


def _mul32(a, b):
    """``a * b mod 2^32`` for int64 operands in ``[0, 2^32)``: the 16-bit
    halves of ``b`` keep every partial product below 2^49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x):
    """murmur3-style uint32 finalizer on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _as_int32_bits(x):
    """int64 values in ``[0, 2^32)`` -> the same bits as int32."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _as_u32_values(x):
    """int32 bit patterns -> int64 values in ``[0, 2^32)``."""
    return x.to(torch.int64) & _MASK32


def fingerprint_lanes_ref(words):
    """Stage 1, plain PyTorch: ``[C, R, 128]`` int32 words -> ``[C, 128]``
    int32 (uint32 bits)."""
    C, R, L = words.shape
    assert L == LANES, words.shape
    r = torch.arange(1, R + 1, dtype=torch.int64, device=words.device)
    w = _mix32(_mul32(r, _GOLD)) | 1
    lanes = _mul32(_as_u32_values(words), w[None, :, None]).sum(dim=1)
    return _as_int32_bits(lanes & _MASK32)


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("fingerprint_lanes_launch", [p, p, i, i, p])
    return _entry


def fingerprint_lanes(words):
    """Stage 1 on the CUDA kernel: ``[C, R, 128]`` int32 words on the
    current CUDA device -> ``[C, 128]`` int32 (uint32 bits)."""
    global LAUNCHES
    if not words.is_cuda:
        raise ValueError("fingerprint_lanes kernel needs a CUDA tensor "
                         "(ops.chunk_fingerprint runs the plain version on CPU)")
    if (words.dtype != torch.int32 or words.dim() != 3
            or words.shape[2] != LANES or not words.is_contiguous()):
        raise ValueError(f"need contiguous int32 [C, R, {LANES}] words, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if words.device.index != torch.cuda.current_device():
        raise ValueError("fingerprint_lanes input must lie on the current "
                         "CUDA device")
    C, R, _ = words.shape
    if not 1 <= C <= 65535 or R < 1:
        raise ValueError(f"{C} chunks of {R} rows: need 1..65535 chunks")
    if words.data_ptr() % 16:
        words = words.clone()  # the kernel reads 16 bytes a thread
    out = torch.empty((C, LANES), dtype=torch.int32, device=words.device)
    err = _launcher()(words.data_ptr(), out.data_ptr(), C, R,
                      torch.cuda.current_stream(words.device).cuda_stream)
    build.check("fingerprint_lanes", err)
    LAUNCHES += 1
    return out


def collapse_lanes(lanes):
    """Stage 2: ``[C, 128]`` int32 (uint32 bits) -> ``[C, FP_WORDS]`` int64
    holding uint32 values."""
    j = torch.arange(1, LANES + 1, dtype=torch.int64, device=lanes.device)
    w = torch.stack([_mix32(_mul32(j, s)) | 1 for s in _COLLAPSE_SEEDS])
    terms = _mul32(_as_u32_values(lanes)[:, None, :], w[None, :, :])
    return terms.sum(dim=-1) & _MASK32


# ---------------------------------------------------------------------------
# Byte-layout helpers: raw array bits -> the kernel's [C, R, 128] layout
# ---------------------------------------------------------------------------

def as_u32_words(x):
    """Bit-reinterpret an array as a flat vector of 32-bit words (int32
    bits; on the tensor's device for tensors, zero-padding the tail to a
    4-byte boundary)."""
    if not isinstance(x, torch.Tensor):
        # numpy leaves go through a host byte view, so 64-bit scalars keep
        # all their bytes and the chunk grid matches the registry's
        b = np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)
        pad = (-b.size) % 4
        if pad:
            b = np.concatenate([b, np.zeros(pad, np.uint8)])
        return torch.from_numpy(b.view(np.int32).copy())
    x = x.reshape(-1)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    isz = x.element_size()
    if isz in (4, 8):
        return x.view(torch.int32)
    group = 4 // isz  # 2-byte or 1-byte elements: group into one word
    pad = (-x.numel()) % group
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.view(torch.int32)


def chunked_words(x, chunk_bytes: int):
    """-> 32-bit words of ``x`` arranged ``[n_chunks, rows, 128]``, chunk
    boundaries aligned with the registry's raw-byte chunk grid (requires
    ``chunk_bytes`` to be a positive multiple of 512)."""
    assert chunk_bytes >= 4 * LANES and chunk_bytes % (4 * LANES) == 0, \
        chunk_bytes
    words = as_u32_words(x)
    wpc = chunk_bytes // 4
    n = words.numel()
    if n <= wpc:
        # single-chunk leaf: pad only to the lane grid, not the full chunk
        wpc = max(LANES, ((n + LANES - 1) // LANES) * LANES)
    n_chunks = max(1, -(-n // wpc))
    pad = n_chunks * wpc - n
    if pad:
        words = torch.cat([words, words.new_zeros(pad)])
    return words.reshape(n_chunks, wpc // LANES, LANES)
