"""Fused chunk fingerprint + delta encoding: CUDA kernels, plain PyTorch
beside them.

Port of ``repro.kernels.codec``.  A pre-copy round used to read each leaf
twice: once to fingerprint its chunks and once, on the host, to encode the
dirty ones.  The two kernels in ``csrc/codec.cu`` do both in one read:

  * ``xor_fp_lanes``  — fingerprint lanes of ``cur`` plus the XOR words
    ``cur ^ par`` (the ``xor_rle`` codec's run-length pass over them stays
    on the host: it is variable-length and O(dirty bytes));
  * ``int8_fp_lanes`` — fingerprint lanes of ``cur`` plus the blockwise
    int8 quantization of the float32 delta ``cur - par``
    (``optim.compression.quant_blocks``: 256-float blocks, two word rows
    each).

Layouts are ``fingerprint.chunked_words``'s: ``[C, R, 128]`` words as
int32 bits on the registry's chunk grid.  The int8 pass needs an even row
count; ``pair_rows`` zero-pads one row, which adds ``weight * 0`` to every
lane and a zero delta to the tail quant block, exactly the host codec's
zero-padding.  ``q`` is stored as int8 by the kernel and by the plain
version (the TPU kernel stores int32; the values are the same after the
clip, and the codec narrows to int8 anyway).

Everything here is bit-identical to the reference: fingerprint lanes, XOR
words, ``q`` and ``scale``.  A CUDA tensor launches the kernel or the call
raises; ``ops.fused_*_fingerprint`` runs the plain versions for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.fingerprint import LANES, fingerprint_lanes_ref
from repro_torch.optim.compression import BLOCK as QBLOCK
from repro_torch.optim.compression import _INV127, quant_blocks

_QROWS = QBLOCK // LANES  # word rows per quant block (= 2)
_TILE_ROWS = 16  # rows per block in csrc/codec.cu (kTileRows)

# wrapper calls that launched each kernel (main-path evidence)
LAUNCHES = {"xor_fp_lanes": 0, "int8_fp_lanes": 0}
_entries = {}


def pair_rows(words):
    """Zero-pad ``[C, R, 128]`` words to an even row count per chunk."""
    C, R, L = words.shape
    if R % _QROWS:
        words = torch.cat(
            [words, words.new_zeros((C, _QROWS - R % _QROWS, L))], dim=1)
    return words


def xor_fp_ref(cur_words, par_words):
    """Plain version: -> (fingerprint lanes ``[C, 128]``, xor words
    ``[C, R, 128]``), int32 bits."""
    return fingerprint_lanes_ref(cur_words), cur_words ^ par_words


def int8_fp_ref(cur_words, par_words):
    """Plain version: -> (fingerprint lanes ``[C, 128]`` int32 bits,
    q int8 ``[C, R'/2, 256]``, scale float32 ``[C, R'/2]``) with R' the
    row count after ``pair_rows``."""
    cur_words, par_words = pair_rows(cur_words), pair_rows(par_words)
    C, R, _ = cur_words.shape
    delta = cur_words.view(torch.float32) - par_words.view(torch.float32)
    q, scale = quant_blocks(delta.reshape(C * R // _QROWS, QBLOCK))
    return (fingerprint_lanes_ref(cur_words),
            q.reshape(C, R // _QROWS, QBLOCK), scale.reshape(C, R // _QROWS))


def edge_blocks(seed: int = 7):
    """-> (cur, parent): float32 vectors of nine 256-float quant blocks
    whose deltas hit every rule of the quantizer: exact .5 ties (the
    block's scale is 1.0, so ties go to even) and values on +-127, an
    all-zero block (scale clamps to 1e-12), -0, NaN from the data, +inf,
    -inf, NaN from inf - inf, subnormals and values near the float32
    maximum.  The kernels are held to their plain versions on these."""
    assert np.float32(127) * _INV127 == np.float32(1.0)
    rng = np.random.default_rng(seed)
    zeros = np.zeros(QBLOCK, np.float32)

    def noise():
        return rng.standard_normal(QBLOCK).astype(np.float32)

    ties = np.concatenate([[127.0, -127.0], np.arange(-126, 127) + 0.5])
    neg0 = zeros.copy()
    neg0[::2] = -0.0
    nan, inf, ninf, both = noise(), noise(), noise(), noise()
    nan[17], inf[3], ninf[200], both[9] = np.nan, np.inf, -np.inf, np.inf
    pboth = zeros.copy()
    pboth[9] = np.inf
    big = np.full(QBLOCK, 3.0e38, np.float32)
    big[::3] = -3.0e38
    blocks = [(np.pad(ties, (0, QBLOCK - ties.size)), zeros),
              (zeros, zeros), (neg0, zeros), (nan, zeros), (inf, zeros),
              (ninf, zeros), (both, pboth),
              ((noise() * 1e-39).astype(np.float32), zeros), (big, zeros)]
    return (np.concatenate([c for c, _ in blocks]).astype(np.float32),
            np.concatenate([p for _, p in blocks]).astype(np.float32))


def _launcher(name: str, n_pointers: int):
    if name not in _entries:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entries[name] = build.entry(f"{name}_launch",
                                     [p] * n_pointers + [i, i, p])
    return _entries[name]


def _check_pair(name: str, cur, par):
    """Validate the kernels' word inputs; -> 16-byte aligned (cur, par)."""
    if not (cur.is_cuda and par.is_cuda):
        raise ValueError(f"{name} kernel needs CUDA tensors (ops.fused_* "
                         "runs the plain version on CPU)")
    for t in (cur, par):
        if (t.dtype != torch.int32 or t.dim() != 3 or t.shape[2] != LANES
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need contiguous int32 [C, R, {LANES}] "
                             f"words, got {t.dtype} {tuple(t.shape)}")
    if cur.shape != par.shape:
        raise ValueError(f"{name}: shapes {tuple(cur.shape)} and "
                         f"{tuple(par.shape)} differ")
    if (cur.device != par.device
            or cur.device.index != torch.cuda.current_device()):
        raise ValueError(f"{name} inputs must lie on the current CUDA device")
    C, R, _ = cur.shape
    if C < 1 or R < 1 or C * -(-R // _TILE_ROWS) >= 2 ** 31:
        raise ValueError(f"{name}: {C} chunks of {R} rows")
    # the kernels read 16 bytes a thread
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in (cur, par))


def xor_fp_lanes(cur_words, par_words):
    """Fused pass on the CUDA kernel: ``[C, R, 128]`` int32 words x2 ->
    (fingerprint lanes ``[C, 128]``, xor words ``[C, R, 128]``)."""
    cur, par = _check_pair("xor_fp_lanes", cur_words, par_words)
    C, R, _ = cur.shape
    lanes = torch.empty((C, LANES), dtype=torch.int32, device=cur.device)
    xor = torch.empty_like(cur)
    err = _launcher("xor_fp_lanes", 4)(
        cur.data_ptr(), par.data_ptr(), lanes.data_ptr(), xor.data_ptr(),
        C, R, torch.cuda.current_stream(cur.device).cuda_stream)
    build.check("xor_fp_lanes", err)
    LAUNCHES["xor_fp_lanes"] += 1
    return lanes, xor


def int8_fp_lanes(cur_words, par_words):
    """Fused pass on the CUDA kernel: ``[C, R, 128]`` int32 words x2 (odd
    ``R`` padded as ``pair_rows`` does) -> (fingerprint lanes ``[C, 128]``,
    q int8 ``[C, R'/2, 256]``, scale float32 ``[C, R'/2]``)."""
    cur, par = _check_pair("int8_fp_lanes", cur_words, par_words)
    cur, par = pair_rows(cur), pair_rows(par)
    C, R, _ = cur.shape
    lanes = torch.empty((C, LANES), dtype=torch.int32, device=cur.device)
    q = torch.empty((C, R // _QROWS, QBLOCK), dtype=torch.int8,
                    device=cur.device)
    scale = torch.empty((C, R // _QROWS), dtype=torch.float32,
                        device=cur.device)
    err = _launcher("int8_fp_lanes", 5)(
        cur.data_ptr(), par.data_ptr(), lanes.data_ptr(), q.data_ptr(),
        scale.data_ptr(), C, R,
        torch.cuda.current_stream(cur.device).cuda_stream)
    build.check("int8_fp_lanes", err)
    LAUNCHES["int8_fp_lanes"] += 1
    return lanes, q, scale
