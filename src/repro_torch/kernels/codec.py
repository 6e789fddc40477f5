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
int32 bits on the registry's chunk grid.  The int8 pass works on pairs of
rows; for an odd row count the plain version zero-pads one row
(``pair_rows``), which adds ``weight * 0`` to every lane and a zero delta
to the tail quant block, exactly the host codec's zero-padding, and the
kernel reads the missing row as zeros, which gives the same bits without
the copies.  ``q`` is stored as int8 by the kernel and by the plain
version (the TPU kernel stores int32; the values are the same after the
clip, and the codec narrows to int8 anyway).

Each call is one launch with no memset (the int8 kernel's "split" route,
which the fold's one 4 MiB chunk takes, launches the fingerprint kernel
after it); the outputs are allocated without deterministic mode's fill
(``build.empty_written``), since the kernels write every word of them.
``codec_plan`` chooses each kernel's grid and route on the host from the
shape; ``plan=`` forces another, and every plan gives the same bits.

Everything here is bit-identical to the reference: fingerprint lanes, XOR
words, ``q`` and ``scale``.  A CUDA tensor launches the kernel or the call
raises; ``ops.fused_*_fingerprint`` runs the plain versions for CPU
tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fingerprint as fp
from repro_torch.kernels.fingerprint import (LANES, MAX_RUNS, ROW_PIECES,
                                             THREADS, WIDEST_PIECES,
                                             fingerprint_lanes_ref)
from repro_torch.optim.compression import BLOCK as QBLOCK
from repro_torch.optim.compression import _INV127, quant_blocks

_QROWS = QBLOCK // LANES  # word rows per quant block (= 2)
WARPS = THREADS // 32     # a CTA's warps (csrc/fingerprint.cuh: kWarps)
MAX_GROUPS = 8            # chunks a CTA (a warp each at the most)
CTA_TARGET = 128          # CTAs a plan aims at: about one an SM
SLICE_BYTES = 16 * 1024   # of each input a one-run XOR CTA reads at most
FEW_CHUNK_PIECES = 4      # a slice of 64 bytes where runs must fill the card
ROUTES = ("cluster", "split")
KINDS = ("xor", "int8")

# wrapper calls that launched each kernel (main-path evidence)
LAUNCHES = {"xor_fp_lanes": 0, "int8_fp_lanes": 0}
_entries = {}


class CodecPlan(NamedTuple):
    """A codec kernel's grid (``csrc/codec.cu``): each chunk's R rows cut
    into ``runs`` runs of ``rows_per_cta`` rows (the last shorter or
    empty; even for int8, so that quant blocks never straddle CTAs), its
    lanes into slices of ``pieces`` 16-byte pieces of a row (int8: whole
    rows, 32); one CTA a (run, slice, group of ``groups`` chunks).
    ``route``: "cluster" (the runs of a slice are one thread-block
    cluster, up to 16 CTAs, that writes the lanes) or "split" (int8: the
    runs are plain CTAs that write q and scale, any number of them, and
    the fingerprint kernel then writes the lanes from ``cur``)."""
    route: str
    rows_per_cta: int
    runs: int
    pieces: int
    groups: int


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def codec_plan(C: int, R: int, kind: str) -> CodecPlan:
    """The grid for ``C`` chunks of ``R`` rows; ``kind`` "xor" or "int8".

    XOR: the widest slices (256 bytes of each row down to 32) that give at
    least ``CTA_TARGET`` CTAs of one run each, none reading more than
    ``SLICE_BYTES`` of each input; a CTA takes as many short chunks
    (``groups``, up to 8) as keep that many CTAs and that bound.  Where no
    slicing gets there (one or a few long chunks: the fold's), slices of
    64 bytes and runs of rows (a slice's runs one cluster, up to 16, none
    shorter than one round of loads), as many as reach ``CTA_TARGET``
    CTAs or the bound.
    int8: a warp a quant block, each CTA one quant block a warp: a CTA
    takes as many short chunks as it has warps for (the serving grid's
    4-row chunks: 4 a CTA); a chunk's runs are one cluster where they are
    16 or fewer (every trainer leaf's); else (the fold's 4096 quant blocks)
    the split route, q and scale over that many plain CTAs (512 at the
    fold), then the fingerprint kernel over ``cur``, still in L2."""
    if C < 1 or R < 1:
        raise ValueError(f"{C} chunks of {R} rows")
    if kind == "xor":
        for pieces in WIDEST_PIECES:
            ctas = C * (ROW_PIECES // pieces)
            per_chunk = R * pieces * 16  # bytes of each input a CTA reads
            if ctas >= CTA_TARGET and per_chunk <= SLICE_BYTES:
                groups = min(MAX_GROUPS, _pow2_floor(ctas // CTA_TARGET),
                             _pow2_floor(SLICE_BYTES // per_chunk))
                return CodecPlan("cluster", R, 1, pieces, groups)
        pieces = FEW_CHUNK_PIECES
        ctas = C * (ROW_PIECES // pieces)
        runs = max(1, min(MAX_RUNS, -(-R // (THREADS // pieces)),
                          max(-(-CTA_TARGET // ctas),
                              -(-R * pieces * 16 // SLICE_BYTES))))
        return CodecPlan("cluster", -(-R // runs), runs, pieces, 1)
    if kind != "int8":
        raise ValueError(f"kind {kind!r}: want one of {KINDS}")
    nb = -(-R // _QROWS)
    groups = min(MAX_GROUPS, _pow2_floor(C), _pow2_ceil(-(-WARPS // nb)))
    if groups > 1:
        return CodecPlan("cluster", _QROWS * nb, 1, ROW_PIECES, groups)
    runs = -(-nb // WARPS)
    if runs > MAX_RUNS:
        return CodecPlan("split", _QROWS * WARPS, runs, ROW_PIECES, 1)
    return CodecPlan("cluster", _QROWS * -(-nb // runs), runs, ROW_PIECES, 1)


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


def _launcher(name: str, n_pointers: int, n_ints: int):
    if name not in _entries:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entries[name] = build.entry(f"{name}_launch",
                                     [p] * n_pointers + [i] * n_ints + [p])
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
    if C < 1 or R < 1:
        raise ValueError(f"{name}: {C} chunks of {R} rows")
    # the kernels read 16 bytes a thread
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in (cur, par))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def xor_fp_lanes(cur_words, par_words, *, plan: CodecPlan = None):
    """Fused pass on the CUDA kernel: ``[C, R, 128]`` int32 words x2 ->
    (fingerprint lanes ``[C, 128]``, xor words ``[C, R, 128]``).  One
    launch; ``plan`` (default ``codec_plan(C, R, "xor")``) sets the grid,
    and every plan gives the same bits."""
    cur, par = _check_pair("xor_fp_lanes", cur_words, par_words)
    C, R, _ = cur.shape
    plan = plan or codec_plan(C, R, "xor")
    if plan.route != "cluster":
        raise ValueError(f"xor_fp_lanes: plan {plan}: the XOR kernel's runs "
                         "of a slice are one cluster")
    lanes = build.empty_written((C, LANES), torch.int32, cur.device)
    xor = build.empty_written(cur.shape, torch.int32, cur.device)
    err = _launcher("xor_fp_lanes", 4, 6)(
        cur.data_ptr(), par.data_ptr(), lanes.data_ptr(), xor.data_ptr(),
        C, R, plan.rows_per_cta, plan.runs, plan.pieces, plan.groups,
        _stream(cur))
    build.check("xor_fp_lanes", err)
    LAUNCHES["xor_fp_lanes"] += 1
    return lanes, xor


def int8_fp_lanes(cur_words, par_words, *, plan: CodecPlan = None):
    """Fused pass on the CUDA kernel: ``[C, R, 128]`` int32 words x2 (an
    odd ``R``'s missing row read as zeros, as ``pair_rows`` pads) ->
    (fingerprint lanes ``[C, 128]``, q int8 ``[C, ceil(R/2), 256]``, scale
    float32 ``[C, ceil(R/2)]``).  ``plan`` (default ``codec_plan(C, R,
    "int8")``) sets the grid and route, and every plan gives the same
    bits."""
    cur, par = _check_pair("int8_fp_lanes", cur_words, par_words)
    C, R, _ = cur.shape
    plan = plan or codec_plan(C, R, "int8")
    if plan.route not in ROUTES or plan.pieces != ROW_PIECES:
        raise ValueError(f"int8_fp_lanes: plan {plan}: want a route of "
                         f"{ROUTES} over whole rows ({ROW_PIECES} pieces)")
    split = plan.route == "split"
    if split and C > fp.MAX_CHUNKS:
        raise ValueError(f"int8_fp_lanes: the split route's fingerprint "
                         f"takes at most {fp.MAX_CHUNKS} chunks, not {C}")
    nb = -(-R // _QROWS)
    lanes = build.empty_written((C, LANES), torch.int32, cur.device)
    q = build.empty_written((C, nb, QBLOCK), torch.int8, cur.device)
    scale = build.empty_written((C, nb), torch.float32, cur.device)
    err = _launcher("int8_fp_lanes", 5, 6)(
        cur.data_ptr(), par.data_ptr(), lanes.data_ptr(), q.data_ptr(),
        scale.data_ptr(), C, R, plan.rows_per_cta, plan.runs, plan.groups,
        int(split), _stream(cur))
    build.check("int8_fp_lanes", err)
    if split:
        # the lanes from the fingerprint kernel, over cur still in L2
        fpp = fp.fingerprint_plan(C, R)
        err = fp._launcher()(cur.data_ptr(), lanes.data_ptr(), C, R,
                             fpp.rows_per_cta, fpp.runs, fpp.pieces,
                             _stream(cur))
        build.check("int8_fp_lanes (fingerprint_lanes)", err)
    LAUNCHES["int8_fp_lanes"] += 1
    return lanes, q, scale
