"""CUDA kernel for train/prefill attention, and its autograd wrapper.

Port of ``repro.kernels.flash_attention`` (a Pallas TPU kernel) to
hand-written kernels for Hopper, ``csrc/flash_attention.cu``; the source
says what bounds it and how its design meets that.  Its plain PyTorch
version is ``repro_torch.kernels.ref.naive_attention``, which
``ops.attention`` runs for CPU tensors.

Two routes, both on the tensor cores, picked by ``route(dtype, D)`` and
nothing else: bf16 with ``D % 16 == 0`` runs ``wgmma`` on bf16 (K/V tiles
by TMA); float32, and bf16 with another D, run "tf32x3": each float32
operand x is held as tf32 hi = rna(x) and lo = rna(x - hi), and each
product is lo.hi + hi.lo + hi.hi into a float32 accumulator, which keeps
float32's accuracy where one TF32 product (10-bit mantissa) would not.
``flash_f32_plan(D)`` sizes that route's tiles, as its launch code does.

The reference has no backward kernel (JAX differentiates its jnp path),
and neither has the port yet: ``FlashAttention``'s backward recomputes
the plain version from the saved q, k, v and returns its gradients
(plain PyTorch on the card, deterministic under
``torch.use_deterministic_algorithms``).

The kernel's walk is a pure function of the shape, so a given shape
always sums in the same order: replay stays bit-exact on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.ref import attn_scale

LAUNCHES = 0  # wrapper calls that launched a kernel (main-path evidence)
WGMMA_LAUNCHES = 0  # of those, the ones on the wgmma route
TF32X3_LAUNCHES = 0  # ... and the ones on the tf32x3 route

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entries = {}


def route(dtype: torch.dtype, D: int) -> str:
    """"wgmma" (bf16, D a multiple of 16: bf16 products) or "tf32x3"
    (float32, and bf16 with another D: split tf32 products)."""
    if dtype not in _DTYPE_CODES or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"dtype {dtype}, D={D}: the kernel takes "
                         f"{list(_DTYPE_CODES)} and D <= {MAX_HEAD_DIM}")
    return "wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "tf32x3"


SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may take (H100)


class F32Plan(NamedTuple):
    """The tf32x3 route's tiles (csrc/flash_attention.cu: tf_groups,
    tf_keys, tf_prefetch, tf_smem_bytes; ``launch_f32_plan`` reads them
    from the built library, and the card's checks hold the two equal at
    every D)."""
    cols: int        # D padded to 32-column boxes: the products' depth
    groups: int      # warpgroups a CTA, taking kv tiles in turn
    keys: int        # keys per kv tile (the N of S = Q.K^T)
    prefetch: bool   # the next tile's K and V wait in registers
    smem_bytes: int  # dynamic shared memory of a CTA


def flash_f32_plan(D: int) -> F32Plan:
    """Tiles for head dim ``D``: Q [64 x cols] and, for each warpgroup, K
    [keys x cols] and V^T [cols x max(keys, 32)] in shared memory as tf32
    hi and lo, 1 KB to align them.  Up to D 128 two warpgroups take 32-key
    tiles in turn, each loading its next one during its products (64
    floats a thread at most); above, one warpgroup, and at D 256 16-key
    tiles, where Q's hi and lo alone take 128 KB."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"D={D}: the kernel takes 1 <= D <= {MAX_HEAD_DIM}")
    cols = -(-D // 32) * 32
    groups = 2 if cols <= 128 else 1
    keys = 32 if cols <= 224 else 16
    smem = 1024 + 2 * 4 * (64 * cols
                           + groups * (keys * cols + cols * max(keys, 32)))
    return F32Plan(cols, groups, keys, cols <= 128, smem)


def launch_f32_plan(D: int) -> F32Plan:
    """The plan the tf32x3 launch code takes for head dim ``D`` (its
    constexprs, read from the built library: needs the card's build), to
    hold ``flash_f32_plan`` to."""
    out = (ctypes.c_int * 5)()
    build.check("flash_attention_tf32x3_plan", build.entry(
        "flash_attention_tf32x3_plan", [ctypes.c_int, ctypes.c_void_p])(
            D, ctypes.addressof(out)))
    cols, groups, keys, prefetch, smem = out
    return F32Plan(cols, groups, keys, bool(prefetch), smem)


def _launcher(name: str):
    if name not in _entries:
        p, i = ctypes.c_void_p, ctypes.c_int
        args = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        if name == "tf32x3":
            args = [i] + args
        _entries[name] = build.entry(
            {"tf32x3": "flash_attention_tf32x3_launch",
             "wgmma": "flash_attention_wgmma_launch"}[name], args)
    return _entries[name]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,D]; k/v [B,Sk,Hkv,D] -> [B,Sq,H,D] in q's dtype.

    Launches the CUDA kernel of ``route(q.dtype, D)``; every tensor must
    lie on the current CUDA device, contiguous, float32 or bfloat16 alike
    (16-byte aligned on the wgmma route)."""
    global LAUNCHES, WGMMA_LAUNCHES, TF32X3_LAUNCHES
    if not q.is_cuda:
        raise ValueError("flash_attention kernel needs CUDA tensors "
                         "(ops.attention runs the plain version on CPU)")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                         f"takes one of {list(_DTYPE_CODES)}")
    if min(B, Sq, Sk, Hkv) < 1 or H % Hkv or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D}: need "
                         f"non-empty inputs, Hkv | H, D <= {MAX_HEAD_DIM}")
    if (any(t.device != q.device for t in (k, v))
            or q.device.index != torch.cuda.current_device()):
        raise ValueError("flash_attention inputs must lie on the current "
                         "CUDA device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention inputs must be contiguous")
    path = route(q.dtype, D)
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention inputs must be 16-byte aligned "
                         "on the wgmma route")
    out = build.empty_written(q.shape, q.dtype, q.device)  # every row written
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, Hkv, D, int(bool(causal)), int(window or 0),
            attn_scale(D), torch.cuda.current_stream(q.device).cuda_stream)
    if path == "tf32x3":
        args = (_DTYPE_CODES[q.dtype],) + args
    build.check("flash_attention", _launcher(path)(*args))
    LAUNCHES += 1
    WGMMA_LAUNCHES += path == "wgmma"
    TF32X3_LAUNCHES += path == "tf32x3"
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.naive_attention(*inputs, causal=ctx.causal,
                                      window=ctx.window)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad[:3])),
                None, None)
