"""CUDA kernel for the RG-LRU recurrence, and its autograd wrapper.

Port of ``repro.kernels.rglru`` (a Pallas TPU kernel) to a hand-written
kernel for Hopper, ``csrc/rglru.cu``; the source says what bounds it and
how its design meets that.  Its plain PyTorch version is
``repro_torch.kernels.ref.naive_rglru``, which ``ops.rglru_scan`` runs for
CPU tensors.

The reference has no backward kernel (JAX differentiates its jnp path),
and neither has the port: ``RGLRUScan``'s backward recomputes the plain
version from the saved inputs and returns its gradients.

Each thread walks its channel's sequence in order, so two launches give
the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("rglru_launch",
                             [i, p, p, p, p, p, p, p, i, i, i,
                              ctypes.c_float, p])
    return _entry


def rglru(x, a_param, gate_a, gate_x, h0=None, *, c: float = 8.0):
    """x/gate_a/gate_x [B,S,W] (float32 or bfloat16 alike); a_param [W]
    float32; h0 [B,W] float32 or None -> (h_seq [B,S,W] in x's dtype,
    h_last [B,W] float32).

    Launches the CUDA kernel; every tensor must lie on the current CUDA
    device, contiguous."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("rglru kernel needs CUDA tensors "
                         "(ops.rglru_scan runs the plain version on CPU)")
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: need [B,S,W]")
    B, S, W = x.shape
    if gate_a.shape != x.shape or gate_x.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, gate_a "
                         f"{tuple(gate_a.shape)}, gate_x {tuple(gate_x.shape)}")
    if a_param.shape != (W,) or (h0 is not None and h0.shape != (B, W)):
        raise ValueError(f"a_param {tuple(a_param.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}: need "
                         f"[{W}] and [{B},{W}]")
    if (x.dtype not in _DTYPE_CODES or gate_a.dtype != x.dtype
            or gate_x.dtype != x.dtype or a_param.dtype != torch.float32
            or (h0 is not None and h0.dtype != torch.float32)):
        raise ValueError(
            f"dtypes x {x.dtype}, gates {gate_a.dtype}/{gate_x.dtype}, "
            f"a_param {a_param.dtype}, h0 {None if h0 is None else h0.dtype}: "
            f"x and the gates one of {list(_DTYPE_CODES)}, a_param and h0 "
            "float32")
    if min(B, S, W) < 1:
        raise ValueError(f"B={B} S={S} W={W}: need non-empty inputs")
    tensors = [t for t in (x, a_param, gate_a, gate_x, h0) if t is not None]
    if (any(t.device != x.device for t in tensors)
            or x.device.index != torch.cuda.current_device()):
        raise ValueError("rglru inputs must lie on the current CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru inputs must be contiguous")
    h_seq = torch.empty_like(x)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    err = _launcher()(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gate_a.data_ptr(),
        gate_x.data_ptr(), a_param.data_ptr(),
        None if h0 is None else h0.data_ptr(), h_seq.data_ptr(),
        h_last.data_ptr(), B, S, W, float(c),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rglru", err)
    LAUNCHES += 1
    return h_seq, h_last


class RGLRUScan(torch.autograd.Function):
    """The kernel forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, a_param, gate_a, gate_x, h0, c: float):
        ctx.save_for_backward(x, a_param, gate_a, gate_x, h0)
        ctx.c = c
        return rglru(x, a_param, gate_a, gate_x, h0, c=c)

    @staticmethod
    def backward(ctx, grad_seq, grad_last):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            h_seq, h_last = ref.naive_rglru(*inputs, c=ctx.c)
            grads = iter(torch.autograd.grad(
                (h_seq, h_last), [t for t, n in zip(inputs, need) if n],
                (grad_seq, grad_last)))
        return (*(next(grads) if n else None for n in need), None)
