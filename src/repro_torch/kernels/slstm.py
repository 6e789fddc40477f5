"""CUDA kernel for the sLSTM recurrence, and its autograd wrapper.

Port of ``repro.kernels.slstm`` (a Pallas TPU kernel) to a hand-written
kernel for Hopper, ``csrc/slstm.cu``; the source says what bounds it and
how its design meets that.  Like the TPU kernel it starts from a fresh
state and returns the outputs only.  Its plain PyTorch version is
``repro_torch.kernels.ref.naive_slstm`` with no state, which
``ops.slstm_scan`` runs for CPU tensors.

The reference has no backward kernel (JAX differentiates its jnp path),
and neither has the port: ``SLSTMScan``'s backward recomputes the plain
version from the saved inputs and returns its gradients.

Each thread sums its dot products in a fixed order and walks the steps in
order, so two launches give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)
MAX_HB = 512  # one thread per column of a head

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("slstm_launch",
                             [i, p, p, p, p, p, p, p, p, p, i, i, i, i, p])
    return _entry


def slstm(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o):
    """x_* [B,S,W] (float32 or bfloat16 alike); r_* [H,hb,hb] float32 with
    H * hb = W -> h_seq [B,S,W] in x's dtype, from a fresh state.

    Launches the CUDA kernel; every tensor must lie on the current CUDA
    device, contiguous."""
    global LAUNCHES
    xs, rs = (x_i, x_f, x_z, x_o), (r_i, r_f, r_z, r_o)
    if not x_i.is_cuda:
        raise ValueError("slstm kernel needs CUDA tensors "
                         "(ops.slstm_scan runs the plain version on CPU)")
    if x_i.dim() != 3 or r_i.dim() != 3:
        raise ValueError(f"x {tuple(x_i.shape)}, r {tuple(r_i.shape)}: need "
                         "[B,S,W] and [H,hb,hb]")
    B, S, W = x_i.shape
    H, hb = r_i.shape[0], r_i.shape[1]
    if (any(x.shape != x_i.shape for x in xs)
            or any(r.shape != (H, hb, hb) for r in rs) or H * hb != W):
        raise ValueError(f"shapes x {[tuple(x.shape) for x in xs]}, r "
                         f"{[tuple(r.shape) for r in rs]}: need four [B,S,W] "
                         "and four [H,hb,hb] with H * hb = W")
    if hb > MAX_HB or min(B, S, W) < 1:
        raise ValueError(f"B={B} S={S} hb={hb}: need non-empty inputs and "
                         f"hb <= {MAX_HB}")
    if (x_i.dtype not in _DTYPE_CODES
            or any(x.dtype != x_i.dtype for x in xs)
            or any(r.dtype != torch.float32 for r in rs)):
        raise ValueError(f"dtypes x {[x.dtype for x in xs]}, r "
                         f"{[r.dtype for r in rs]}: x one of "
                         f"{list(_DTYPE_CODES)}, r float32")
    tensors = xs + rs
    if (any(t.device != x_i.device for t in tensors)
            or x_i.device.index != torch.cuda.current_device()):
        raise ValueError("slstm inputs must lie on the current CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("slstm inputs must be contiguous")
    h_seq = torch.empty_like(x_i)
    err = _launcher()(
        _DTYPE_CODES[x_i.dtype], *(t.data_ptr() for t in tensors),
        h_seq.data_ptr(), B, S, H, hb,
        torch.cuda.current_stream(x_i.device).cuda_stream)
    build.check("slstm", err)
    LAUNCHES += 1
    return h_seq


class SLSTMScan(torch.autograd.Function):
    """The kernel forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o):
        ctx.save_for_backward(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o)
        return slstm(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o)

    @staticmethod
    def backward(ctx, grad_seq):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            h_seq, _ = ref.naive_slstm(*inputs)
            grads = iter(torch.autograd.grad(
                h_seq, [t for t, n in zip(inputs, need) if n], grad_seq))
        return tuple(next(grads) if n else None for n in need)
