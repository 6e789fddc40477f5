"""CUDA kernel for the chunkwise-parallel mLSTM, and its autograd wrapper.

Port of ``repro.kernels.mlstm`` (a Pallas TPU kernel) to a hand-written
kernel for Hopper, ``csrc/mlstm.cu`` (three launches on one stream: the
gate scan, the chunks' decay-weighted scores, then the output and the
carried state); the source says what bounds it and how its design meets
that.  Like the TPU kernel it starts from a fresh state and returns the
outputs only, in q's dtype.  Its plain PyTorch version is
``repro_torch.kernels.ref.chunkwise_mlstm``, which ``ops.mlstm_scan`` runs
for CPU tensors.

The reference has no backward kernel (JAX differentiates its jnp path),
and neither has the port: ``MLSTMScan``'s backward recomputes the
chunkwise plain version from the saved inputs and returns its gradients
(the recurrent form would keep a float32 ``C`` of ``[B,H,D,D]`` for every
step).

Every sum runs in a fixed order, with no atomics, so two launches give the
same bits.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)
MAX_CHUNK = 128
MAX_D = 512

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("mlstm_launch",
                             [i] + [p] * 14 + [i] * 5 + [ctypes.c_float, p])
    return _entry


def mlstm(q, k, v, i_gate, f_gate, *, chunk: int = MAX_CHUNK):
    """q/k/v [B,S,H,D] (float32 or bfloat16 alike); i_gate/f_gate [B,S,H]
    float32 -> h [B,S,H,D] in q's dtype, from a fresh state, in chunks of
    ``min(chunk, S)`` steps (which must divide S).

    Launches the CUDA kernel; every tensor must lie on the current CUDA
    device, contiguous."""
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError("mlstm kernel needs CUDA tensors "
                         "(ops.mlstm_scan runs the plain version on CPU)")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: need [B,S,H,D]")
    B, S, H, D = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, gates {tuple(i_gate.shape)}, "
                         f"{tuple(f_gate.shape)}: need [B,S,H,D] x 3 and "
                         "[B,S,H] x 2")
    T = min(chunk, S)
    if min(B, S, H, D) < 1 or D > MAX_D or not 1 <= T <= MAX_CHUNK \
            or S % T:
        raise ValueError(f"B={B} S={S} H={H} D={D} chunk={T}: need "
                         f"non-empty inputs, D <= {MAX_D} and a chunk of at "
                         f"most {MAX_CHUNK} that divides S")
    if (q.dtype not in _DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype or i_gate.dtype != torch.float32
            or f_gate.dtype != torch.float32):
        raise ValueError(f"dtypes q/k/v {q.dtype}/{k.dtype}/{v.dtype}, "
                         f"gates {i_gate.dtype}/{f_gate.dtype}: q, k and v "
                         f"one of {list(_DTYPE_CODES)}, the gates float32")
    tensors = (q, k, v, i_gate, f_gate)
    if (any(t.device != q.device for t in tensors)
            or q.device.index != torch.cuda.current_device()):
        raise ValueError("mlstm inputs must lie on the current CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm inputs must be contiguous")
    nc = S // T

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=q.device)

    h = torch.empty_like(q)
    bcum, w, mrow, inter, rowsum = (scratch(B * H, S) for _ in range(5))
    m_in, decay = scratch(B * H, nc), scratch(B * H, nc)
    scores = scratch(B * H, nc, T, T)
    scale = float(np.float32(1.0 / D ** 0.5))  # as ref.chunkwise_mlstm
    err = _launcher()(
        _DTYPE_CODES[q.dtype], *(t.data_ptr() for t in tensors),
        h.data_ptr(), bcum.data_ptr(), w.data_ptr(), m_in.data_ptr(),
        decay.data_ptr(), scores.data_ptr(), mrow.data_ptr(),
        inter.data_ptr(), rowsum.data_ptr(), B, S, H, D, T, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("mlstm", err)
    LAUNCHES += 1
    return h


class MLSTMScan(torch.autograd.Function):
    """The kernel forward; backward through the chunkwise plain version."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk: int):
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        ctx.chunk = chunk
        return mlstm(q, k, v, i_gate, f_gate, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_h):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            h = ref.chunkwise_mlstm(*inputs, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                h, [t for t, n in zip(inputs, need) if n], grad_h))
        return (*(next(grads) if n else None for n in need), None)
