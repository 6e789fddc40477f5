"""CUDA kernel for the RG-LRU recurrence, and its autograd wrapper.

Port of ``repro.kernels.rglru`` (a Pallas TPU kernel) to a hand-written
kernel for Hopper, ``csrc/rglru.cu``; the source says what bounds it and
how its design meets that: the gates computed chunk by chunk over (b,
chunk, w) while one warp carries each channel's state through the chunks
in order, laid out by ``scan_plan``.  Its plain PyTorch
version is ``repro_torch.kernels.ref.naive_rglru``, which
``ops.rglru_scan`` runs for CPU tensors.

The reference has no backward kernel (JAX differentiates its jnp path),
and neither has the port: ``RGLRUScan``'s backward recomputes the plain
version from the saved inputs and returns its gradients.

One warp walks each channel's chain through the chunks in order, with the
plain version's two roundings a step, so the kernel gives the plain
version's bits, and two launches give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)

PRODUCERS = 7        # warps computing gates (csrc: kProducers)
LANE_STEPS = (1, 2, 4, 8)  # steps a producer lane takes a chunk
LONG = 224           # sequences this long take 4 steps a lane, else 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


class ScanPlan(NamedTuple):
    chunk: int      # steps a chunk: PRODUCERS * 2 * steps_per_lane
    n_chunks: int   # chunks of the sequence, walked in order


def scan_plan(B: int, S: int, W: int) -> ScanPlan:
    """How ``csrc/rglru.cu`` cuts a [B,S,W] scan, from the shape alone.

    Each block takes one batch row and 16 channels; its producer warps
    compute a chunk's gates while its walker runs the chunk before, so
    work overlaps only from the second chunk on.  Short sequences take
    chunks of 14 steps (one a producer lane: at launch.serve's 32-token
    prefill three chunks, 10.48 us against 12.10 for one chunk of 56),
    long ones chunks of 56 (four a lane: at 2304 tokens 104.92 us, against
    108.67, 114.92 and 124.66 for 112, 28 and 14; measured with
    tools/profile_torch_scan.py --sweep on an H100 80GB HBM3, 700 W).
    ``B`` and ``W`` set only the grid."""
    chunk = 2 * PRODUCERS * (1 if S < LONG else 4)
    return ScanPlan(chunk, -(-S // chunk))


def chunk_bounds(plan: ScanPlan, S: int) -> list:
    """[(t0, t1)] of each chunk, in the order the walker takes them."""
    return [(k * plan.chunk, min(S, (k + 1) * plan.chunk))
            for k in range(plan.n_chunks)]


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("rglru_launch",
                             [i, p, p, p, p, p, p, p, i, i, i, i,
                              ctypes.c_float, p])
    return _entry


def rglru(x, a_param, gate_a, gate_x, h0=None, *, c: float = 8.0,
          plan: ScanPlan | None = None):
    """x/gate_a/gate_x [B,S,W] (float32 or bfloat16 alike); a_param [W]
    float32; h0 [B,W] float32 or None -> (h_seq [B,S,W] in x's dtype,
    h_last [B,W] float32).

    Launches the CUDA kernel with ``scan_plan(B, S, W)``, or ``plan``
    (another chunk the kernel takes: how a measurement compares chunks);
    every tensor must lie on the current CUDA device, contiguous."""
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
    if min(B, S, W) < 1 or S * W >= 2 ** 31:
        raise ValueError(f"B={B} S={S} W={W}: need non-empty inputs and "
                         "S * W < 2**31")
    tensors = [t for t in (x, a_param, gate_a, gate_x, h0) if t is not None]
    if (any(t.device != x.device for t in tensors)
            or x.device.index != torch.cuda.current_device()):
        raise ValueError("rglru inputs must lie on the current CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru inputs must be contiguous")
    plan = scan_plan(B, S, W) if plan is None else ScanPlan(*plan)
    lane_steps = plan.chunk // (2 * PRODUCERS)
    if (lane_steps not in LANE_STEPS or plan.chunk != 2 * PRODUCERS
            * lane_steps or plan.n_chunks != -(-S // plan.chunk)):
        raise ValueError(f"plan {plan}: need a chunk of {2 * PRODUCERS} x "
                         f"one of {LANE_STEPS} steps covering S={S}")
    h_seq = torch.empty_like(x)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    err = _launcher()(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gate_a.data_ptr(),
        gate_x.data_ptr(), a_param.data_ptr(),
        None if h0 is None else h0.data_ptr(), h_seq.data_ptr(),
        h_last.data_ptr(), B, S, W, lane_steps, float(c),
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
