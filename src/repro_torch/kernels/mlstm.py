"""CUDA kernel for the chunkwise-parallel mLSTM, and its autograd wrapper.

Port of ``repro.kernels.mlstm`` (a Pallas TPU kernel) to hand-written
kernels for Hopper, ``csrc/mlstm.cu``; the source says what bounds them and
how their design meets that.  Two routes, picked by ``route(dtype, D)``
and nothing else:

  * bf16 with ``D % 64 == 0`` (xlstm_350m's head dim 512): the chunk
    products on the tensor cores (``wgmma``, tiles by TMA), every float32
    operand fed as bf16 hi + lo; one launch for one chunk, a state pass
    and an output pass for more (``mlstm_plan`` gives their grids);
  * float32, and bf16 with another D: three launches on the CUDA cores
    (the gate scan, the chunks' decay-weighted scores, then the output and
    the carried state).  Float32 stays off the tensor cores, which would
    round its products to TF32.

Like the TPU kernel it starts from a fresh state and returns the outputs
only, in q's dtype.  Its plain PyTorch version is
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
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched a kernel (main-path evidence)
WGMMA_LAUNCHES = 0  # of those, the ones on the wgmma route
MAX_CHUNK = 128
MAX_D = 512
ROW_TILE = 64    # rows of a wgmma tile and of a TMA box
BOX_BYTES = 64 * 128  # one [64 x 64] bf16 box
MAX_BOXES = 4    # 64-column boxes of one wgmma accumulator tile
SMEM_LIMIT = 232448  # shared memory a block can use on an H100 (227 KB)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entries = {}


def route(dtype: torch.dtype, D: int) -> str:
    """"wgmma" (bf16, D a multiple of 64: tensor cores) or "float32" (the
    CUDA cores: float32, and bf16 with another D)."""
    if dtype not in _DTYPE_CODES or not 1 <= D <= MAX_D:
        raise ValueError(f"dtype {dtype}, D={D}: the kernel takes "
                         f"{list(_DTYPE_CODES)} and D <= {MAX_D}")
    return "wgmma" if dtype == torch.bfloat16 and D % 64 == 0 else "float32"


class MLSTMPlan(NamedTuple):
    """The wgmma route's grids (``csrc/mlstm.cu:wg_plan``): ``nb`` boxes of
    64 columns cover D, ``nrt`` row tiles of 64 cover a chunk of ``nc``;
    an output-pass CTA takes ``nv`` boxes of v's columns (``n_dv`` CTAs
    across them), a state-pass CTA ``nk`` boxes of k's columns (``n_dk``);
    the CTAs and dynamic shared-memory bytes of each pass (the state pass
    runs only for more than one chunk: 0 and 0 otherwise)."""
    nb: int
    nrt: int
    nc: int
    nv: int
    n_dv: int
    nk: int
    n_dk: int
    out_ctas: int
    out_smem: int
    state_ctas: int
    state_smem: int


def mlstm_plan(B: int, S: int, H: int, D: int, T: int) -> MLSTMPlan:
    """The wgmma route's plan for q [B,S,H,D] in chunks of T steps: a pure
    function of the shape.  The output pass gives a CTA at most 4 boxes of
    v's columns (256: 128 float32 accumulators a thread), and 2 when it
    also streams the carried C's hi and lo tiles."""
    nb, nrt, nc = D // 64, -(-T // ROW_TILE), S // T
    n_dv = -(-nb // (MAX_BOXES if nc == 1 else 2))
    nv = -(-nb // n_dv)
    n_dk = -(-nb // MAX_BOXES)
    nk = -(-nb // n_dk)
    out_smem = 1024 + BOX_BYTES * (2 * nb + nv + (4 * nv if nc > 1 else 0))
    state_smem = 1024 + BOX_BYTES * 2 * nrt * (nk + 1)
    return MLSTMPlan(nb, nrt, nc, nv, n_dv, nk, n_dk,
                     nrt * n_dv * nc * B * H, out_smem,
                     nb * n_dk * B * H if nc > 1 else 0,
                     state_smem if nc > 1 else 0)


def _launcher(name: str):
    if name not in _entries:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "float32":
            _entries[name] = build.entry(
                "mlstm_launch", [i] + [p] * 14 + [i] * 5 + [ctypes.c_float, p])
        else:
            _entries[name] = build.entry(
                "mlstm_wgmma_launch",
                [p] * 9 + [i] * 5 + [ctypes.c_float, p])
    return _entries[name]


def native_plan(B: int, S: int, H: int, D: int, T: int) -> MLSTMPlan:
    """The plan as ``csrc/mlstm.cu`` computes it (needs the built
    library): held against ``mlstm_plan`` on the card."""
    out = (ctypes.c_int * 11)()
    fn = build.entry("mlstm_wgmma_plan", [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    build.check("mlstm_wgmma_plan", fn(B, S, H, D, T, ctypes.addressof(out)))
    return MLSTMPlan(*out)


def mlstm(q, k, v, i_gate, f_gate, *, chunk: int = MAX_CHUNK):
    """q/k/v [B,S,H,D] (float32 or bfloat16 alike); i_gate/f_gate [B,S,H]
    float32 -> h [B,S,H,D] in q's dtype, from a fresh state, in chunks of
    ``min(chunk, S)`` steps (which must divide S).

    Launches the CUDA kernels of ``route(q.dtype, D)``; every tensor must
    lie on the current CUDA device, contiguous (q, k, v 16-byte aligned on
    the wgmma route)."""
    global LAUNCHES, WGMMA_LAUNCHES
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
    path = route(q.dtype, D)
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm inputs must be 16-byte aligned on the wgmma "
                         "route")

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=q.device)

    scale = float(np.float32(1.0 / D ** 0.5))  # as ref.chunkwise_mlstm
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if path == "wgmma":
        # h and each chunk's incoming C (bf16 hi, then lo), n and m (the
        # state pass's, for the output pass: more than one chunk only); the
        # kernels write every element that is read
        h = build.empty_written(q.shape, q.dtype, q.device)
        carry = ((build.empty_written((2, B * H, nc - 1, D, D),
                                      torch.bfloat16, q.device),
                  build.empty_written((B * H, nc - 1, D), torch.float32,
                                      q.device),
                  build.empty_written((B * H, nc), torch.float32, q.device))
                 if nc > 1 else (None, None, None))
        err = _launcher("wgmma")(
            *(t.data_ptr() for t in tensors), h.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in carry),
            B, S, H, D, T, scale, stream)
    else:
        h = torch.empty_like(q)
        bcum, w, mrow, inter, rowsum = (scratch(B * H, S) for _ in range(5))
        m_in, decay = scratch(B * H, nc), scratch(B * H, nc)
        scores = scratch(B * H, nc, T, T)
        err = _launcher("float32")(
            _DTYPE_CODES[q.dtype], *(t.data_ptr() for t in tensors),
            h.data_ptr(), bcum.data_ptr(), w.data_ptr(), m_in.data_ptr(),
            decay.data_ptr(), scores.data_ptr(), mrow.data_ptr(),
            inter.data_ptr(), rowsum.data_ptr(), B, S, H, D, T, scale,
            stream)
    build.check("mlstm", err)
    LAUNCHES += 1
    WGMMA_LAUNCHES += path == "wgmma"
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
