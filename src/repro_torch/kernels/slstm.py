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

Two routes, chosen by ``slstm_plan`` from the shape alone: the cluster
route keeps a head's recurrent weights in the shared memory of a
thread-block cluster for the whole sequence, and the L2 route, where they
do not fit (hb 512), reads them from L2 on every step.  Both sum their dot
products in one fixed order and share the cell arithmetic, so they give
the same bits, and two launches give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0  # wrapper calls that launched the kernel (main-path evidence)
CLUSTER_LAUNCHES = 0  # ... of them on the cluster route
MAX_HB = 512  # one thread per column of a head (the L2 route)
SMS = 132            # an H100 SXM's streaming multiprocessors
MAX_CLUSTER = 16     # CTAs a cluster, above 8 non-portable (csrc: kMaxCluster)
CLUSTER_COLS = 16    # columns a CTA aims for: 2 threads a column, one warp
# of the card's CTA slots (SMs x CTAs an SM's shared memory holds), the
# share that clusters fill at once: an H100 SXM held 15 clusters of 8
# one-per-SM CTAs and 21 clusters of 16 three-per-SM CTAs at the train
# shape (cudaOccupancyMaxActiveClusters, tools/profile_torch_scan.py)
CLUSTER_FILL = 0.85
MAX_ROWS = 8         # batch rows a CTA carries at once
MAX_SMEM = 232448    # shared memory a block may have on sm_90 (kMaxSmem)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


class SLSTMPlan(NamedTuple):
    route: str     # "cluster" or "l2"
    cluster: int   # CTAs a cluster (0 on the L2 route)
    cols: int      # columns of a head each CTA holds
    rows: int      # batch rows a cluster carries (1 on the L2 route)


def cluster_smem(hb: int, cols: int, rows: int) -> int:
    """Shared memory of a cluster-route CTA (csrc: cluster_smem_floats):
    two mbarriers, its cols columns of r for 4 gates, two gates' columns
    interleaved per thread over hb padded to a multiple of 32 rows, plus 4
    floats, and h double-buffered for ``rows`` rows padded to a power of
    two."""
    rp = 1 << (rows - 1).bit_length()
    hbp = -(-hb // 32) * 32
    return 4 * (4 + 2 * cols * (2 * hbp + 4) + 2 * hbp * rp)


def slstm_plan(B: int, H: int, hb: int) -> SLSTMPlan:
    """How ``csrc/slstm.cu`` runs x [B,S,H*hb] with r [H,hb,hb], from the
    shape alone.

    A head's r columns spread over a cluster of up to ``MAX_CLUSTER``
    CTAs, about ``CLUSTER_COLS`` columns each (16 CTAs of 16 columns, 64
    KB of r each, at hb 256).  Every step a CTA reads its r slice and
    every row of h from shared memory, and its products for all the batch
    rows it carries (padded to a power of two) share each read; the
    cluster's CTAs then trade their columns of h_t.  Fewer rows a CTA mean
    more CTAs and less work each, as long as the clusters fit the card at
    once: a second wave would cost a whole first one.  So the plan takes
    the fewest rows (a power of two, at most ``MAX_ROWS``) whose clusters
    fit one wave, counting ``CLUSTER_FILL`` of the CTA slots that the
    CTA's shared memory leaves.  Where even one row's r slice and h do
    not fit a CTA's shared memory (hb 512: 4 MiB of r a head), the L2
    route: one block per (head, b row), r read from L2 every step."""
    cluster = min(MAX_CLUSTER, -(-hb // CLUSTER_COLS))
    cols = -(-hb // cluster)
    if cluster_smem(hb, cols, 1) > MAX_SMEM:
        return SLSTMPlan("l2", 0, hb, 1)
    rows = 1
    while rows < MAX_ROWS:
        per_sm = MAX_SMEM // cluster_smem(hb, cols, rows)
        ctas = -(-B // rows) * H * cluster
        if ctas <= CLUSTER_FILL * SMS * per_sm:
            break
        if cluster_smem(hb, cols, 2 * rows) > MAX_SMEM:
            break
        rows *= 2
    return SLSTMPlan("cluster", cluster, cols, rows)


def plan_groups(plan: SLSTMPlan, B: int) -> list:
    """[(b0, b1)] of batch rows each cluster (or L2 block) carries."""
    return [(b, min(B, b + plan.rows)) for b in range(0, B, plan.rows)]


def plan_columns(plan: SLSTMPlan, hb: int) -> list:
    """[(j0, j1)] of a head's columns each CTA of a cluster holds."""
    if plan.route == "l2":
        return [(0, hb)]
    return [(min(hb, r * plan.cols), min(hb, (r + 1) * plan.cols))
            for r in range(plan.cluster)]


def _launcher():
    global _entry
    if _entry is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _entry = build.entry("slstm_launch",
                             [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                              i, p])
    return _entry


def slstm(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o, *,
          plan: SLSTMPlan | None = None):
    """x_* [B,S,W] (float32 or bfloat16 alike); r_* [H,hb,hb] float32 with
    H * hb = W -> h_seq [B,S,W] in x's dtype, from a fresh state.

    Launches the CUDA kernel with ``slstm_plan(B, H, hb)``, or ``plan``
    (another plan the kernel takes: how measurements compare groupings and
    routes); every tensor must lie on the current CUDA device,
    contiguous."""
    global LAUNCHES, CLUSTER_LAUNCHES
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
    plan = slstm_plan(B, H, hb) if plan is None else SLSTMPlan(*plan)
    if (plan.route == "l2") != (plan.cluster == 0):
        raise ValueError(f"plan {plan}: the L2 route and only it has no "
                         "cluster")
    h_seq = torch.empty_like(x_i)
    err = _launcher()(
        _DTYPE_CODES[x_i.dtype], *(t.data_ptr() for t in tensors),
        h_seq.data_ptr(), B, S, H, hb, plan.cluster, plan.cols, plan.rows,
        torch.cuda.current_stream(x_i.device).cuda_stream)
    build.check(f"slstm ({plan.route} route, plan {tuple(plan)})", err)
    LAUNCHES += 1
    CLUSTER_LAUNCHES += plan.route == "cluster"
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
