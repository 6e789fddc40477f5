"""Shared layers: initializers, norms, RoPE, embeddings.

Port of ``repro.models.common``.  Params are plain dicts of tensors.

Initializers return ``Leaf`` specs (shape, scale, dtype and the
reference's logical sharding axes), not tensors; ``split_params`` turns a
spec tree into meta tensors and its axes tree, as the reference's
``split_params`` does for a ``ParamLeaf`` tree;
``draw`` fills tensors from them on a pool of host threads.  A leaf is
named by its path in the params tree (and its row, for a leaf stacked
over layer groups), and every block of ``BLOCK`` elements of it is drawn
from its own generator, seeded from a hash of (seed, name, block).  The
draw runs on the host for every device and does not depend on the order
of the blocks, so a seed gives the same weights on every device and for
any thread count.  They will not match JAX's threefry draws (tests load
the reference's weights through ``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

BLOCK = 1 << 20  # elements drawn from one generator
# P(|z| < 2) for a standard normal z: sqrt(2) erfinv(u), u uniform on
# (-_TRUNC, _TRUNC), is z truncated to (-2, 2)
_TRUNC = math.erf(math.sqrt(2.0))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter leaf to draw: truncated normal on [-2, 2] times
    ``scale``; zeros where ``scale`` is 0.  ``axes`` are its logical
    sharding axes, one name (or None) a dim; the draw never reads them."""
    shape: Tuple[int, ...]
    scale: float
    dtype: torch.dtype = torch.float32
    axes: Tuple[Optional[str], ...] = ()


def _axes(shape, axes) -> Tuple[Optional[str], ...]:
    axes = (None,) * len(shape) if axes is None else tuple(axes)
    assert len(axes) == len(shape), (shape, axes)
    return axes


def param(shape: Sequence[int], axes: Optional[Sequence] = None,
          scale: Optional[float] = None, dtype=torch.float32) -> Leaf:
    """Truncated-normal init with fan-in scaling (scale=None) or constant std."""
    shape = tuple(shape)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
        scale = 1.0 / np.sqrt(max(1, fan_in))
    return Leaf(shape, float(scale), dtype, _axes(shape, axes))


def zeros_param(shape: Sequence[int], axes: Optional[Sequence] = None,
                dtype=torch.float32) -> Leaf:
    return Leaf(tuple(shape), 0.0, dtype, _axes(shape, axes))


def stack_leaves(tree, n: int):
    """A block's spec tree stacked ``n`` times over a leading ``layers``
    axis (the reference's ``transformer._stack_layers``)."""
    if isinstance(tree, dict):
        return {k: stack_leaves(v, n) for k, v in tree.items()}
    return dataclasses.replace(tree, shape=(n,) + tree.shape,
                               axes=("layers",) + tree.axes)


def split_params(tree, dtype=None):
    """A spec tree -> (meta tensors of its shapes and dtypes, its axes
    tree), the reference's ``split_params`` over ``jax.eval_shape``.
    ``dtype`` replaces every float32 leaf's dtype.  Nothing is allocated."""
    if isinstance(tree, dict):
        pairs = {k: split_params(v, dtype) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    dt = dtype if dtype is not None and tree.dtype == torch.float32 \
        else tree.dtype
    return torch.empty(tree.shape, dtype=dt, device="meta"), tree.axes


def _replicated_dims(x, dims, lead: int = 1):
    """A DTensor ``x`` replicated along each dim of ``dims`` that is split
    over mesh axes, unless ``lead`` is a multiple of the dim's shard
    count (pass ``lead`` 0 to replicate every split one)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = list(x.placements)
    mesh = x.device_mesh
    drop = set()
    for d in dims:
        n = math.prod(mesh.size(m) for m, p in enumerate(pl) if p == Shard(d))
        if n > 1 and (lead == 0 or lead % n):
            drop.add(d)
    if not drop:
        return x
    return x.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                 and p.dim in drop else p for p in pl])


def _split(x, dim, sizes):
    x = _replicated_dims(x, (dim,), sizes[0])
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes)
                     + tuple(x.shape[dim + 1:]))


def _merge(x, dim, n):
    x = _replicated_dims(x, range(dim + 1, dim + n), 0)
    return x.reshape(tuple(x.shape[:dim]) + (-1,)
                     + tuple(x.shape[dim + n:]))


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.n = dim, len(sizes)
        return _split(x, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _merge(g, ctx.dim, ctx.n), None, None


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return _merge(x, dim, n)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, ctx.sizes), None, None


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` split into ``sizes`` (a view).  DTensor cannot
    view a dim split over mesh axes whose size does not divide
    ``sizes[0]``, nor merge a split inner dim: such a DTensor (or its
    gradient) is first replicated along that dim."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _SplitDim.apply(x, dim, tuple(sizes))
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes)
                     + tuple(x.shape[dim + 1:]))


def merge_dims(x, dim: int, n: int = 2):
    """``x`` with dims ``dim .. dim+n-1`` merged into one (a view; see
    ``split_dim`` for a DTensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _MergeDims.apply(x, dim, n)
    return x.reshape(tuple(x.shape[:dim]) + (-1,) + tuple(x.shape[dim + n:]))


def leaf_paths(tree, path: str = ""):
    """(path, leaf) of every leaf of a nested dict, ``a/b/c`` style."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def allocate(tree, lead: Tuple[int, ...] = (), device="cpu"):
    """Uninitialized tensors of a spec tree's shapes (with leading axes
    ``lead``) and dtypes, on ``device``."""
    if isinstance(tree, dict):
        return {k: allocate(v, lead, device) for k, v in tree.items()}
    return torch.empty(lead + tree.shape, dtype=tree.dtype, device=device)


def _draw_block(seed: int, name: str, leaf: Leaf, out, j: int, buffer):
    """Block ``j`` of a leaf into ``out`` (the leaf's elements, flat, on
    any device).  u uniform on [0, 1) from the block's PCG64 stream,
    then sqrt(2) erfinv((2u - 1) _TRUNC), clamped to [-2, 2], times the
    scale, in float32; drawn in place on the host, or into ``buffer()``
    and copied to ``out``."""
    dst = out[j * BLOCK:(j + 1) * BLOCK]
    direct = dst.device.type == "cpu" and dst.dtype == torch.float32
    x = dst if direct else buffer()[:dst.numel()]
    key = hashlib.blake2b(f"{seed}/{name}/{j}".encode(), digest_size=16)
    seq = np.random.SeedSequence(int.from_bytes(key.digest(), "little"))
    np.random.Generator(np.random.PCG64(seq)).random(out=x.numpy(),
                                                     dtype=np.float32)
    x.mul_(2 * _TRUNC).sub_(_TRUNC).erfinv_().mul_(math.sqrt(2.0))
    x.clamp_(-2.0, 2.0).mul_(leaf.scale)
    if not direct:
        dst.copy_(x)


def draw(seed: int, items: Iterable) -> None:
    """Fill each ``(name, leaf, out)`` item's tensor ``out`` (the leaf's
    shape, contiguous, on any device): zeros at once, drawn leaves block
    by block on as many host threads as torch's intra-op thread count.
    Each thread holds at most one block on the host."""
    jobs = []
    for name, leaf, out in items:
        if leaf.scale == 0.0:
            out.zero_()
            continue
        flat = out.view(-1)
        jobs += [(name, leaf, flat, j)
                 for j in range(-(-flat.numel() // BLOCK))]
    local = threading.local()

    def buffer():
        if not hasattr(local, "buf"):
            local.buf = torch.empty(BLOCK, dtype=torch.float32)
        return local.buf

    def run(job):
        _draw_block(seed, *job, buffer)

    threads = torch.get_num_threads()
    # the pool's threads are the parallelism: torch's intra-op threads
    # on top of them would oversubscribe the cores
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(threads) as pool:
            for _ in pool.map(run, jobs):
                pass
    finally:
        torch.set_num_threads(threads)


def materialize(tree, seed: int, path: str = "", row: Optional[int] = None,
                device="cpu"):
    """A spec tree -> the same tree of tensors on ``device``, each leaf
    drawn under its name: ``path/<its keys>``, and ``[row]`` where it is
    row ``row`` of a leaf stacked over layer groups."""
    out = allocate(tree, device=device)
    draw(seed, ((leaf_name(p, row), leaf, t) for (p, leaf), (_, t)
                in zip(leaf_paths(tree, path), leaf_paths(out))))
    return out


def leaf_name(path: str, row: Optional[int] = None) -> str:
    """The name a leaf is drawn under (``row``: its row of a stacked leaf)."""
    return path if row is None else f"{path}[{row}]"


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def soft_cap(x, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


# ---------------------------------------------------------------------------
# rotary position embeddings (default, partial and multimodal rope) and
# sinusoidal positions
# ---------------------------------------------------------------------------

def _rope_angles(positions, dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, dim/2] (fp32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10_000.0, fraction: float = 1.0):
    """x [B,S,H,D]; positions [B,S].  ``fraction`` < 1 rotates only the first
    ``fraction*D`` dims (chatglm-style partial / "2d" rope)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos, sin = _rope_angles(positions, rot, theta)  # [B,S,rot/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def apply_mrope(x, positions_thw, sections: Tuple[int, int, int],
                theta: float):
    """Qwen2-VL multimodal RoPE.

    x [B,S,H,D]; positions_thw [3,B,S] (temporal, height, width ids).  The
    D/2 frequency slots are split into ``sections`` (t,h,w), rescaled to
    D/2 with integer arithmetic (the last section takes the remainder);
    each slot takes its angle from its section's position component,
    chosen by a one-hot product in float32 (exact for integer ids below
    2^24), as the reference does.  The whole head is rotated.  For
    text tokens the three ids are equal: standard RoPE.
    """
    d = x.shape[-1]
    half = d // 2
    secs = np.array(sections, dtype=np.int64)
    secs = (secs * half // secs.sum()).tolist()
    secs[-1] = half - sum(secs[:-1])
    dev = x.device
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=dev) / d))
    comp = np.repeat(np.arange(3), secs)  # [half]: each slot's component
    onehot = torch.from_numpy(np.eye(3, dtype=np.float32)[comp]).to(dev)
    # pos_slot [B,S,half] = sum_c onehot[half,c] * positions[c,B,S], as
    # products and sums of float32 tensors (no GEMM: TF32 cannot touch it)
    pos_slot = (onehot.T[:, None, None, :]
                * positions_thw.float()[..., None]).sum(0)
    ang = pos_slot * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_for(cfg, x, positions, local: bool):
    """Dispatch on cfg.rope_kind.  ``positions`` is [B,S], or [3,B,S] for
    ``mrope`` (2-D ids are broadcast: t = h = w)."""
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    frac = cfg.rope_fraction if cfg.rope_kind == "partial" else 1.0
    return apply_rope(x, positions, theta, frac)


def sinusoidal_positions(seq: int, dim: int):
    """[seq, dim] float32: sin then cos of pos / 10000^(2i/dim), computed in
    float64 numpy and rounded once, as the reference does."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / dim)
    return torch.from_numpy(
        np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg):
    return {"table": param((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), scale=0.02)}


def embed(params, ids, cfg):
    """Rows of the table in the compute dtype, times sqrt(d_model) rounded
    to that dtype (as the reference scales).  ``index_select`` gathers the
    rows: its backward is a deterministic ``index_add_`` on CUDA."""
    table = params["table"].to(cfg.compute_dtype)
    x = table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)
    # a 0-dim CPU tensor enters a CUDA product as a scalar: no copy
    return x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()


def unembed(params, x, cfg, table=None):
    """Logits via the (tied) embedding table or a dedicated head."""
    t = table if table is not None else params["table"]
    return torch.einsum("bsd,vd->bsv", x, t.to(x.dtype))
