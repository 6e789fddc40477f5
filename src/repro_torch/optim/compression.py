"""Blockwise int8 quantization with error feedback.

Port of ``repro.optim.compression``.  The quantizer (``_quant``) is the
arithmetic core of the ``int8`` delta codec (``checkpoint/codecs.py``)
and of its fused CUDA kernel (``csrc/codec.cu``); all three give the same
bits as the reference, NaN and infinities included:

  * 256-element blocks of the flattened float32 input, zero-padded;
  * ``scale = max|x| * _INV127`` (a multiply, not a division by 127),
    then ``max(scale, 1e-12)``; both steps propagate NaN, as ``jnp.max``
    and ``jnp.maximum`` do;
  * ``q = clip(round_half_even(x / scale), -127, 127)`` with NaN -> 0
    (XLA's float -> int conversion; torch's CPU conversion would give
    ``-2^31``).

``compress_gradients``/``decompress_gradients`` keep the reference's
error-feedback contract: ``g_q = Q(g + e)``, ``e' = g + e - g_q``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import LEAF, flatten, tree_map, unflatten

BLOCK = 256
# scale = max|x| * (1/127), NOT max|x| / 127: the reference's jitted and
# eager lowerings agree only on the multiply form, and the fused codec
# kernels reproduce exactly that expression.
_INV127 = np.float32(1.0) / np.float32(127.0)
_SCALE_FLOOR = np.float32(1e-12)


def ef_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def quant_blocks(blocks):
    """The quantizer's core on ``[NB, 256]`` float32 blocks -> (q int8
    ``[NB, 256]``, scale float32 ``[NB, 1]``).  A NaN scale comes out as
    the quiet NaN ``0x7FC00000`` on every device, as the reference's
    host arithmetic gives it (a card's arithmetic makes ``0x7FFFFFFF``)."""
    # python scalars, not tensors made on the device: a CUDA graph can
    # capture this.  Both constants are float32 values, and a float32
    # product rounded once gives the same bits in float32 or float64.
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) * float(_INV127)
    floor = float(_SCALE_FLOOR)
    scale = torch.where(scale < floor, floor, scale)  # NaN stays NaN
    r = torch.clamp(torch.round(blocks / scale), -127, 127)
    q = torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
    scale = torch.where(torch.isnan(scale), float("nan"), scale)
    return q, scale


def _quant(x):
    """Blockwise symmetric int8 quantization of a float32 tensor
    -> (q int8 ``[NB, 256]``, scale float32 ``[NB, 1]``, shape, pad)."""
    orig_shape = tuple(x.shape)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = quant_blocks(flat.reshape(-1, BLOCK))
    return q, scale, orig_shape, pad


def _dequant(q, scale, orig_shape, pad):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(orig_shape)


def _flatten_up_to(treedef, tree):
    """The subtrees of ``tree`` at the leaf positions of ``treedef``."""
    out = []
    _walk_up_to(treedef, tree, out)
    return out


# module-level, as ``tree._walk``: a nested recursion would hold ``out``
# in a reference cycle until the garbage collector runs
def _walk_up_to(node, sub, out):
    if node is None:
        return
    if node == LEAF:
        out.append(sub)
        return
    (kind, body), = node.items()
    if kind == "dict":
        for k, v in body.items():
            _walk_up_to(v, sub[k], out)
    else:
        for v, s in zip(body, sub):
            _walk_up_to(v, s, out)


def compress_gradients(grads, ef_state):
    """-> (quantized tree, new ef_state).  g_q = Q(g + e); e' = g + e - g_q."""
    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale, shape, pad = _quant(x)
        deq = _dequant(q, scale, shape, pad)
        return {"q": q, "scale": scale, "pad": pad}, x - deq

    flat_g, tdef = flatten(grads)
    flat_e = _flatten_up_to(tdef, ef_state)
    pairs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (unflatten(tdef, [p[0] for p in pairs]),
            unflatten(tdef, [p[1] for p in pairs]))


def decompress_gradients(comp, like):
    def one(c, g):
        return _dequant(c["q"], c["scale"], g.shape, c["pad"]).to(g.dtype)

    flat_g, tdef = flatten(like)
    flat_c = _flatten_up_to(tdef, comp)
    return unflatten(tdef, [one(c, g) for c, g in zip(flat_c, flat_g)])
