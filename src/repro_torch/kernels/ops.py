"""Device-dispatching entry points to the port's kernels.

Models and the checkpoint registry call these only.  The tensor's device
decides, and nothing else does: a CUDA tensor launches the hand-written
kernel (or the call raises), a CPU tensor takes the kernel's plain
PyTorch version.  There is no switch that sends a CUDA tensor to a plain
version.

The model's entries (``attention``, ``decode_attention``, ``rglru_scan``,
``slstm_scan``, ``mlstm_scan``) also take DTensors.  A kernel cannot be
partitioned (nor can a Pallas custom call in XLA), so each such call
redistributes its inputs to a layout where the kernel's work is local
(batch over the rules' batch axes, heads or recurrent channels over
``model`` where every count divides; sequence, time and head dim whole),
runs the same entry on every rank's local shards, and returns DTensors
of that layout (``_on_shards``; differentiable through ``to_local`` and
``from_local``).  ``LOCAL_SHARD_CALLS`` counts these calls by entry.
"""
from __future__ import annotations

import collections

import numpy as np
from torch.distributed.tensor import DTensor

from repro_torch.kernels import codec as _ck
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fingerprint as _fp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _ml
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import slstm as _sl
from repro_torch.sharding.rules import (batch_axes, mesh_axes,
                                        on_local_shards)

LOCAL_SHARD_CALLS = collections.Counter()


def _mesh_of(*args):
    """The mesh of the first DTensor among ``args`` (tuples searched), or
    None."""
    for a in args:
        if isinstance(a, tuple):
            a = _mesh_of(*a)
            if a is not None:
                return a
        elif isinstance(a, DTensor):
            return a.device_mesh
    return None


def _layout(mesh, batch: int, counts):
    """-> (batch entry, channel entry) of a kernel's local layout: batch
    over the rules' batch axes where they divide it; heads (or recurrent
    channels) over ``model`` where every one of ``counts`` divides."""
    b = batch_axes(mesh, batch)
    used = (b,) if isinstance(b, str) else tuple(b or ())
    m = mesh_axes(mesh).get("model")
    h = ("model" if m and "model" not in used
         and all(c % m == 0 for c in counts) else None)
    return b, h


def _on_shards(name, fn, mesh, args, specs, out_specs):
    """``rules.on_local_shards``, counted in ``LOCAL_SHARD_CALLS``."""
    LOCAL_SHARD_CALLS[name] += 1
    return on_local_shards(fn, mesh, args, specs, out_specs)


def attention(q, k, v, *, causal=True, window=0):
    """Train/prefill attention.  q [B,Sq,H,D]; k/v [B,Sk,Hkv,D].

    Differentiable: on CUDA the flash kernel's ``autograd.Function``, on
    the CPU the plain version under autograd."""
    mesh = _mesh_of(q, k, v)
    if mesh is not None:
        b, h = _layout(mesh, q.shape[0], (q.shape[2], k.shape[2]))
        sp = (b, None, h, None)
        return _on_shards(
            "attention",
            lambda q, k, v: attention(q, k, v, causal=causal, window=window),
            mesh, (q, k, v), (sp, sp, sp), sp)
    if q.is_cuda:
        return _fa.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), bool(causal),
                                        int(window or 0))
    return ref.naive_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, q_pos, k_pos):
    """Single-token attention over KV cache. q [B,1,H,D]; caches
    [B,S,Hkv,D]; q_pos [B]; k_pos [B,S] (a DTensor cache is gathered along
    S: the kernel sees every slot of its rows)."""
    mesh = _mesh_of(q, k_cache, v_cache, q_pos, k_pos)
    if mesh is not None:
        b, h = _layout(mesh, q.shape[0], (q.shape[2], k_cache.shape[2]))
        sp = (b, None, h, None)
        return _on_shards("decode_attention", decode_attention, mesh,
                          (q, k_cache, v_cache, q_pos, k_pos),
                          (sp, sp, sp, (b,), (b, None)), sp)
    if q.is_cuda:
        return _da.decode_attention(q, k_cache, v_cache, q_pos, k_pos)
    return ref.decode_attention(q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos)


def rglru_scan(x, a_param, gate_a, gate_x, h0=None, *, c: float = 8.0):
    """RG-LRU over a sequence.  x/gates [B,S,W]; a_param [W]; h0 [B,W] or
    None -> (h_seq [B,S,W] in x's dtype, h_last [B,W] float32).

    Differentiable: on CUDA the RG-LRU kernel's ``autograd.Function``, on
    the CPU the plain version under autograd."""
    mesh = _mesh_of(x, a_param, gate_a, gate_x, h0)
    if mesh is not None:
        b, w = _layout(mesh, x.shape[0], (x.shape[2],))
        sp = (b, None, w)
        return _on_shards(
            "rglru_scan",
            lambda *t: rglru_scan(*t, c=c), mesh,
            (x, a_param, gate_a, gate_x, h0),
            (sp, (w,), sp, sp, (b, w)), (sp, (b, w)))
    if x.is_cuda:
        return _rg.RGLRUScan.apply(
            x.contiguous(), a_param.contiguous(), gate_a.contiguous(),
            gate_x.contiguous(), None if h0 is None else h0.contiguous(),
            float(c))
    return ref.naive_rglru(x, a_param, gate_a, gate_x, h0, c=c)


def slstm_scan(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o, state=None):
    """sLSTM over a sequence.  x_* [B,S,W]; r_* [H,hb,hb] float32; state
    (c, n, h, m) [B,W] float32 or None (fresh) -> (h_seq in x's dtype,
    new state, or None for a fresh-state call on the card).

    As in the reference, only a fresh state reaches the kernel: a CUDA
    tensor with ``state=None`` launches it through ``SLSTMScan``
    (differentiable) and returns no state, a CPU tensor runs its plain
    version.  A call that threads a state (prefill, decode and append of a
    serving cache) runs the recurrence ``ref.naive_slstm`` on every
    device: the port of the reference's own jnp path, which the reference
    takes on the TPU as well, not a plain version standing in for a
    kernel."""
    mesh = _mesh_of(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o, state)
    if mesh is not None:  # whole heads a shard: W is H blocks of hb
        b, h = _layout(mesh, x_i.shape[0], (r_i.shape[0],))
        sx, sr, ss = (b, None, h), (h, None, None), (b, h)
        st = (None,) * 4 if state is None else tuple(state)

        def local(*t):
            return slstm_scan(*t[:8], None if state is None else t[8:])

        return _on_shards("slstm_scan", local, mesh,
                          (x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o) + st,
                          (sx,) * 4 + (sr,) * 4 + (ss,) * 4,
                          (sx, (ss,) * 4))
    if state is None and x_i.is_cuda:
        h = _sl.SLSTMScan.apply(*(t.contiguous() for t in (
            x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o)))
        return h, None
    return ref.naive_slstm(x_i, x_f, x_z, x_o, r_i, r_f, r_z, r_o, state)


def mlstm_scan(q, k, v, i_gate, f_gate, state=None):
    """mLSTM over a sequence.  q/k/v [B,S,H,D]; gates [B,S,H]; state (C, n,
    m) or None (fresh) -> (h [B,S,H,D], new state or None).

    As in the reference, only a fresh state reaches the chunkwise kernel,
    in chunks of 128 halved until they divide S (the chunk sets the sum
    order): a CUDA tensor with ``state=None`` launches it through
    ``MLSTMScan`` (differentiable) and returns h in q's dtype and no
    state; a CPU tensor runs its plain version ``ref.chunkwise_mlstm``
    likewise.  A call that threads a state (prefill and append of a
    serving cache) runs the stabilized recurrence ``ref.naive_mlstm`` on
    every device, h in float32: the port of the reference's own jnp path,
    which the reference takes on the TPU as well, not a plain version
    standing in for a kernel."""
    mesh = _mesh_of(q, k, v, i_gate, f_gate, state)
    if mesh is not None:
        b, h = _layout(mesh, q.shape[0], (q.shape[2],))
        sq, sg = (b, None, h, None), (b, None, h)
        ss = ((b, h, None, None), (b, h, None), (b, h))
        st = (None,) * 3 if state is None else tuple(state)

        def local(*t):
            return mlstm_scan(*t[:5], None if state is None else t[5:])

        return _on_shards("mlstm_scan", local, mesh,
                          (q, k, v, i_gate, f_gate) + st,
                          (sq,) * 3 + (sg,) * 2 + ss, (sq, ss))
    if state is None:
        ch = 128
        while q.shape[1] % ch:
            ch //= 2
        i_gate, f_gate = i_gate.float(), f_gate.float()
        if q.is_cuda:
            h = _ml.MLSTMScan.apply(*(t.contiguous() for t in (
                q, k, v, i_gate, f_gate)), ch)
        else:
            h = ref.chunkwise_mlstm(q, k, v, i_gate, f_gate, chunk=ch)
        return h, None
    return ref.naive_mlstm(q, k, v, i_gate, f_gate, state)


def chunk_fingerprint(x, chunk_bytes: int):
    """Chunk fingerprints of an array's raw bits, on the array's device.

    Returns ``[n_chunks, 4]`` int64 holding uint32 words: one 128-bit
    fingerprint per ``chunk_bytes``-sized chunk of the flattened array
    (boundaries aligned with the checkpoint registry's raw-byte chunk
    grid).  Numpy arrays are fingerprinted on the host.
    """
    words = _fp.chunked_words(x, chunk_bytes)
    if words.is_cuda:
        lanes = _fp.fingerprint_lanes(words)
    else:
        lanes = _fp.fingerprint_lanes_ref(words)
    return _fp.collapse_lanes(lanes)


def _codec_words(cur, parent_raw: bytes, chunk_bytes: int):
    """Both sides of a fused codec pass in the kernel's word layout, on
    ``cur``'s device (the parent's bytes come from the registry on the
    host and are uploaded here)."""
    words = _fp.chunked_words(cur, chunk_bytes)
    pwords = _fp.chunked_words(np.frombuffer(parent_raw, np.uint8),
                               chunk_bytes).to(words.device)
    assert pwords.shape == words.shape, (words.shape, pwords.shape)
    return words, pwords


def fused_xor_fingerprint(cur, parent_raw: bytes, chunk_bytes: int):
    """One fused pass over ``cur``: chunk fingerprints + XOR vs parent.

    Returns ``(fps [C, 4] int64 holding uint32, xor_words [C, R, 128]
    int32 bits)`` on ``cur``'s device.  The fingerprints equal
    ``chunk_fingerprint(cur, ...)``; the XOR words feed the host RLE pass
    of the ``xor_rle`` codec."""
    words, pwords = _codec_words(cur, parent_raw, chunk_bytes)
    if words.is_cuda:
        lanes, xor = _ck.xor_fp_lanes(words, pwords)
    else:
        lanes, xor = _ck.xor_fp_ref(words, pwords)
    return _fp.collapse_lanes(lanes), xor


def fused_int8_fingerprint(cur, parent_raw: bytes, chunk_bytes: int):
    """One fused pass over a float32 ``cur``: chunk fingerprints +
    blockwise int8 quantization of the delta vs the decoded parent.

    Returns ``(fps [C, 4] int64 holding uint32, q int8 [C, NB, 256],
    scale float32 [C, NB])`` with ``NB`` quant blocks per (zero-padded)
    chunk; ``q``/``scale`` equal ``optim.compression._quant`` on each
    chunk's delta, bit for bit."""
    words, pwords = _codec_words(cur, parent_raw, chunk_bytes)
    if words.is_cuda:
        lanes, q, scale = _ck.int8_fp_lanes(words, pwords)
    else:
        lanes, q, scale = _ck.int8_fp_ref(words, pwords)
    return _fp.collapse_lanes(lanes), q, scale
