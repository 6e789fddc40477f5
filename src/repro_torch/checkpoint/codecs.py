"""Pluggable delta codecs for registry chunks.

Port of ``repro.checkpoint.codecs``; every blob is byte-identical to the
reference's.  A codec transforms one chunk's *wire/stored*
representation; the registry records the codec per chunk in the manifest
so pulls can invert it.  Two families:

  * ``none``     — identity (the only choice for parentless chunks).
  * ``xor_rle``  — XOR against the parent image's chunk at the same
    position, then byte-level run-length coding of the zero runs.
    Lossless.  Near-static chunks collapse to a few bytes; a chunk with a
    small dirty stripe costs the stripe, not the chunk.
  * ``int8``     — blockwise int8 quantization of the float delta
    ``chunk - decode(parent chunk)`` (``optim/compression.py``).  LOSSY
    per round: the next round's delta is computed against the receiver's
    lossy reconstruction (the decoded parent chain), so the error is
    carried forward, not dropped; the pre-copy engine finishes a lossy
    lineage with one lossless "exact flush" push, so the image restored
    at cutover — and the replayed state — stays bit-exact.

Codec choice is per leaf: ``resolve_compression`` maps the
``MigrationPolicy.compression`` knob (a codec name, ``"auto"``, or a
``{tree name: codec}`` dict) to a concrete codec given the leaf's dtype,
whether a compatible parent chunk exists, and whether a lossy encoding is
acceptable for this push.  ``FusedLeafEncoding`` computes the same blobs
from one fused device pass (``kernels/codec.py``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

COMPRESSION_CHOICES = ("none", "xor_rle", "int8", "auto")

# Encoder backend for parent-relative codecs.  "kernel" (the default)
# lets the registry fuse fingerprinting and encoding into one pass on the
# leaf's device (kernels/codec.py) when the leaf and chunk grid qualify;
# "host" forces the two-pass host codecs below.  Both give the same bytes.
_BACKEND_ENV = "REPRO_CODEC_BACKEND"

_RAW_FLAG = b"\x00"   # xor_rle fallback: raw literal chunk follows
_RLE_FLAG = b"\x01"   # xor_rle: run-length stream follows

_FLOAT_KINDS = ("f",)  # np dtype kinds the int8 codec quantizes


def codec_backend() -> str:
    backend = os.environ.get(_BACKEND_ENV, "kernel")
    if backend not in ("kernel", "host"):
        raise ValueError(
            f"{_BACKEND_ENV}={backend!r}; choices: ('kernel', 'host')")
    return backend


def leaf_view(leaf) -> memoryview:
    """The C-order raw bytes of a leaf as a byte view: no copy of a
    contiguous host tensor (the view aliases it: it must not change
    until the caller is done with the view), one copy from a device
    (tensors leave their device here)."""
    if isinstance(leaf, torch.Tensor):
        # a byte view: bfloat16 has no numpy dtype, and .numpy() of it fails
        flat = leaf.detach().contiguous().reshape(-1)
        return memoryview(flat.view(torch.uint8).cpu().numpy())
    return memoryview(np.asarray(leaf).tobytes())


def leaf_raw(leaf) -> bytes:
    """C-order raw bytes of a leaf (tensors leave their device here)."""
    return leaf_view(leaf).tobytes()


def _rle_encode(x: np.ndarray) -> bytes:
    """Byte-level RLE of a mostly-zero uint8 vector.

    Stream of ``(u32 zero_run, u32 lit_len, lit bytes)`` tokens; built
    from the nonzero index set with numpy, so near-static chunks encode in
    O(dirty) not O(chunk).
    """
    nz = np.flatnonzero(x)
    out = []
    if nz.size == 0:
        return b""
    # group nonzero indices into literal segments, absorbing zero gaps
    # shorter than the 8-byte token header (splitting there costs more)
    breaks = np.flatnonzero(np.diff(nz) > 16) + 1
    starts = np.concatenate(([0], breaks))
    ends = np.concatenate((breaks, [nz.size]))
    pos = 0
    for s, e in zip(starts, ends):
        lo, hi = int(nz[s]), int(nz[e - 1]) + 1
        out.append(int(lo - pos).to_bytes(4, "little"))
        out.append(int(hi - lo).to_bytes(4, "little"))
        out.append(x[lo:hi].tobytes())
        pos = hi
    return b"".join(out)


def _rle_decode(blob: bytes, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint8)
    pos = off = 0
    view = memoryview(blob)
    while off < len(view):
        zrun = int.from_bytes(view[off: off + 4], "little")
        lit = int.from_bytes(view[off + 4: off + 8], "little")
        off += 8
        pos += zrun
        out[pos: pos + lit] = np.frombuffer(view[off: off + lit], np.uint8)
        pos += lit
        off += lit
    return out


def _to_f32(raw: bytes, dtype: np.dtype) -> np.ndarray:
    """A chunk's elements as float32 (bfloat16 widens through torch, so
    no ``ml_dtypes`` is needed)."""
    if np.dtype(dtype).name == "bfloat16":
        bits = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return bits.view(torch.bfloat16).float().numpy()
    return np.frombuffer(raw, dtype).astype(np.float32)


def _from_f32(x: np.ndarray, dtype: np.dtype) -> bytes:
    """Inverse of :func:`_to_f32`: float32 values rounded to ``dtype``."""
    if np.dtype(dtype).name == "bfloat16":
        bf = torch.from_numpy(x).to(torch.bfloat16)
        return bf.view(torch.int16).numpy().tobytes()
    return x.astype(dtype).tobytes()


def _int8_blob(q: np.ndarray, scale: np.ndarray, pad: int) -> bytes:
    header = (int(pad).to_bytes(4, "little")
              + int(q.size).to_bytes(4, "little"))
    return header + q.tobytes() + scale.tobytes()


class DeltaCodec:
    name: str = "?"
    lossless: bool = True

    def encode(self, raw: bytes, parent_raw: Optional[bytes],
               dtype: np.dtype) -> bytes:
        raise NotImplementedError

    def decode(self, blob: bytes, parent_raw: Optional[bytes],
               dtype: np.dtype) -> bytes:
        raise NotImplementedError


class NoneCodec(DeltaCodec):
    name = "none"

    def encode(self, raw, parent_raw, dtype):
        return raw

    def decode(self, blob, parent_raw, dtype):
        return blob


class XorRleCodec(DeltaCodec):
    name = "xor_rle"

    def encode(self, raw, parent_raw, dtype):
        assert parent_raw is not None and len(parent_raw) == len(raw)
        x = np.frombuffer(raw, np.uint8) ^ np.frombuffer(parent_raw, np.uint8)
        rle = _rle_encode(x)
        if len(rle) + 1 >= len(raw):  # incompressible: never exceed raw+1
            return _RAW_FLAG + raw
        return _RLE_FLAG + rle

    def decode(self, blob, parent_raw, dtype):
        if blob[:1] == _RAW_FLAG:
            return blob[1:]
        assert parent_raw is not None
        x = _rle_decode(blob[1:], len(parent_raw))
        return (x ^ np.frombuffer(parent_raw, np.uint8)).tobytes()


class Int8DeltaCodec(DeltaCodec):
    """Blockwise-int8 quantized float delta vs the decoded parent chunk
    (see module docstring for the error-feedback/exact-flush contract)."""

    name = "int8"
    lossless = False

    def encode(self, raw, parent_raw, dtype):
        from repro_torch.optim.compression import _quant

        assert parent_raw is not None and len(parent_raw) == len(raw)
        delta = _to_f32(raw, dtype) - _to_f32(parent_raw, dtype)
        q, scale, _, pad = _quant(torch.from_numpy(delta))
        return _int8_blob(q.numpy(), scale.numpy(), pad)

    def decode(self, blob, parent_raw, dtype):
        from repro_torch.optim.compression import BLOCK, _dequant

        assert parent_raw is not None
        pad = int.from_bytes(blob[:4], "little")
        nq = int.from_bytes(blob[4:8], "little")
        q = np.frombuffer(blob[8: 8 + nq], np.int8).reshape(-1, BLOCK)
        scale = np.frombuffer(blob[8 + nq:], np.float32).reshape(-1, 1)
        par = _to_f32(parent_raw, dtype)
        delta = _dequant(torch.from_numpy(q.copy()),
                         torch.from_numpy(scale.copy()), (par.size,), pad)
        return _from_f32(par + delta.numpy(), dtype)


CODECS: Dict[str, DeltaCodec] = {
    c.name: c for c in (NoneCodec(), XorRleCodec(), Int8DeltaCodec())
}


def get_codec(name: str) -> DeltaCodec:
    codec = CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown codec {name!r}; concrete codecs: {tuple(CODECS)} "
            "(specs like 'auto' must go through resolve_compression first)")
    return codec


def validate_compression(spec: Union[str, Dict[str, str]]) -> None:
    specs = spec.values() if isinstance(spec, dict) else (spec,)
    for s in specs:
        if s not in COMPRESSION_CHOICES:
            raise ValueError(
                f"unknown compression codec {s!r}; "
                f"choices: {COMPRESSION_CHOICES}")


def resolve_compression(spec: Union[str, Dict[str, str]], tree_name: str,
                        dtype: np.dtype, has_parent_chunk: bool,
                        lossy_ok: bool, chunk_bytes: int = 0) -> str:
    """Pick the concrete codec for one leaf's chunks.

    Note the cluster migration path pushes a single tree named
    ``"state"``; dict specs keyed by other tree names only take effect
    for direct multi-tree ``Registry`` pushes.
    """
    if isinstance(spec, dict):
        spec = spec.get(tree_name, "none")
    # re-check the *resolved* entry: a dict naming an unknown codec for
    # this very tree must fail here with ValueError, not later at push time
    validate_compression(spec)
    if spec == "none" or not has_parent_chunk:
        return "none"
    if spec == "int8":
        # the lossy quantizer only applies to float leaves on non-final
        # pushes, and needs chunk boundaries on the dtype's element grid
        # (an unaligned chunk_bytes would split an element across chunks);
        # everything else falls back to the lossless delta codec
        dt = np.dtype(dtype)
        if (lossy_ok and dt.kind in _FLOAT_KINDS
                and chunk_bytes > 0 and chunk_bytes % dt.itemsize == 0):
            return "int8"
        return "xor_rle"
    return "xor_rle"  # "xor_rle" and "auto"


class FusedLeafEncoding:
    """One fused pass over a leaf on its own device: chunk fingerprints +
    the codec arithmetic for *every* chunk (the CUDA kernels of
    ``kernels/codec.py`` for a CUDA tensor, their plain versions on the
    host), through ``kernels/ops.py``.

    The registry uses this in place of the fingerprint-then-host-encode
    two-pass flow when the leaf qualifies (``Registry._fused_leaf``).
    ``fps`` is bit-identical to ``leaf_fingerprints``; ``blob(c)`` is
    byte-identical to the matching host codec's ``encode`` for chunk
    ``c``.  The variable-length RLE pass and blob assembly stay on the
    host: they are O(dirty bytes) and data-dependent.  ``raw_seg``
    serializes the leaf lazily — only incompressible chunks (raw
    fallback) ever pay for it.
    """

    def __init__(self, leaf, parent_buf: bytes, codec_name: str,
                 dtype: np.dtype, chunk_bytes: int):
        from repro_torch.kernels import ops

        assert codec_name in ("xor_rle", "int8"), codec_name
        self.codec_name = codec_name
        self._leaf = leaf
        self._dtype = np.dtype(dtype)
        self._cb = chunk_bytes
        self._nbytes = len(parent_buf)
        self._raw: Optional[bytes] = None
        self._xor = self._q = self._scale = None
        if codec_name == "xor_rle":
            fps, xor = ops.fused_xor_fingerprint(leaf, parent_buf,
                                                 chunk_bytes)
            self._xor = xor.cpu().numpy()          # [C, R, 128] int32 bits
        else:
            fps, q, scale = ops.fused_int8_fingerprint(leaf, parent_buf,
                                                       chunk_bytes)
            self._q = q.cpu().numpy()              # [C, NB, 256] int8
            self._scale = scale.cpu().numpy()      # [C, NB] f32
        self.fps = fps.cpu().numpy().astype(np.uint32)  # [C, 4]

    def _seg_len(self, c: int) -> int:
        return min(self._cb, self._nbytes - c * self._cb)

    def raw_seg(self, c: int) -> bytes:
        """Raw bytes of chunk ``c`` (lazy leaf serialization, memoized)."""
        if self._raw is None:
            self._raw = leaf_raw(self._leaf)
        return self._raw[c * self._cb: c * self._cb + self._cb]

    def blob(self, c: int) -> bytes:
        """The encoded blob for chunk ``c`` — byte-identical to
        ``get_codec(self.codec_name).encode(seg, parent_seg, dtype)``."""
        seg_len = self._seg_len(c)
        if self.codec_name == "xor_rle":
            # the word layout zero-pads the tail chunk; the pad XORs to
            # zero (both sides padded), so trimming to seg_len restores
            # exactly the host codec's XOR vector
            x = self._xor[c].reshape(-1).view(np.uint8)[:seg_len]
            rle = _rle_encode(x)
            if len(rle) + 1 >= seg_len:
                return _RAW_FLAG + self.raw_seg(c)
            return _RLE_FLAG + rle
        from repro_torch.optim.compression import BLOCK

        n_elems = seg_len // self._dtype.itemsize
        nblk = -(-n_elems // BLOCK)
        pad = nblk * BLOCK - n_elems
        return _int8_blob(self._q[c, :nblk],
                          self._scale[c, :nblk].reshape(-1, 1), pad)
