"""Pluggable delta codecs for registry chunks.

Port of ``repro.checkpoint.codecs``.  A codec transforms one chunk's
*wire/stored* representation; the registry records the codec per chunk in
the manifest so pulls can invert it.  The reference has three:

  * ``none``     — identity (the only choice for parentless chunks);
  * ``xor_rle``  — XOR against the parent chunk, then run-length coding of
    the zero runs (lossless);
  * ``int8``     — blockwise int8 quantization of the float delta against
    the decoded parent (lossy per pre-copy round, exact flush at cutover).

Only ``none`` is ported so far.  The spec grammar (a codec name,
``"auto"``, or a ``{tree name: codec}`` dict) validates as in the
reference, but a push that would pick ``xor_rle`` or ``int8`` for a leaf
raises ``NotImplementedError``: it never silently stores the chunk with
``none`` instead.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np

COMPRESSION_CHOICES = ("none", "xor_rle", "int8", "auto")
PORTED_CODECS = ("none",)

# Encoder backend for parent-relative codecs: "kernel" (the default) fuses
# fingerprinting and encoding into one device pass, "host" forces the
# two-pass host codecs.  Read by the codec ports.
_BACKEND_ENV = "REPRO_CODEC_BACKEND"

_FLOAT_KINDS = ("f",)  # np dtype kinds the int8 codec quantizes


def codec_backend() -> str:
    backend = os.environ.get(_BACKEND_ENV, "kernel")
    if backend not in ("kernel", "host"):
        raise ValueError(
            f"{_BACKEND_ENV}={backend!r}; choices: ('kernel', 'host')")
    return backend


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


CODECS: Dict[str, DeltaCodec] = {c.name: c for c in (NoneCodec(),)}


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"codec {name!r} is not ported yet to repro_torch "
        f"(ported: {PORTED_CODECS}); use compression='none'")


def get_codec(name: str) -> DeltaCodec:
    codec = CODECS.get(name)
    if codec is None:
        if name in COMPRESSION_CHOICES:
            raise _not_ported(name)
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
    """Pick the concrete codec for one leaf's chunks (the reference's
    rule); raises ``NotImplementedError`` when that codec is not ported.
    """
    if isinstance(spec, dict):
        spec = spec.get(tree_name, "none")
    validate_compression(spec)
    if spec == "none" or not has_parent_chunk:
        return "none"
    name = "xor_rle"  # "xor_rle" and "auto"
    if spec == "int8":
        # the lossy quantizer only applies to float leaves on non-final
        # pushes with chunk boundaries on the dtype's element grid
        dt = np.dtype(dtype)
        if (lossy_ok and dt.kind in _FLOAT_KINDS
                and chunk_bytes > 0 and chunk_bytes % dt.itemsize == 0):
            name = "int8"
    raise _not_ported(name)
