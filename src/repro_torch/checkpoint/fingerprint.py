"""Checkpoint-side adapter for device-side chunk fingerprinting.

Port of ``repro.checkpoint.fingerprint``.  The registry asks for one
fingerprint per raw-byte chunk of a leaf; the bit reinterpretation and
the weighted-reduction pass happen in ``repro_torch.kernels`` on the
leaf's own device (the CUDA kernel for a CUDA tensor), so a device-
resident leaf is fingerprinted without serializing it to host memory.
The adapter only normalizes leaves and returns host numpy for the
manifest.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.fingerprint import FP_WORDS, LANES


def supports_chunk_bytes(chunk_bytes: int) -> bool:
    """The kernel's lane layout needs chunks on a 512-byte word grid."""
    return chunk_bytes >= 4 * LANES and chunk_bytes % (4 * LANES) == 0


def normalize_leaf(leaf):
    """The array the kernels would consume for this leaf (a tensor stays
    on its device), or None when it can't be fingerprinted (python
    objects, complex dtypes, odd itemsizes — the registry then skips
    fingerprints for it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    leaf = np.asarray(leaf)
    if (leaf.dtype == object or leaf.dtype.kind == "c"
            or leaf.dtype.itemsize not in (1, 2, 4, 8)):
        return None
    return leaf


def leaf_fingerprints(leaf, chunk_bytes: int) -> Optional[np.ndarray]:
    """-> ``[n_chunks, FP_WORDS]`` uint32 fingerprints of the leaf's raw
    bytes on the registry's chunk grid, or None when the grid is
    unsupported."""
    from repro_torch.kernels import ops

    if not supports_chunk_bytes(chunk_bytes):
        return None
    leaf = normalize_leaf(leaf)
    if leaf is None:
        return None
    size = leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size
    if size == 0:
        return np.zeros((0, FP_WORDS), np.uint32)
    fps = ops.chunk_fingerprint(leaf, chunk_bytes)
    return fps.cpu().numpy().astype(np.uint32)
