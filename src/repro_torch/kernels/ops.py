"""Device-dispatching entry points to the port's kernels.

Models and the checkpoint registry call these only.  The tensor's device
decides, and nothing else does: a CUDA tensor launches the hand-written
kernel (or the call raises), a CPU tensor takes the kernel's plain
PyTorch version.  There is no switch that sends a CUDA tensor to a plain
version.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fingerprint as _fp
from repro_torch.kernels import ref


def decode_attention(q, k_cache, v_cache, q_pos, k_pos):
    """Single-token attention over KV cache. q [B,1,H,D]."""
    if q.is_cuda:
        return _da.decode_attention(q, k_cache, v_cache, q_pos, k_pos)
    return ref.decode_attention(q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos)


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
