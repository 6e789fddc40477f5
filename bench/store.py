"""The registry's chunk store in host memory, and percentile arithmetic.

Copied so that later changes to the program cannot move the yardstick:
``MemoryChunkStore`` from ``chip_smoke.py`` (the chip machine takes only
a few tens of GiB of disk writes, and one trainer image is 16 GB), and
``percentile`` from ``repro_torch/analysis/stats.py``.
"""
from __future__ import annotations

import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

STORE_THREADS = 4    # copies of chunks into fresh host memory at once
STORE_IN_FLIGHT = 64  # chunks a push may have queued for copying


class MemoryChunkStore:
    """The registry's ``ChunkStore`` interface (``has``, ``put``, ``get``)
    over host memory.  A chunk's copy into fresh memory runs on
    ``STORE_THREADS`` threads (numpy's copy lets go of the GIL), at most
    ``STORE_IN_FLIGHT`` at a time; ``wait`` returns when every copy has
    landed.  ``close`` stops the threads."""

    def __init__(self, root: str = ""):
        self.root = root
        self._lock = threading.Lock()
        self._blobs: Dict[str, object] = {}
        self._room = threading.BoundedSemaphore(STORE_IN_FLIGHT)
        self._pool = ThreadPoolExecutor(STORE_THREADS,
                                        thread_name_prefix="bench-store")

    def has(self, key: str) -> bool:
        return key in self._blobs

    def _copy(self, data) -> np.ndarray:
        try:
            return np.frombuffer(data, np.uint8).copy()
        finally:
            self._room.release()

    def put(self, data, key: Optional[str] = None) -> Tuple[str, bool]:
        key = key or hashlib.sha256(data).hexdigest()
        with self._lock:
            new = key not in self._blobs
            if new:
                self._room.acquire()
                self._blobs[key] = self._pool.submit(self._copy, data)
        return key, new

    def wait(self) -> None:
        for blob in list(self._blobs.values()):
            blob.result()

    def get(self, key: str) -> memoryview:
        """The chunk's bytes, without a copy (a read-only view)."""
        view = memoryview(self._blobs[key].result())
        return view.toreadonly()

    def close(self) -> None:
        self.wait()
        self._blobs.clear()
        self._pool.shutdown(wait=True)


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (rank ``p/100 * (n-1)`` of the sorted
    values, interpolated between its two neighbours: numpy's default)."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile out of range: {p}")
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac
