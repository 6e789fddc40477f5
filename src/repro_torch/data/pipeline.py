"""Deterministic synthetic token pipeline.

Port of ``repro.data.pipeline``; numpy only, so every batch is bit-identical
to the reference's for the same ``(seed, step, host_id)``.

Every batch is a pure function of (seed, step) — the property that makes a
training worker's optimizer state reconstructible by *replaying the batch-id
log* (MS2M applied to training: the message is the batch id, not the bytes).
Host-sharded: each data-parallel host materializes only its slice.
A background thread prefetches batches ahead of the step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain synthetic text (has learnable structure, so loss curves
    # are meaningful in the examples)
    order: int = 1
    branching: int = 32


class SyntheticTokenDataset:
    """Deterministic batches: batch(step) is reproducible forever."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random transition table: vocab -> `branching` successors
        self._succ = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching), dtype=np.int32
        )

    def batch(self, step: int, *, host_id: int = 0, num_hosts: int = 1):
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id])
        )
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=local)
        choices = rng.integers(0, cfg.branching, size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }


def make_train_iterator(cfg: DataConfig, *, start_step: int = 0,
                        prefetch: int = 2, host_id: int = 0,
                        num_hosts: int = 1) -> Iterator[dict]:
    """Background-threaded prefetching iterator over (step, batch)."""
    ds = SyntheticTokenDataset(cfg)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, ds.batch(step, host_id=host_id,
                                      num_hosts=num_hosts)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
