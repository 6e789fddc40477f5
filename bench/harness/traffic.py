"""The one generator of the benchmark's traffic, driven by a mix's file.

A serving mix gives the sessions a replica holds when the window opens:
their history and output lengths.  The set of sizes is drawn once from the
mix's own ``shape_seed``, so every run's seed sees the same work; the
run's seed orders the sizes over the slots and draws the tokens.  A
training mix gives the batch shape; its batches are drawn from the run's
seed, one stream a batch id, every row its own tokens.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from harness.common import mix


@dataclasses.dataclass
class Session:
    request_id: int
    prompt: List[int]       # the history folded in set-up
    max_new_tokens: int     # the output still to come, its first token included


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from ``spec``: lognormal (median, sigma) rounded and
    cut to [min, max], uniform over [min, max], or one fixed length."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(spec["min"], spec["max"] + 1, n).astype(np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def initial_sessions(traffic: dict, vocab_size: int, seed: int) -> List[Session]:
    """The sessions in the replica's slots when the window opens (the mix's
    ``initial`` block): a fixed set of prompt and output lengths from
    ``shape_seed``, ordered and filled with tokens by the run's seed."""
    ini = traffic["initial"]
    n = int(ini["sessions"])
    shape = np.random.default_rng(traffic["shape_seed"] + 1)
    prompts = _lengths(ini["prompt"], n, shape)
    outputs = _lengths(ini["output"], n, shape)
    order = np.random.default_rng(mix(seed, "sessions")).permutation(n)
    tokens = np.random.default_rng(mix(seed, "session-prompts"))
    return [Session(ID0 + i,
                    tokens.integers(0, vocab_size, int(prompts[order[i]])).tolist(),
                    int(outputs[order[i]])) for i in range(n)]


ID0 = 1_000_000


class TrainBatches:
    """``batch(batch_id)`` -> tokens and next-token labels [B, S], drawn
    from the run's seed and the batch id (the port's dataset interface)."""

    def __init__(self, traffic: dict, vocab_size: int, seed: int):
        self.batch_size = int(traffic["batch"])
        self.seq = int(traffic["seq"])
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, batch_id: int, **_):
        rng = np.random.default_rng(mix(self.seed, "batch", batch_id))
        toks = rng.integers(0, self.vocab_size, (self.batch_size, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def tokens_per_batch(self) -> int:
        return self.batch_size * self.seq
