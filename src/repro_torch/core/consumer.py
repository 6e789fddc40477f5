"""The stateful consumer microservice — PyTorch port of
``repro.core.consumer``.

State = the fold of the message log over the model's decode step:
    state_{i+1} = decode(params, token_i, state_i)
The decode step is deterministic on the card (fixed-order kernels,
``torch.use_deterministic_algorithms``), so replaying the same messages
from the same checkpoint is **bit-exact** — MS2M's core premise.

The cache is updated in place, so ``state_tree`` returns a copy: the
source keeps serving while its checkpoint image is being built.

Replay paths:
  * ``replay_sequential`` — one decode per message (paper-faithful).
  * ``replay_scan``       — the same fold as one loop over the log without
    per-message bookkeeping (the reference compiles it as one
    ``lax.scan``); bit-exact with sequential replay.
  * ``replay_chunked``    — chunk-parallel ``lm_append`` (allclose, not
    bit-exact).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import to_tensor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves, tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StatefulConsumer:
    """Holds (cache, pos, last_msg_id); processes messages one-by-one.

    The cache lives on ``device`` (default: the params' device)."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 4096,
                 name: str = "consumer", device=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.name = name
        self.device = (resolve_device(device) if device is not None
                       else leaves(params)[0].device)
        self.cache = T.init_cache(cfg, 1, max_seq, device=self.device)
        self.pos = 0
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1  # replay filter: ids <= this are in the image

    def _fold(self, tokens: List[int]) -> None:
        """Decode ``tokens`` one by one into the cache from ``self.pos``."""
        positions = [(self.pos + i) % self.max_seq for i in range(len(tokens))]
        ids, pos = torch.tensor([tokens, positions],
                                dtype=torch.int32).to(self.device)  # one copy
        for i in range(len(tokens)):
            T.lm_decode_step(self.params, ids[i].view(1, 1),
                             pos[i].view(1, 1), self.cfg, self.cache)

    # -- message processing --------------------------------------------------
    def process(self, msg) -> None:
        self._fold([msg.payload["token"]])
        self.pos += 1
        self.last_msg_id = msg.msg_id
        self.n_processed += 1

    # -- state snapshot / restore (the "container image" contents) -----------
    def state_tree(self) -> Dict[str, Any]:
        return {
            "cache": tree_map(torch.clone, self.cache),
            "scalars": {
                "pos": np.int64(self.pos),
                "last_msg_id": np.int64(self.last_msg_id),
                "n_processed": np.int64(self.n_processed),
            },
        }

    def load_state(self, tree: Dict[str, Any]):
        """Restore from a state tree (numpy leaves from a registry pull, or
        tensors); the cache is copied onto this consumer's device."""
        self.cache = tree_map(lambda a: to_tensor(a, self.device),
                              tree["cache"])
        self.pos = int(tree["scalars"]["pos"])
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])

    # -- replay ---------------------------------------------------------------
    def replay_sequential(self, messages: List) -> int:
        for m in messages:
            self.process(m)
        return len(messages)

    def replay_scan(self, messages: List) -> int:
        if not messages:
            return 0
        self._fold([m.payload["token"] for m in messages])
        self.pos += len(messages)
        self.last_msg_id = messages[-1].msg_id
        self.n_processed += len(messages)
        return len(messages)

    def replay_chunked(self, messages: List, chunk: int = 64) -> int:
        """Chunk-parallel replay (lm_append): the beyond-paper fast path.

        Equivalent fold up to reduction order (allclose, not bit-exact)."""
        done = 0
        while len(messages) - done >= chunk:
            batch = messages[done: done + chunk]
            tokens = torch.tensor([[m.payload["token"] for m in batch]],
                                  dtype=torch.int32).to(self.device)
            positions = ((self.pos + torch.arange(chunk, dtype=torch.int32))
                         % self.max_seq)[None].to(self.device)
            T.lm_append(self.params, tokens, positions, self.cfg, self.cache)
            self.pos += chunk
            self.last_msg_id = batch[-1].msg_id
            self.n_processed += chunk
            done += chunk
        self.replay_sequential(messages[done:])
        return len(messages)

    # -- equality (migration correctness oracle) ------------------------------
    def state_equal(self, other: "StatefulConsumer", exact: bool = True) -> bool:
        if self.pos != other.pos or self.last_msg_id != other.last_msg_id:
            return False
        for x, y in zip(leaves(self.cache), leaves(other.cache)):
            y = y.to(x.device)
            if exact:
                if not torch.equal(x, y):
                    return False
            elif not torch.allclose(x, y, rtol=1e-5, atol=1e-5):
                return False
        return True


def measure_replay_speedup(cfg: ModelConfig, params, n: int = 64,
                           max_seq: int = 256) -> float:
    """Measured wall-time speedup of chunked replay vs per-message decode —
    the ``batch_speedup`` factor for the extended cutoff threshold."""
    import repro_torch.broker.broker as B

    msgs = [B.Message(i, {"token": i % cfg.vocab_size}, 0.0) for i in range(n)]
    chunk = min(64, n)
    c1 = StatefulConsumer(cfg, params, max_seq)
    c2 = StatefulConsumer(cfg, params, max_seq)
    dev = c1.device
    # warm both paths
    c1.replay_sequential(msgs[:2])
    c2.replay_chunked(msgs[:chunk], chunk=chunk)
    _sync(dev)

    t0 = time.perf_counter()
    c1.replay_sequential(msgs)
    _sync(dev)
    t_seq = time.perf_counter() - t0

    c2 = StatefulConsumer(cfg, params, max_seq)
    c2.replay_chunked(msgs[:chunk], chunk=chunk)  # rebuild state; warm
    _sync(dev)
    t0 = time.perf_counter()
    c2.replay_chunked(msgs, chunk=chunk)
    _sync(dev)
    t_chunked = time.perf_counter() - t0
    return max(1.0, t_seq / max(t_chunked, 1e-9))
