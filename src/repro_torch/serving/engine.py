"""Slot-based serving engine with continuous batching.

Port of ``repro.serving.engine``.  A fixed decode batch of ``num_slots``
sequences; requests admit into free slots (prompt tokens fold in as
forced decode steps), every engine step decodes one token for all active
slots, finished sequences free their slot.  State = (slot KV caches, slot
table) — one tree, which makes the *whole engine* an MS2M-migratable
worker: its message log is the admitted request stream, and replaying it
from a checkpoint reproduces the engine bit-exactly.

The reference's jitted ``_decode_all`` becomes ``lm_decode_step`` plus an
``argmax`` on the cache's device.  The cache is updated in place, so
``state_tree`` clones it: the source keeps decoding while its image is
built.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import to_tensor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]


def _decode_all(params, cfg, cache, tokens, positions):
    """One batched decode step -> (greedy next token per slot, cache)."""
    logits, cache = T.lm_decode_step(params, tokens, positions, cfg, cache)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache


class ServingEngine:
    """Continuous-batching engine over ``num_slots`` decode lanes.

    Weights and caches live on the params' device."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 4,
                 max_seq: int = 512, name: str = "engine"):
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.name = name
        self.device = leaves(params)[0].device
        self.cache = T.init_cache(cfg, num_slots, max_seq, device=self.device)
        self.positions = np.zeros(num_slots, np.int64)  # next position
        self.active = np.zeros(num_slots, bool)
        self.claimed = np.zeros(num_slots, bool)  # mid-prefill guard
        self.request_of_slot: Dict[int, int] = {}
        self.budget = np.zeros(num_slots, np.int64)
        self.generated: Dict[int, List[int]] = {}
        self.last_token = np.zeros(num_slots, np.int64)
        self.waiting: List[Request] = []
        self.completions: List[Completion] = []
        # MS2M bookkeeping
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1

    # ------------------------------------------------------------------ admin
    def submit(self, req: Request):
        self.waiting.append(req)
        self._admit_waiting()

    def _admit_waiting(self):
        while self.waiting and not (self.active | self.claimed).all():
            slot = int(np.flatnonzero(~(self.active | self.claimed))[0])
            req = self.waiting.pop(0)
            self._prefill_slot(slot, req)

    def _prefill_slot(self, slot: int, req: Request):
        """Fold the prompt into the slot with forced decode steps (other
        active lanes keep generating during the admission — continuous
        batching).  The last prompt step's logits yield the first sampled
        token, exactly like a plain prefill+decode."""
        toks = req.prompt or [0]
        self.claimed[slot] = True
        sampled = 0
        for t, tok in enumerate(toks):
            next_tok = self._engine_step(forced={slot: (tok, t)})
            sampled = int(next_tok[slot])
        self.claimed[slot] = False
        self.positions[slot] = len(toks)
        self.active[slot] = True
        self.request_of_slot[slot] = req.request_id
        self.generated[req.request_id] = [sampled]
        self.last_token[slot] = sampled
        self.budget[slot] = req.max_new_tokens - 1
        if self.budget[slot] <= 0:
            self._complete(slot)

    # ------------------------------------------------------------------- step
    def _engine_step(self, forced: Optional[Dict[int, tuple]] = None):
        """One batched decode step across all slots.

        ``forced`` maps slot -> (token, position): lanes being prefilled
        consume their prompt token at its position; other active lanes
        decode their last sampled token; idle lanes re-write position 0 of
        their own lane with token 0 (harmless: they are reset on admit)."""
        forced = forced or {}
        tokens = np.zeros((self.num_slots, 1), np.int32)
        positions = np.zeros((self.num_slots, 1), np.int32)
        for s in range(self.num_slots):
            if s in forced:
                tok, pos = forced[s]
                tokens[s, 0] = tok
                positions[s, 0] = pos
            elif self.active[s]:
                tokens[s, 0] = self.last_token[s]
                positions[s, 0] = self.positions[s]
        ids = torch.from_numpy(np.stack([tokens, positions])).to(self.device)
        next_tok, self.cache = _decode_all(self.params, self.cfg, self.cache,
                                           ids[0], ids[1])
        next_tok = next_tok.cpu().numpy()
        for s in range(self.num_slots):
            if s in forced:
                continue
            if not self.active[s]:
                continue
            tok = int(next_tok[s])
            rid = self.request_of_slot[s]
            self.positions[s] += 1
            self.generated[rid].append(tok)
            self.last_token[s] = tok
            self.budget[s] -= 1
            if self.budget[s] <= 0 or self.positions[s] >= self.max_seq - 1:
                self._complete(s)
        self._admit_waiting()
        return next_tok

    def _complete(self, slot: int):
        rid = self.request_of_slot.pop(slot)
        self.completions.append(Completion(rid, self.generated.pop(rid)))
        self.active[slot] = False
        self.positions[slot] = 0
        self.last_token[slot] = 0

    def step(self, n: int = 1):
        for _ in range(n):
            if self.active.any():
                self._engine_step()

    # ------------------------------------------------------- MS2M worker API
    def process(self, msg) -> None:
        """Message = one request admission + its full generation (the
        deterministic unit the MS2M log replays)."""
        p = msg.payload
        req = Request(p.get("request_id", msg.msg_id),
                      list(p.get("prompt", [p.get("token", 0)])),
                      int(p.get("max_new_tokens", 8)))
        self.submit(req)
        while req.request_id in self.generated or any(
                r.request_id == req.request_id for r in self.waiting):
            self._engine_step()
        self.last_msg_id = msg.msg_id
        self.n_processed += 1

    def state_tree(self):
        """Full checkpointable state: a copy of the KV caches, the slot
        table, *and* the admitted-request log (per-slot request id +
        generated-so-far tokens), so a mid-generation checkpoint restores
        in-flight requests instead of dropping them.  A non-empty
        admission backlog has no array form, so checkpoints are only taken
        between admissions (the serving wrapper guarantees this by
        draining ``waiting`` before yielding control)."""
        if self.waiting:
            raise RuntimeError(
                f"{self.name}: state_tree() with {len(self.waiting)} "
                "request(s) still waiting for admission — drain the "
                "waiting queue before checkpointing")
        request = np.full(self.num_slots, -1, np.int64)
        gen_len = np.zeros(self.num_slots, np.int64)
        gen = np.zeros((self.num_slots, self.max_seq), np.int32)
        for s, rid in self.request_of_slot.items():
            toks = self.generated[rid]
            request[s] = rid
            gen_len[s] = len(toks)
            gen[s, : len(toks)] = toks
        return {
            "cache": tree_map(torch.clone, self.cache),
            "slots": {
                "positions": self.positions.copy(),
                "active": self.active.copy(),
                "budget": self.budget.copy(),
                "last_token": self.last_token.copy(),
                "request": request,
                "gen_len": gen_len,
                "gen": gen,
            },
            "scalars": {
                "last_msg_id": np.int64(self.last_msg_id),
                "n_processed": np.int64(self.n_processed),
            },
        }

    def load_state(self, tree):
        """Restore from a state tree (numpy leaves from a registry pull, or
        tensors); the cache is copied onto the engine's device."""
        self.cache = tree_map(lambda a: to_tensor(a, self.device),
                              tree["cache"])
        slots = tree["slots"]
        self.positions = np.asarray(slots["positions"]).copy()
        self.active = np.asarray(slots["active"]).copy()
        self.budget = np.asarray(slots["budget"]).copy()
        self.last_token = np.asarray(slots["last_token"]).copy()
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])
        self.request_of_slot = {}
        self.generated = {}
        self.waiting = []
        if "request" in slots:  # admitted-request log (older trees lack it)
            request = np.asarray(slots["request"])
            gen_len = np.asarray(slots["gen_len"])
            gen = np.asarray(slots["gen"])
            for s in np.flatnonzero(request >= 0):
                rid = int(request[s])
                self.request_of_slot[int(s)] = rid
                self.generated[rid] = [int(t)
                                       for t in gen[s, : int(gen_len[s])]]

    def state_equal(self, other, exact: bool = True) -> bool:
        if self.last_msg_id != other.last_msg_id:
            return False
        for a, b in zip(leaves(self.cache), leaves(other.cache)):
            b = b.to(a.device)
            ok = (torch.equal(a, b) if exact
                  else torch.allclose(a, b, rtol=1e-5, atol=1e-5))
            if not ok:
                return False
        return bool(
            np.array_equal(self.positions, other.positions)
            and np.array_equal(self.active, other.active)
            and self.request_of_slot == other.request_of_slot)

    def slot_table(self) -> List[Dict[str, int]]:
        """Human-readable view of the in-flight slots (handoff telemetry)."""
        return [{"slot": s, "request_id": rid,
                 "position": int(self.positions[s]),
                 "generated": len(self.generated[rid]),
                 "budget": int(self.budget[s])}
                for s, rid in sorted(self.request_of_slot.items())]
