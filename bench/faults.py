"""Faults planted in the timed path, to show that the comparison which
decides ``correct`` fails them: the tests plant each on the CPU at small
sizes, ``control.py --fault`` on the card at a cell's own size.

Each fault is a context manager that patches one function of the program
(or of the harness's replay) and restores it on exit.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict


@contextlib.contextmanager
def _patched(obj, name: str, make: Callable):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def served_token_altered():
    """Every seventh decode step, each lane's greedy token plus one."""
    from repro_torch.serving import engine

    def make(decode):
        calls = {"n": 0}

        def altered(params, cfg, cache, tokens, positions):
            tok, cache = decode(params, cfg, cache, tokens, positions)
            calls["n"] += 1
            if calls["n"] % 7 == 0:
                tok = (tok + 1) % cfg.vocab_size
            return tok, cache
        return altered
    return _patched(engine, "_decode_all", make)


def decode_cache_unchanged():
    """A decode step that writes nothing into its cache."""
    from repro_torch.models import attention

    def make(write):
        def skip(leaf, b_idx, slots, value):
            if slots.dim() != 1:      # a decode step writes one slot a row
                write(leaf, b_idx, slots, value)
        return skip
    return _patched(attention, "_write_slots", make)


def replay_skipped():
    """A restored target that takes over without replaying the log."""
    from harness import serving

    def make(_replay):
        def skip(self, target, upto):
            target.applied = upto
        return skip
    return _patched(serving.ServeCell, "_replay", make)


def train_state_unchanged():
    """A train step whose optimizer returns params and moments unchanged."""
    from repro_torch.optim import adamw

    def make(_update):
        def frozen(params, grads, state, cfg, lr=None):
            return params, state, {"grad_norm": adamw.global_norm(grads)}
        return frozen
    return _patched(adamw, "adamw_update", make)


def half_batch():
    """A train step over the first half of the batch's rows, the mean
    taken over them."""
    from repro_torch.models import transformer

    def make(loss):
        def half(params, batch, cfg, **kw):
            n = batch["tokens"].shape[0] // 2
            return loss(params, {k: v[:n] for k, v in batch.items()}, cfg, **kw)
        return half
    return _patched(transformer, "lm_loss", make)


FAULTS: Dict[str, Callable] = {f.__name__: f for f in (
    served_token_altered, decode_cache_unchanged, replay_skipped,
    train_state_unchanged, half_batch)}
