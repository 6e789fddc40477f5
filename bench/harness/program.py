"""The system under test: the port's configuration, workers and registry,
built from a configuration file's sizes and the benchmark's own weights.

The only module of the harness that imports ``repro_torch``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import tempfile

import torch

from repro_torch.checkpoint.registry import Registry
from repro_torch.configs import get_config
from repro_torch.core.cutoff import CutoffController
from repro_torch.core.trainer_worker import TrainerWorker
from repro_torch.data import DataConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.handoff import CompletionLedger, ServingWorker
from repro_torch.train import step as steplib

from store import MemoryChunkStore

__all__ = ["CompletionLedger", "CutoffController", "ServingEngine",
           "ServingWorker", "model_config", "registry", "trainer"]


def model_config(config: dict):
    """The port's ModelConfig of ``config["port_arch"]`` with every key of
    the file's ``run`` block, each the name of one of its fields (a key
    that names none raises): what the file says is what runs."""
    run = config["run"]
    base = get_config(config["port_arch"])
    unknown = sorted(set(run) - {f.name for f in dataclasses.fields(base)})
    if unknown:
        raise ValueError(f"{config['name']}: run keys {unknown} name no field "
                         f"of the port's ModelConfig")
    cfg = dataclasses.replace(base, **{k: _as_field(getattr(base, k), v)
                                       for k, v in run.items()})
    if cfg.padded_vocab != -(-run["vocab_size"] // 2048) * 2048:
        raise ValueError(f"{cfg.name}: the port pads the vocabulary to "
                         f"{cfg.padded_vocab} rows")
    return cfg


def _as_field(default, value):
    """A JSON value in the type of the field's ``default``: a list as a
    tuple (``pattern``, ``mrope_sections``), a name as the field's enum (a
    block kind)."""
    if isinstance(value, list):
        inner = default[0] if isinstance(default, tuple) and default else None
        return tuple(_as_field(inner, v) for v in value)
    if isinstance(default, enum.Enum):
        return type(default)(value)
    return value


def registry(chunk_bytes=None) -> Registry:
    """A registry whose chunks stay in host memory (its manifests, a few
    KB, go to a temporary directory under ``TMPDIR``)."""
    reg = Registry(tempfile.mkdtemp(prefix="bench-registry-"), chunk_bytes)
    reg.store = MemoryChunkStore(reg.root)
    return reg


def close_registry(reg: Registry) -> None:
    import shutil

    reg.store.close()
    shutil.rmtree(reg.root, ignore_errors=True)


@contextlib.contextmanager
def _weights(params):
    """``init_lm`` hands out the benchmark's weights (``params``) while a
    worker is built, instead of drawing its own on the host."""
    draw = transformer.init_lm
    transformer.init_lm = lambda cfg, seed=0, device="cuda": params
    try:
        yield
    finally:
        transformer.init_lm = draw


def trainer(cfg, traffic: dict, params, batches, name: str, device):
    """A ``TrainerWorker`` at the mix's settings over ``params`` (trained
    in place) and the benchmark's batches."""
    opt = traffic["optimizer"]
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=opt["lr_peak"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"],
        opt=adamw.AdamWConfig(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                              weight_decay=opt["weight_decay"],
                              clip_norm=opt["clip_norm"]))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=traffic["seq"],
                      global_batch=traffic["batch"])
    with _weights(params):
        worker = TrainerWorker(cfg, tcfg, dcfg, name=name, device=device)
    worker.ds = batches
    return worker


def prefill_sessions(engine, cfg, params, prompts, rows: int):
    """The engine's slots filled with sessions mid-generation: each prompt
    folded by the port's ``lm_prefill`` (``rows`` prompts a call, padded
    to the longest of the call; a padded slot sits past its row's position
    and the decode kernel's mask never reads it), its first token the
    prefill's greedy pick.  -> the first tokens, one a slot."""
    from repro_torch.tree import leaves

    dev = engine.device
    first = []
    for r0 in range(0, len(prompts), rows):
        chunk = prompts[r0:r0 + rows]
        n = max(len(p) for p in chunk)
        toks = torch.zeros((len(chunk), n), dtype=torch.int32)
        for i, p in enumerate(chunk):
            toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        sub = transformer.init_cache(cfg, len(chunk), engine.max_seq, device=dev)
        logits, sub = transformer.lm_prefill(params, {"tokens": toks.to(dev)},
                                             cfg, sub)
        for i, p in enumerate(chunk):
            first.append(int(torch.argmax(logits[i, len(p) - 1])))
        del logits
        for big, small in zip(leaves(engine.cache), leaves(sub)):
            big[:, r0:r0 + len(chunk)].copy_(small)
    return first


def empty_like_tree(tree):
    if isinstance(tree, dict):
        return {k: empty_like_tree(v) for k, v in tree.items()}
    return torch.empty_like(tree)
