"""Quickstart, through the PyTorch/CUDA port: train a small model, serve
it, then live-migrate the serving replica with MS2M — the paper's
pipeline end-to-end in one script (``examples/quickstart.py``'s steps,
configs and printed lines).

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain

Weights come from ``init_lm``'s draw from seed 0 (the train part's smoke
smollm_360m, and the paper consumer that ``make_torch_worker_factory``
draws); without a CUDA card ``--device cuda`` (the default) raises.
"""
import argparse
import tempfile

import torch

from repro_torch import configs, resolve_device
from repro_torch.convert import to_tensor
from repro_torch.core import (
    make_torch_worker_factory,
    run_migration_experiment,
)
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import step as steplib

TRAIN_STEPS = 30


def train(cfg, device):
    """A tiny LM trained for ``TRAIN_STEPS`` AdamW steps -> (params,
    dataset)."""
    tcfg = steplib.TrainStepConfig(remat="none", lr_peak=3e-3,
                                   warmup_steps=5, total_steps=TRAIN_STEPS)
    params = T.init_lm(cfg, seed=0, device=device)
    opt = adamw.adamw_init(params, tcfg.opt)
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, 64, 8))
    step_fn = steplib.build_train_step(cfg, tcfg)
    for s in range(TRAIN_STEPS):
        batch = {k: to_tensor(a, device) for k, a in ds.batch(s).items()}
        # the step's outputs replace its inputs (the reference donates them)
        params, opt, m = step_fn(params, opt, batch,
                                 torch.tensor(s, dtype=torch.int32))
        if s % 10 == 0:
            print(f"[quickstart] train step {s}: loss {float(m['loss']):.3f}")
    return params, ds


def serve(cfg, params, ds, device) -> int:
    """A prefill of 2 x 16 prompt tokens, then 8 greedy decode steps ->
    the last sampled token of row 0."""
    cache = T.init_cache(cfg, 2, 64, device=device)
    prompt = {"tokens": to_tensor(ds.batch(99)["tokens"][:2, :16], device)}
    logits, cache = T.lm_prefill(params, prompt, cfg, cache)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for i in range(8):
        logits, cache = T.lm_decode_step(
            params, tok, torch.full((2, 1), 16 + i, dtype=torch.int32,
                                    device=device), cfg, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    sample = int(tok[0, 0])
    print(f"[quickstart] served 8 decode steps; sample token {sample}")
    return sample


def migrate(device):
    """MS2M-individual over the paper consumer at 6 msg/s ->
    ``ExperimentResult``."""
    make_worker, _ = make_torch_worker_factory(max_seq=512, device=device)
    with tempfile.TemporaryDirectory() as reg:
        r = run_migration_experiment(
            "ms2m_individual", message_rate=6.0, registry_root=reg,
            worker_factory=make_worker, seed=0)
    print(f"[quickstart] MS2M migration: migration_time={r.migration_time:.2f}s"
          f" downtime={r.downtime:.2f}s (stop-and-copy would be ~49s)")
    print(f"[quickstart] migrated state verified bit-exact: {r.verified}")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the CUDA kernels; cpu "
                         "their plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    # --- 1. train a tiny LM for a few steps --------------------------------
    cfg = configs.get_smoke("smollm_360m")
    params, ds = train(cfg, device)
    # --- 2. serve: prefill + a few decode steps ----------------------------
    serve(cfg, params, ds, device)
    # --- 3. live-migrate a stateful serving replica (MS2M) -----------------
    migrate(device)


if __name__ == "__main__":
    main()
