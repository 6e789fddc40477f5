"""End-to-end training CLI.

Port of ``repro.launch.train``, with the reference's flags, defaults and
printed lines, plus ``--device``.  ``cuda`` (the default) runs every
family's forward through the hand-written kernels: the flash-attention
kernel in every attention layer (smollm_360m, paper_consumer, the local
layers of recurrentgemma_2b, granite_moe_1b_a400m), the RG-LRU kernel
once per recurrent layer (``--arch recurrentgemma_2b``) and the mLSTM and
sLSTM kernels (``--arch xlstm_350m``).  Their backward passes run the
plain versions, as the reference has no backward kernel: the RG-LRU's
recomputes its scan step by step, and holds most of a recurrentgemma
step's wall.  Every checkpoint push fingerprints its leaves with the
fingerprint kernel on the card.  ``cpu`` runs the plain versions.

MoE configs (granite_moe_1b_a400m, llama4_maverick_400b_a17b) add the
router's auxiliary loss (``router_aux_coef`` times the Switch loss and
z-loss) to the cross-entropy, as the reference does; their gradients
through the dispatch and combine gathers run under deterministic mode on
the card and are held card against CPU in float32 (``chip_smoke.py``'s
gradient gate) and against the reference on the CPU.

Fault tolerance wired in:
  * periodic async checkpoints to the registry (images are content-addressed
    — unchanged chunks dedup to zero upload); the final one blocks;
  * restart: ``--resume`` restores the latest image and *replays the batch
    journal* deterministically (the data pipeline is a pure function of
    (seed, step)), i.e. the MS2M recovery path applied to training;
  * straggler mitigation hooks: per-step EWMA of step time.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
      --steps 50 --smoke --registry REG --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \
      --steps 4 --ckpt-every 100 --registry REG
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch recurrentgemma_2b --steps 3 --ckpt-every 100 --registry REG
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite_moe_1b_a400m --smoke --steps 6 --registry REG \
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import Checkpointer, Registry
from repro_torch.convert import to_tensor
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import step as steplib
from repro_torch.tree import tree_map


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--registry",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_registry"),
                    help="registry root (default: repro_registry under the "
                         "temporary directory, $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and optimizer (cuda "
                         "runs the CUDA kernels; cpu their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=args.lr, warmup_steps=10, total_steps=args.steps,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    ds = SyntheticTokenDataset(dcfg)

    registry = Registry(args.registry)
    ckpt = Checkpointer(registry, f"train-{args.arch}",
                        interval_steps=args.ckpt_every)

    params = T.init_lm(cfg, seed=0, device=dev)
    opt_state = adamw.adamw_init(params, tcfg.opt)
    start_step = 0

    if args.resume:
        images = registry.list_images()
        best = None
        for img in images:
            meta = registry.image_meta(img)
            if meta.get("worker") == f"train-{args.arch}":
                if best is None or meta["step"] > best[0]:
                    best = (meta["step"], img)
        if best is not None:
            trees, _ = registry.pull_image(best[1])
            params = tree_map(lambda a: to_tensor(a, dev), trees["params"])
            opt_state = tree_map(lambda a: to_tensor(a, dev), trees["opt"])
            start_step = best[0] + 1
            print(f"[train] resumed from step {best[0]} image {best[1]}")

    step_fn = steplib.build_train_step(cfg, tcfg)

    ewma = None
    for step in range(start_step, args.steps):
        batch = {k: to_tensor(a, dev) for k, a in ds.batch(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(
            params, opt_state, batch, torch.tensor(step, dtype=torch.int32))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt  # straggler signal
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm "
                  f"{float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms "
                  f"(ewma {ewma*1e3:.0f}ms)")
        ckpt.maybe_save(step, {"params": params, "opt": opt_state})
    ckpt.save(args.steps - 1, {"params": params, "opt": opt_state}, block=True)
    print("[train] done; final loss", float(metrics["loss"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
