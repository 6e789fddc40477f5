#!/usr/bin/env python
"""Where a train step of the port spends its time, on a card.

  python tools/profile_torch_train.py [--arch smollm_360m] [--steps 5] [--out F]

Runs ``launch/train``'s step (``--arch`` at full width, batch 8 x 128
tokens, remat none, AdamW; whisper_large_v3 with 1500 stub audio frames
a row) on the CUDA card, two steps to warm up, then:

  * host clock over ``--steps`` steps, each ending in a synchronize, split
    into the forward + backward (``lm_loss`` and its gradients) and the
    AdamW update: wall time per step and per phase;
  * ``torch.profiler`` over two more steps: device time per step (the sum
    of the kernels', memsets' and copies' durations; one stream, so they
    never overlap), the device's busy share of the wall, launches per
    step, and the fifteen largest device entries;
  * the time inside each kernel's ``autograd.Function`` backward
    (``SLSTMScan``, ``MLSTMScan``, ``RGLRUScan``, ``FlashAttention``; each
    the plain version's autograd, the reference having no backward
    kernel), per step: the host's wall time inside the calls over the
    timed steps, and under the profiler each call's host time and the
    device time of the work it launched (a ``record_function`` range
    around each call).

Prints the summary as JSON (and writes it to ``--out``).  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: torch finds no CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.convert import to_tensor
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.tree import flatten, unflatten

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = configs.get_config(args.arch)
    opt_cfg = adamw.AdamWConfig(weight_decay=0.01)
    params = T.init_lm(cfg, seed=0, device="cuda")
    opt_state = adamw.adamw_init(params, opt_cfg)
    ds = SyntheticTokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=128, global_batch=8))
    flat, treedef = flatten(params)

    # the kernels' backward passes, timed on the host and marked for the
    # profiler: the autograd engine looks ``backward`` up on the class at
    # every call
    from repro_torch.kernels import flash_attention, mlstm, rglru, slstm
    backward_s = {}
    for fn in (slstm.SLSTMScan, mlstm.MLSTMScan, rglru.RGLRUScan,
               flash_attention.FlashAttention):
        name = f"{fn.__name__}.backward"
        backward_s[name] = [0.0, 0]

        def timed(ctx, *grads, _orig=fn.backward, _name=name):
            t0 = time.perf_counter()
            with torch.profiler.record_function(_name):
                out = _orig(ctx, *grads)
            backward_s[_name][0] += time.perf_counter() - t0
            backward_s[_name][1] += 1
            return out

        fn.backward = staticmethod(timed)

    def step(i, phases=None):
        batch = ds.batch(i)
        if cfg.frontend == "audio_frames":
            # stub audio frames, as chip_smoke.py's train-whisper draws them
            batch["frames"] = np.random.default_rng([0, i]).normal(
                0, 0.02, (8, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batch = {k: to_tensor(a, "cuda") for k, a in batch.items()}
        t0 = time.perf_counter()
        inputs = [p.detach().requires_grad_() for p in flat]
        loss, _ = T.lm_loss(unflatten(treedef, inputs), batch, cfg)
        grads = torch.autograd.grad(loss, inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lr = cosine_schedule(torch.tensor(i, dtype=torch.int32), peak=3e-3,
                             warmup_steps=10, total_steps=50)
        adamw.adamw_update(params, unflatten(treedef, list(grads)),
                           opt_state, opt_cfg, lr=lr)
        torch.cuda.synchronize()
        if phases is not None:
            phases["forward_backward"] += t1 - t0
            phases["adamw"] += time.perf_counter() - t1

    for i in range(2):
        step(i)
    phases = {"forward_backward": 0.0, "adamw": 0.0}
    for v in backward_s.values():
        v[:] = [0.0, 0]
    t0 = time.perf_counter()
    for i in range(2, 2 + args.steps):
        step(i, phases)
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    backward_wall = {name: {"calls_per_step": n / args.steps,
                            "wall_ms_per_step": t / args.steps * 1e3}
                     for name, (t, n) in backward_s.items() if n}

    k = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2 + args.steps, 2 + args.steps + k):
            step(i)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    device = []
    for e in prof.key_averages():
        # a record_function range also shows on the device timeline (a user
        # annotation spanning its kernels): not device work of its own
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and e.key not in backward_s):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            device.append((e.key, e.count, us))
    device.sort(key=lambda r: -r[2])
    # inside each backward range: its host time, and the device time of the
    # kernels that ran within its span on the device timeline (one stream:
    # they are the kernels the range launched)
    events = prof.events()
    kernels = [e for e in events
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation and e.name not in backward_s]
    for name in backward_wall:
        host = [e for e in events
                if e.name == name and str(e.device_type).endswith("CPU")]
        spans = [e.time_range for e in events
                 if e.name == name and str(e.device_type).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in kernels
                   if any(r.start <= e.time_range.start < r.end
                          for r in spans))
        backward_wall[name].update(
            profiled_calls_per_step=len(host) / k,
            profiled_host_ms_per_step=sum(e.cpu_time_total
                                          for e in host) / 1e3 / k,
            profiled_device_span_ms_per_step=sum(
                r.elapsed_us() for r in spans) / 1e3 / k,
            profiled_device_busy_ms_per_step=busy / 1e3 / k)
    device_ms = sum(us for _, _, us in device) / 1e3 / k
    summary = {
        "card": card,
        "arch": args.arch,
        "params": sum(p.numel() for p in flat),
        "tokens_per_step": 8 * 128,
        "wall_ms_per_step": wall_ms,
        "phase_ms_per_step": {name: t / args.steps * 1e3
                              for name, t in phases.items()},
        "profiled_wall_ms_per_step": prof_wall_ms / k,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (prof_wall_ms / k),
        "device_entries_per_step": sum(c for _, c, _ in device) / k,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "backward": backward_wall,
        "top_device_entries": [
            {"name": name[:90], "per_step": c / k, "us_per_step": us / k}
            for name, c, us in device[:15]],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
