#!/usr/bin/env python
"""Where a decode step of the port's consumer spends its time, on a card.

  python tools/profile_torch_decode.py [--steps 200] [--warm 300] [--out F]

Folds ``--warm`` messages into a paper-consumer cache (max_seq 2048, the
migration path's width) on the CUDA card, then:

  * host clock over ``--steps`` decode steps, ending in a synchronize:
    wall time per step (what the migration path pays per message);
  * ``torch.profiler`` over 20 more steps: device time per step (the sum
    of the kernels', memsets' and copies' durations; one stream, so they
    never overlap), the device's busy share of the wall, launches per
    step, and the ten largest device entries.

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
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_decode: torch finds no CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.broker.broker import Message
    from repro_torch.core.consumer import StatefulConsumer
    from repro_torch.models import transformer as T

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = configs.get_config("paper_consumer")
    consumer = StatefulConsumer(cfg, T.init_lm(cfg, seed=0, device="cuda"),
                                max_seq=2048)
    n = args.warm + args.steps + 20
    msgs = [Message(i, {"token": (31 * i) % cfg.vocab_size}, 0.0)
            for i in range(n)]
    consumer.replay_sequential(msgs[:args.warm])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    consumer.replay_sequential(msgs[args.warm:args.warm + args.steps])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

    prof_steps = msgs[args.warm + args.steps:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        consumer.replay_sequential(prof_steps)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    device = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            device.append((e.key, e.count, us))
    device.sort(key=lambda r: -r[2])
    k = len(prof_steps)
    device_ms = sum(us for _, _, us in device) / 1e3 / k
    summary = {
        "card": card,
        "cache_positions": args.warm,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms / k,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (prof_wall_ms / k),
        "device_entries_per_step": sum(c for _, c, _ in device) / k,
        "top_device_entries": [
            {"name": name[:90], "per_step": c / k, "us_per_step": us / k}
            for name, c, us in device[:10]],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
