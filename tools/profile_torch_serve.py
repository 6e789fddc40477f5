#!/usr/bin/env python
"""Where ``launch.serve``'s prefill and decode steps spend their time, on a
card.

  python tools/profile_torch_serve.py [--arch recurrentgemma_2b]
      [--requests 8] [--prompt-len 32] [--max-seq 128] [--steps 16]
      [--out F]

Builds the model at full width on the CUDA card (``launch.serve``'s
weights and prompt), then:

  * prefill: one warm-up call, then host clock over one call into a fresh
    cache, then ``torch.profiler`` over one more;
  * decode: 4 warm-up steps, host clock over ``--steps`` steps, then
    ``torch.profiler`` over 8 more;

each with its wall time per call, device time per call (the sum of the
kernels', memsets' and copies' durations; one stream, so they never
overlap), the device's busy share of the profiled wall, device entries
per call and the ten largest device entries.  Prints the summary as JSON
(and writes it to ``--out``).  Exits non-zero without a card.
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


def _device_summary(prof, calls: int, wall_ms: float) -> dict:
    device = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            device.append((e.key, e.count, us))
    device.sort(key=lambda r: -r[2])
    device_ms = sum(us for _, _, us in device) / 1e3 / calls
    return {
        "profiled_wall_ms_per_call": wall_ms / calls,
        "device_ms_per_call": device_ms,
        "device_busy_share": device_ms / (wall_ms / calls),
        "device_entries_per_call": sum(c for _, c, _ in device) / calls,
        "top_device_entries": [
            {"name": name[:90], "per_call": c / calls, "us_per_call": us / calls}
            for name, c, us in device[:10]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma_2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: torch finds no CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.train import step as steplib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = configs.get_config(args.arch)
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    B = args.requests
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, args.prompt_len)).astype(
            np.int32)).cuda()}
    prefill = steplib.build_prefill_step(cfg)
    decode = steplib.build_decode_step(cfg)
    summary = {"card": card, "arch": args.arch, "requests": B,
               "prompt_len": args.prompt_len, "max_seq": args.max_seq,
               "init_s": init_s}

    def fresh_prefill():
        cache = T.init_cache(cfg, B, args.max_seq, device="cuda")
        return prefill(params, cache, batch)

    with torch.no_grad():
        fresh_prefill()  # warm-up: cuBLAS handles, the kernel library
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fresh_prefill()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = fresh_prefill()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        summary["prefill"] = {"wall_ms": wall_ms,
                              **_device_summary(prof, 1, prof_ms)}

        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        pos = torch.full((B, 1), args.prompt_len, dtype=torch.int32,
                         device="cuda")

        def steps(n):
            nonlocal tok, pos, cache
            for _ in range(n):
                lg, cache = decode(params, cache, tok, pos)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                pos = pos + 1
            torch.cuda.synchronize()

        steps(4)
        t0 = time.perf_counter()
        steps(args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(8)
            prof_ms = (time.perf_counter() - t0) * 1e3
        summary["decode_step"] = {"wall_ms": wall_ms,
                                  **_device_summary(prof, 8, prof_ms)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
