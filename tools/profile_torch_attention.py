#!/usr/bin/env python
"""What one call of the port's attention kernels costs on a card, entry
by entry.

  python tools/profile_torch_attention.py [--src DIR] [--out F]

For the decode kernel at ``chip_smoke.py``'s timed shapes (``main``,
``smollm-serve``, ``rg-serve``, ``rg-ring``) and the flash kernel at its
timed shapes (``smollm-train``, ``paper-train``, ``rg-prefill``,
``rg-long-prefill``, and the other float32 ones: ``qs-train``,
``ex-trainer-train``, ``rg-remat-f32``, ``wh-gate-f32-encoder``) and at
every other float32 case of its ``FLASH_CASES``, with inputs made on the
card from seed 0:

  * the device time of one wrapper call: a CUDA graph of back-to-back
    calls, replayed between CUDA events;
  * ``torch.profiler`` over 20 more calls: every device entry a call
    makes (the output's fill under deterministic mode, workspace fills,
    each kernel), its count and its device time per call.

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
measured (default: this checkout's), so one command can measure an
earlier tree unpacked beside this one.  Prints the summary as JSON (and
writes it to ``--out``).  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECODE = [  # (label, B, S, H, Hkv, D, dtype, ring, window)
    ("main", 1, 2048, 8, 4, 32, "float32", False, 0),
    ("smollm-serve", 8, 128, 15, 5, 64, "bfloat16", False, 0),
    ("rg-serve", 8, 128, 10, 1, 256, "bfloat16", False, 0),
    ("rg-ring", 2, 2048, 10, 1, 256, "bfloat16", True, 2048),
]
FLASH = [  # (label, B, Sq, Sk, H, Hkv, D, dtype, causal, window)
    ("smollm-train", 8, 128, 128, 15, 5, 64, "bfloat16", True, 0),
    ("paper-train", 8, 128, 128, 8, 4, 32, "float32", True, 0),
    ("rg-prefill", 8, 32, 32, 10, 1, 256, "bfloat16", True, 2048),
    ("rg-long-prefill", 2, 2304, 2304, 10, 1, 256, "bfloat16", True, 2048),
    ("qs-train", 8, 64, 64, 3, 1, 20, "float32", True, 0),
    ("ex-trainer-train", 4, 64, 64, 3, 1, 20, "float32", True, 0),
    ("rg-remat-f32", 2, 32, 32, 10, 1, 256, "float32", True, 2048),
    ("wh-gate-f32-encoder", 2, 1500, 1500, 20, 20, 64, "float32", False, 0),
    # the other float32 cases of chip_smoke.py:FLASH_CASES
    *[(f"sweep-{B}x{S}x{H}x{Hkv}x{D}-w{w}", B, S, S, H, Hkv, D, "float32",
       True, w)
      for B, S, H, Hkv, D in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                              (1, 256, 4, 1, 128), (2, 128, 6, 3, 32)]
      for w in (0, 64)],
    ("first-tile-masked", 2, 256, 256, 4, 2, 64, "float32", True, 40),
    ("ragged", 2, 100, 100, 6, 2, 48, "float32", True, 0),
    ("no-valid-key", 2, 128, 48, 4, 2, 16, "float32", True, 16),
    ("no-mask", 2, 96, 96, 4, 4, 32, "float32", False, 0),
    ("d256-f32-window", 2, 100, 100, 10, 1, 256, "float32", True, 40),
    ("d256-f32-no-valid-key", 2, 72, 40, 4, 2, 256, "float32", True, 16),
    ("d200-ragged", 1, 77, 77, 3, 1, 200, "float32", True, 0),
]


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()``: ``reps`` calls in a CUDA graph, replayed
    5 times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def device_entries(torch, fn, calls: int = 20) -> list:
    """Every device entry of ``calls`` eager calls: name, count per call and
    device microseconds per call, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append({"name": e.key[:90], "per_call": e.count / calls,
                         "us_per_call": us / calls})
    return sorted(rows, key=lambda r: -r["us_per_call"])


def decode_inputs(torch, B, S, H, Hkv, D, dtype, ring, window):
    """As ``chip_smoke.py:decode_inputs``, from one generator per shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    if ring:
        q_pos = torch.randint(S // 2, 2 * S, (B,), generator=gen,
                              device="cuda")
        k_pos = torch.randint(-1, 2 * S, (B, S), generator=gen, device="cuda")
        k_pos[:, 0] = q_pos
    else:
        q_pos = torch.full((B,), S - 1, device="cuda")
        k_pos = torch.arange(S, device="cuda")[None].repeat(B, 1)
    if window:
        k_pos = torch.where(q_pos[:, None] - k_pos < window, k_pos, -1)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="src directory of the tree to measure")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_attention: torch finds no CUDA card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets deterministic mode, as the port runs)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    summary = {"card": card, "src": os.path.abspath(args.src),
               "decode": {}, "flash": {}}
    for label, B, S, H, Hkv, D, dt, ring, window in DECODE:
        q, k, v, qp, kp = decode_inputs(torch, B, S, H, Hkv, D,
                                        getattr(torch, dt), ring, window)

        def call():
            return da.decode_attention(q, k, v, qp, kp)

        summary["decode"][label] = {
            "shape": [B, S, H, Hkv, D, dt], "graph_ms": graph_ms(torch, call, 50),
            "entries": device_entries(torch, call)}
    for label, B, Sq, Sk, H, Hkv, D, dt, causal, window in FLASH:
        gen = torch.Generator(device="cuda").manual_seed(0)
        dtype = getattr(torch, dt)
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)

        def call():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        summary["flash"][label] = {
            "shape": [B, Sq, Sk, H, Hkv, D, dt],
            "graph_ms": graph_ms(torch, call, 50 if Sq <= 128 else 5),
            "entries": device_entries(torch, call, 20 if Sq <= 128 else 5)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
