#!/usr/bin/env python
"""What one call of the port's recurrence kernels (RG-LRU and sLSTM) costs
on a card, and how it moves with the launch plan.

  python tools/profile_torch_scan.py [--src DIR] [--sweep] [--out F]

At ``chip_smoke.py``'s timed shapes, with inputs made on the card from
seed 0 (``rg-serve`` [8,32,2560] and ``rg-long`` [2,2304,2560] for
``rglru``, ``xl-train`` [8,128,1024] with 4 heads of 256 for ``slstm``,
bf16, and ``xl-train-f32``):

  * the device time of one wrapper call: a CUDA graph of back-to-back
    calls, replayed between CUDA events;
  * ``torch.profiler`` over 10 more calls: every device entry a call
    makes, its count and its device time per call;
  * the largest difference from the plain version.

``--sweep`` (this tree's wrappers only) also times every plan the kernels
take at those shapes: ``rglru`` at each chunk of ``rglru.LANE_STEPS``,
``slstm`` at each batch grouping of the cluster route, with the plan's
clusters of 16 CTAs and with clusters of 8 CTAs of 32 columns, each
beside the clusters it asks for and the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``), and on the L2 route; each plan's
output must equal the default plan's bit for bit.
``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
measured (default: this checkout's), so one command can measure an
earlier tree unpacked beside this one.  Prints ptxas's lines for the two
kernels and the summary as JSON (and writes it to ``--out``).  Exits
non-zero without a card, or if a kernel disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RGLRU = [  # (label, B, S, W)
    ("rg-serve", 8, 32, 2560),
    ("rg-long", 2, 2304, 2560),
]
SLSTM = [  # (label, B, S, H, hb, dtype)
    ("xl-train", 8, 128, 4, 256, "bfloat16"),
    ("xl-train-f32", 8, 128, 4, 256, "float32"),
]
SLSTM_ROWS = (1, 2, 3, 4, 8)  # batch rows a cluster carries, swept


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


def device_entries(torch, fn, calls: int = 10) -> list:
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
            rows.append({"name": e.key[:80], "per_call": e.count / calls,
                         "us_per_call": us / calls})
    return sorted(rows, key=lambda r: -r["us_per_call"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_scan: torch finds no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    build.library()
    for name in ("rglru", "slstm"):
        keep, entry = False, ""
        for line in build.build_log.splitlines():
            if line.startswith("=="):
                keep = name in line
            elif keep and ("Compiling entry" in line or "registers" in line
                           or "spill" in line):
                entry = line.strip()
                print(f"[ptxas] {entry}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {"card": card, "src": os.path.abspath(args.src), "rglru": {},
               "slstm": {}}
    failed = []

    for label, B, S, W in RGLRU:
        x, ga, gx = (torch.randn((B, S, W), generator=gen, device="cuda")
                     .bfloat16() for _ in range(3))
        a = torch.randn((W,), generator=gen, device="cuda")
        h0 = torch.zeros((B, W), device="cuda")
        want = ref.naive_rglru(x, a, ga, gx, h0)
        got = rg.rglru(x, a, ga, gx, h0)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        row = {"shape": [B, S, W], "max_abs_err": err,
               "equal_to_plain": all(torch.equal(g, w)
                                     for g, w in zip(got, want)),
               "ms": graph_ms(torch, lambda: rg.rglru(x, a, ga, gx, h0),
                              50 if S <= 32 else 10),
               "entries": device_entries(torch,
                                         lambda: rg.rglru(x, a, ga, gx, h0))}
        if err > 1e-2:
            failed.append(f"rglru {label}: {err}")
        if args.sweep:
            row["plan"] = list(rg.scan_plan(B, S, W))
            row["by_plan"] = {}
            for u in rg.LANE_STEPS:
                chunk = 2 * rg.PRODUCERS * u
                plan = rg.ScanPlan(chunk, -(-S // chunk))
                out = rg.rglru(x, a, ga, gx, h0, plan=plan)
                same = all(torch.equal(o, g) for o, g in zip(out, got))
                if not same:
                    failed.append(f"rglru {label} plan {plan}: bits differ")
                row["by_plan"][str(tuple(plan))] = graph_ms(
                    torch, lambda: rg.rglru(x, a, ga, gx, h0, plan=plan),
                    50 if S <= 32 else 10)
        summary["rglru"][label] = row
        print(f"[rglru] {label}: " + json.dumps(
            {k: v for k, v in row.items() if k != "entries"}))

    for label, B, S, H, hb, dtype in SLSTM:
        dt = getattr(torch, dtype)
        W = H * hb
        xs = [torch.randn((B, S, W), generator=gen, device="cuda").to(dt)
              for _ in range(4)]
        rs = [torch.randn((H, hb, hb), generator=gen, device="cuda") * 0.02
              for _ in range(4)]
        want = ref.naive_slstm(*xs, *rs)[0]
        got = sl.slstm(*xs, *rs)
        err = (got.float() - want.float()).abs().max().item()
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
            rtol=8e-3, atol=1e-5)
        if not torch.allclose(got.float(), want.float(), **tol):
            failed.append(f"slstm {label}: {err}")
        row = {"shape": [B, S, W, H], "max_abs_err": err,
               "ms": graph_ms(torch, lambda: sl.slstm(*xs, *rs), 10),
               "entries": device_entries(torch,
                                         lambda: sl.slstm(*xs, *rs))}
        if args.sweep:
            row["plan"] = list(sl.slstm_plan(B, H, hb))
            row["by_plan"] = {}
            base = sl.slstm_plan(B, H, hb)
            plans = [base._replace(rows=r) for r in SLSTM_ROWS]
            plans += [sl.SLSTMPlan("cluster", 8, 32, r) for r in SLSTM_ROWS]
            plans.append(sl.SLSTMPlan("l2", 0, hb, 1))
            occupancy = build.entry("slstm_max_active_clusters",
                                    [ctypes.c_int] * 6)
            for plan in plans:
                out = sl.slstm(*xs, *rs, plan=plan)
                if not torch.equal(out, got):
                    failed.append(f"slstm {label} plan {plan}: bits differ")
                entry = {"ms": graph_ms(
                    torch, lambda: sl.slstm(*xs, *rs, plan=plan), 10)}
                if plan.route == "cluster":
                    entry["clusters"] = H * -(-B // plan.rows)
                    entry["max_active_clusters"] = occupancy(
                        B, H, hb, plan.cluster, plan.cols, plan.rows)
                row["by_plan"][str(tuple(plan))] = entry
        summary["slstm"][label] = row
        print(f"[slstm] {label}: " + json.dumps(
            {k: v for k, v in row.items() if k != "entries"}))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    if failed:
        print("profile_torch_scan: FAILED: " + "; ".join(failed),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
