#!/usr/bin/env python
"""Where a fused codec call of the port spends its device time, on a card.

  python tools/profile_torch_codec.py [--calls 50] [--out F]

For each of ``xor_fp_lanes`` and ``int8_fp_lanes`` (``csrc/codec.cu``), at
the fold's shape (one 4 MiB chunk, words ``[1, 8192, 128]``) and the
serving engine's slot-aligned grid (``[1024, 4, 128]``), runs ``--calls``
wrapper calls under ``torch.profiler`` and reports, per call, the device
time of every entry by name: the kernel itself, the lane memset and the
fills that deterministic mode gives each ``torch.empty``.  Inputs are
random float32 words with a dirty stripe against their parent, from a
seed.  Prints the summary as JSON (and writes it to ``--out``).  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

SHAPES = {"fold": (1, 8192), "serving": (1024, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_codec: torch finds no CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets deterministic mode)
    from repro_torch.kernels import codec as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {"card": card, "calls": args.calls, "entries": {}}
    for label, (C, R) in SHAPES.items():
        cur = torch.randn((C, R, 128), generator=gen, device="cuda")
        par = cur.clone()
        par[:, R // 4: R // 4 + max(1, R // 8)] += 1.0
        cw, pw = cur.view(torch.int32), par.view(torch.int32)
        for name, fn in (("xor_fp_lanes", ck.xor_fp_lanes),
                         ("int8_fp_lanes", ck.int8_fp_lanes)):
            for _ in range(5):
                fn(cw, pw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    fn(cw, pw)
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                if str(getattr(e, "device_type", "")).endswith("CUDA"):
                    us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                    rows.append({"name": e.key[:90],
                                 "per_call": e.count / args.calls,
                                 "us_per_call": us / args.calls})
            rows.sort(key=lambda r: -r["us_per_call"])
            summary["entries"][f"{name} {label} [{C},{R},128]"] = {
                "device_us_per_call": sum(r["us_per_call"] for r in rows),
                "by_name": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
