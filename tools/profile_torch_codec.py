#!/usr/bin/env python
"""What one call of the port's fused codec kernels costs on a card, for
this tree or an earlier one.

  python tools/profile_torch_codec.py [--src DIR] [--costs] [--sweep]
                                      [--calls 10] [--out F]

For each of ``xor_fp_lanes`` and ``int8_fp_lanes`` (``csrc/codec.cu``) at
every shape the paths give them (``SHAPES``: the fold's one 4 MiB chunk
``[1, 8192, 128]``, the paper-consumer trainer pre-copy's 64 KiB grid
``[C, 128, 128]`` for C 64, 32, 16 and 8 and its small leaves ``[1, 8,
128]`` and ``[1, 2, 128]``, and the serving engine's slot-aligned grid
``[1024, 4, 128]``), with random float32 words made on the card from seed
0 against a parent that differs in a stripe of rows (a chunk that barely
changed, as a KV cache's does) or, for the trainer shapes and
``fold-dense``, in every word by a relative 1e-3 (as AdamW moves every
parameter and moment):

  * the device time of one wrapper call: a CUDA graph of back-to-back
    calls, replayed between CUDA events (memsets and output fills
    included, where the wrapper makes them);
  * ``torch.profiler`` over ``--calls`` more eager calls: every device
    entry a call makes, its count and its device time ("alone": their sum);
  * whether the outputs equal the plain version's bit for bit;
  * the bound: each input read once and each output written once (q as
    int8) over 3.35 TB/s.

``--costs`` takes each call apart: kernel, memset and fill entries, the
call timed again with deterministic mode's fill off, and the gap (a call's
time less its entries' device time).  ``--sweep`` (this tree's wrappers
only) times every plan of ``sweep_plans`` at each shape, each checked bit
for bit, and marks ``codec_plan``'s choice.  ``--src`` is the ``src``
directory of the tree whose ``repro_torch`` is measured (default: this
checkout's; an earlier tree unpacked under ``build/`` with ``git
archive``).  Prints the summary as JSON (and writes it to ``--out``);
exits non-zero without a card, or if a kernel disagrees with its plain
version.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.profile_torch_scan import device_entries, graph_ms  # noqa: E402

SHAPES = [  # (label, C, R)
    ("fold", 1, 8192),
    ("fold-dense", 1, 8192),
    ("trainer-64", 64, 128),
    ("trainer-32", 32, 128),
    ("trainer-16", 16, 128),
    ("trainer-8", 8, 128),
    ("serving", 1024, 4),
    ("small-8", 1, 8),
    ("small-2", 1, 2),
]
PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet
MAX_SWEEP_CTAS = 8192   # plans of more CTAs than this are not swept


def work_bytes(name: str, C: int, R: int) -> int:
    """Bytes a call must move: cur and par read once, the outputs written
    once (lanes; XOR words, or q as int8 and a scale a quant block)."""
    words = C * R * 128
    lanes = C * 128 * 4
    if name == "xor_fp_lanes":
        return 3 * words * 4 + lanes
    nb = -(-R // 2)
    return 2 * words * 4 + C * nb * (256 + 4) + lanes


def sweep_plans(C: int, R: int, kind: str) -> list:
    """The plans ``--sweep`` times at ``C`` chunks of ``R`` rows (and the
    GPU tests force): ``codec_plan``'s first, then every route, slicing,
    run count and chunk grouping worth trying, each of at most
    ``MAX_SWEEP_CTAS`` CTAs."""
    from repro_torch.kernels import codec as ck

    plans = [ck.codec_plan(C, R, kind)]

    def add(plan):
        slices = 32 // plan.pieces
        ctas = plan.runs * slices * -(-C // plan.groups)
        if ctas <= MAX_SWEEP_CTAS and plan not in plans:
            plans.append(plan)

    if kind == "xor":
        for pieces in (2, 4, 8, 16, 32):
            for runs in (1, 2, 4, 8, 9, 12, 16):
                if runs <= R:
                    add(ck.CodecPlan("cluster", -(-R // runs), runs, pieces,
                                     1))
            for groups in (2, 4, 8):
                if groups <= C:
                    add(ck.CodecPlan("cluster", R, 1, pieces, groups))
        return plans
    nb = -(-R // 2)

    def rows(runs):
        return 2 * -(-nb // runs)

    for runs in (1, 2, 3, 4, 8, 9, 16):
        if runs <= nb:
            add(ck.CodecPlan("cluster", rows(runs), runs, 32, 1))
    for groups in (2, 4, 8):
        if groups <= C:
            add(ck.CodecPlan("cluster", 2 * nb, 1, 32, groups))
    for runs in (1, 2, 8, 32, 64, 128, 256, 512, 1024):
        if runs <= nb:
            add(ck.CodecPlan("split", rows(runs), runs, 32, 1))
    return plans


def _same(got, want) -> bool:
    import torch

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t
    return all(g.dtype == w.dtype and torch.equal(bits(g), bits(w))
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    if args.sweep and src != os.path.join(REPO, "src"):
        ap.error("--sweep times this tree's plans only")
    sys.path.insert(0, src)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_codec: torch finds no CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets deterministic mode)
    from repro_torch.kernels import build
    from repro_torch.kernels import codec as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {"card": card, "src": src, "calls": args.calls, "shapes": {}}
    failed = []
    kernels = (("xor_fp_lanes", "xor", ck.xor_fp_lanes, ck.xor_fp_ref),
               ("int8_fp_lanes", "int8", ck.int8_fp_lanes, ck.int8_fp_ref))
    for label, C, R in SHAPES:
        cur = torch.randn((C, R, 128), generator=gen, device="cuda")
        par = cur.clone()
        if label.startswith(("trainer", "fold-dense")):
            par *= 1 + 1e-3 * torch.randn((C, R, 128), generator=gen,
                                          device="cuda")
        else:
            par[:, R // 4: R // 4 + max(1, R // 8)] += 1.0
        cw, pw = cur.view(torch.int32), par.view(torch.int32)
        for name, kind, fn, plain in kernels:
            want = plain(cw, pw)
            same = _same(fn(cw, pw), want) and _same(fn(cw, pw), want)
            if not same:
                failed.append(f"{name} {label}: differs from plain")
            entries = device_entries(torch, lambda: fn(cw, pw), args.calls)
            row = {"shape": [C, R, 128], "bit_identical": same,
                   "ms": graph_ms(torch, lambda: fn(cw, pw), 50),
                   "alone_us": sum(e["us_per_call"] for e in entries),
                   "device_entries": sum(e["per_call"] for e in entries),
                   "entries": entries,
                   "bound_us": work_bytes(name, C, R) / PEAK_BYTES_S * 1e6}
            if hasattr(ck, "codec_plan"):
                row["plan"] = list(ck.codec_plan(C, R, kind))
            if args.costs:
                fill = torch.utils.deterministic.fill_uninitialized_memory
                torch.utils.deterministic.fill_uninitialized_memory = False
                try:
                    no_fill = graph_ms(torch, lambda: fn(cw, pw), 50)
                finally:
                    torch.utils.deterministic.fill_uninitialized_memory = fill
                kinds = {"kernel": 0.0, "memset": 0.0, "fill": 0.0}
                for e in entries:
                    n = e["name"].lower()
                    key = ("memset" if "memset" in n else
                           "kernel" if "fp_kernel" in n
                           or "fingerprint_lanes_kernel" in n else "fill")
                    kinds[key] += e["us_per_call"]
                row["costs"] = {**{f"{k}_us": v for k, v in kinds.items()},
                                "call_without_fills_ms": no_fill,
                                "gap_us": row["ms"] * 1e3 - row["alone_us"]}
            if args.sweep:
                row["by_plan"] = {}
                for plan in sweep_plans(C, R, kind):
                    def call():
                        return fn(cw, pw, plan=plan)
                    if not (_same(call(), want) and _same(call(), want)):
                        failed.append(f"{name} {label} {plan}: differs")
                    row["by_plan"][str(tuple(plan))] = graph_ms(torch, call,
                                                                50)
                best = min(row["by_plan"], key=row["by_plan"].get)
                row["best_plan"] = [best, row["by_plan"][best]]
            summary["shapes"][f"{name} {label}"] = row
            print(f"[{name}] {label}: " + json.dumps(
                {k: v for k, v in row.items() if k != "by_plan"}),
                flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "shapes"}))
    if failed:
        print("profile_torch_codec: FAILED: " + "; ".join(failed),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
