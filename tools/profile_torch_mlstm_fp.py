#!/usr/bin/env python
"""What one call of the port's mLSTM and chunk-fingerprint kernels costs on
a card, for this tree or an earlier one.

  python tools/profile_torch_mlstm_fp.py [--src DIR] [--costs] [--sweep]
                                         [--flash-bits F] [--out F]

At ``chip_smoke.py``'s timed shapes, with inputs made on the card from
seed 0: ``mlstm`` at ``xl-train`` [8,128,4,512] (one chunk of 128) and
``xl-4chunks`` [2,512,4,512], bf16; ``fingerprint_lanes`` at the fold's
one 4 MiB chunk [1,8192,128], a small leaf [1,8,128] and a 210 MB leaf
[50,8192,128].  For each:

  * the device time of one wrapper call: a CUDA graph of back-to-back
    calls, replayed between CUDA events (output fills under deterministic
    mode included, where the wrapper makes them);
  * ``torch.profiler`` over 10 more eager calls: every device entry a call
    makes, its count and its device time per call;
  * the largest difference from the plain version (``fingerprint_lanes``:
    whether the lanes are bit-identical).

``--costs`` (needs ``nvcc``) builds ``tools/csrc/fingerprint_costs.cu``
into ``build/`` and times what the first port's fingerprint call spent at
[1,8192,128]: the memset before the kernel, the 32-block grid (256 rows a
block), one row load in flight a warp, and the atomicAdd of every block
onto the chunk's 128 words (against each block storing its own partial).
``--sweep`` (this tree's wrappers only) times ``fingerprint_lanes`` with
each chunk's lanes and rows cut into other slices and runs (clusters)
than ``fingerprint_plan``'s, each checked bit for bit.  ``--flash-bits
F`` runs the flash kernel at ``chip_smoke.py``'s timed shapes from seed 0
and saves its outputs to F, or, if F exists, holds them bit for bit
against F (the tree that moved flash's helpers into ``csrc/hopper.cuh``
against the tree before it).  ``--src`` is the ``src`` directory of the
tree whose ``repro_torch`` is measured (default: this checkout's).  Prints the
summary as JSON (and writes it to ``--out``); exits non-zero without a
card, or if a kernel disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.profile_torch_scan import device_entries, graph_ms  # noqa: E402

MLSTM = [  # (label, B, S, H, D, chunk)
    ("xl-train", 8, 128, 4, 512, 128),
    ("xl-4chunks", 2, 512, 4, 512, 128),
]
FINGERPRINT = [  # (label, C, R)
    ("fold", 1, 8192),
    ("small-leaf", 1, 8),
    ("leaf-210MB", 50, 8192),
]
# the first port's call and what each of its costs adds, at [1,8192,128]:
# (label, rows a block, loads in flight a warp, store partials, memset)
COSTS = [
    ("first port: memset, 32 blocks, 1 load, atomics", 256, 1, 0, 1),
    ("no memset", 256, 1, 0, 0),
    ("no memset, 256 blocks", 32, 1, 0, 0),
    ("no memset, 256 blocks, 4 loads", 32, 4, 0, 0),
    ("no memset, 256 blocks, 4 loads, partials stored", 32, 4, 1, 0),
    ("no memset, 32 blocks, 1 load, partials stored", 256, 1, 1, 0),
    ("no memset, 32 blocks, 4 loads, atomics", 256, 4, 0, 0),
]
SWEEP_RUNS = (1, 4, 8, 9, 12, 16)
SWEEP_PIECES = (1, 2, 4, 8, 16, 32)
FLASH = [  # chip_smoke.py:FLASH_TIMED: (label, B, S, H, Hkv, D, dtype, window)
    ("smollm-train", 8, 128, 15, 5, 64, "bfloat16", 0),
    ("paper-train", 8, 128, 8, 4, 32, "float32", 0),
    ("rg-prefill", 8, 32, 10, 1, 256, "bfloat16", 2048),
    ("rg-long-prefill", 2, 2304, 10, 1, 256, "bfloat16", 2048),
]


def build_costs_library(torch) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "fingerprint_costs.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", lib,
                    os.path.join(REPO, "tools", "csrc",
                                 "fingerprint_costs.cu")], check=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.fp_variant_launch.argtypes = [p, p, i, i, i, i, i, i, p]
    dll.fp_variant_launch.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--flash-bits", default="",
                    help="save the flash kernel's outputs here, or compare "
                    "with the ones saved there")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_mlstm_fp: torch finds no CUDA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import mlstm as ml

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {"card": card, "src": os.path.abspath(args.src), "mlstm": {},
               "fingerprint_lanes": {}}
    failed = []

    for label, B, S, H, D, ch in MLSTM:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        ig = torch.randn((B, S, H), generator=gen, device="cuda")
        fg = torch.randn((B, S, H), generator=gen, device="cuda") + 3.0
        got = ml.mlstm(q, k, v, ig, fg, chunk=ch)
        want = ref.chunkwise_mlstm(q, k, v, ig, fg, chunk=ch)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        if rel > 8e-3:
            failed.append(f"mlstm {label}: {rel}")
        row = {"shape": [B, S, H, D], "chunk": ch, "max_abs_err": err,
               "rel_err": rel,
               "ms": graph_ms(torch, lambda: ml.mlstm(q, k, v, ig, fg,
                                                      chunk=ch), 20),
               "entries": device_entries(torch, lambda: ml.mlstm(
                   q, k, v, ig, fg, chunk=ch))}
        summary["mlstm"][label] = row
        print(f"[mlstm] {label}: " + json.dumps(row))

    for label, C, R in FINGERPRINT:
        words = torch.randint(-2 ** 31, 2 ** 31, (C, R, 128), generator=gen,
                              device="cuda", dtype=torch.int64
                              ).to(torch.int32)
        same = torch.equal(fp.fingerprint_lanes(words),
                           fp.fingerprint_lanes_ref(words))
        if not same:
            failed.append(f"fingerprint_lanes {label}: lanes differ")
        row = {"shape": [C, R, 128], "bit_identical": same,
               "ms": graph_ms(torch, lambda: fp.fingerprint_lanes(words),
                              50),
               "entries": device_entries(
                   torch, lambda: fp.fingerprint_lanes(words))}
        if args.sweep:
            row["plan"] = list(fp.fingerprint_plan(C, R))
            row["by_plan"] = {}
            plans = [fp.FingerprintPlan(-(-R // runs), runs, pieces)
                     for runs in SWEEP_RUNS if runs <= R
                     for pieces in SWEEP_PIECES]
            for plan in plans:
                if not torch.equal(fp.fingerprint_lanes(words, plan=plan),
                                   fp.fingerprint_lanes_ref(words)):
                    failed.append(f"fingerprint_lanes {label} {plan}: "
                                  "lanes differ")
                row["by_plan"][str(tuple(plan))] = graph_ms(
                    torch, lambda: fp.fingerprint_lanes(words, plan=plan),
                    50)
        summary["fingerprint_lanes"][label] = row
        print(f"[fingerprint_lanes] {label}: " + json.dumps(row))

    if args.costs:
        dll = build_costs_library(torch)
        words = torch.randint(-2 ** 31, 2 ** 31, (1, 8192, 128),
                              generator=gen, device="cuda",
                              dtype=torch.int64).to(torch.int32)
        out = torch.zeros((1, 8192 // 32, 128), dtype=torch.int32,
                          device="cuda")
        costs = {}
        for label, rows, unroll, partial, memset in COSTS:
            def call():
                err = dll.fp_variant_launch(
                    words.data_ptr(), out.data_ptr(), 1, 8192, rows, unroll,
                    partial, memset, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"fp_variant_launch: error {err}")
            call()
            torch.cuda.synchronize()
            if not partial and memset:
                if not torch.equal(out[0, :1], fp.fingerprint_lanes_ref(
                        words)):
                    failed.append(f"costs {label}: lanes differ")
            costs[label] = {"ms": graph_ms(torch, call, 50),
                            "entries": device_entries(torch, call)}
            print(f"[costs] {label}: " + json.dumps(costs[label]))
        summary["fingerprint_costs"] = costs

    if args.flash_bits:
        # the flash kernel at chip_smoke.py's timed shapes, seeded: saved,
        # or held bit for bit against an earlier tree's saved outputs
        from repro_torch.kernels import flash_attention as fa

        fgen = torch.Generator(device="cuda").manual_seed(0)
        outs = {}
        for label, B, Sq, H, Hkv, D, dt, window in FLASH:
            q = torch.randn((B, Sq, H, D), generator=fgen, device="cuda")
            k, v = (torch.randn((B, Sq, Hkv, D), generator=fgen,
                                device="cuda") for _ in range(2))
            dtype = getattr(torch, dt)
            outs[label] = fa.flash_attention(
                q.to(dtype), k.to(dtype), v.to(dtype), causal=True,
                window=window).cpu()
        if os.path.exists(args.flash_bits):
            before = torch.load(args.flash_bits)
            same = {label: torch.equal(before[label], out)
                    for label, out in outs.items()}
            summary["flash_bits_equal"] = same
            print("[flash] bit-equal to " + args.flash_bits + ": "
                  + json.dumps(same))
            if not all(same.values()):
                failed.append(f"flash bits differ: {same}")
        else:
            torch.save(outs, args.flash_bits)
            print(f"[flash] outputs saved to {args.flash_bits}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    if failed:
        print("profile_torch_mlstm_fp: FAILED: " + "; ".join(failed),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
