#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions,
     the host's CPU count and torch's thread count (``init_lm`` draws on
     that many host threads);
  2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
     and prints the build time and ptxas's register report (registers,
     shared memory, spills; the codec and fingerprint kernels' lines
     again on their own), and, where ``cuobjdump`` exists, the count of
     ``HGMMA`` instructions in the SASS of each tensor-core kernel (flash
     and the mLSTM's two passes: at least one each, or the phase fails);
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes and at ragged shapes, with times (CUDA
     graphs of back-to-back calls, timed with CUDA events) beside the
     least time the card could take and one PyTorch library call where
     one computes the same function.  The fused codec kernels are held
     bit for bit at the fold's shape (a real float32 KV leaf against its
     parent), the serving engine's slot-aligned chunk grid, the trainer
     pre-copy's 64 KiB grid (every float32 leaf of a real trainer's state),
     a ragged odd-row shape and the quantizer's edge values, two launches
     equal, and their ``FusedLeafEncoding`` blobs against the host
     codecs'; at the fold, the serving grid and every trainer leaf shape
     each is timed (a call, and alone: the profiler's device entries a
     call, one on the one-launch route) beside its bound and plan; the
     decode kernel also at
     ``launch.serve``'s shape and on a row with no valid slot.
     The flash-attention kernel is held to its plain version at the
     training and prefill shapes of the paths, at the sweep of
     ``tests/test_kernels.py`` and on masking edge cases (rows whose first
     kv tile is fully masked, ragged lengths, rows with no valid key),
     each case on the route its (dtype, head dim) picks (the route's
     counter says which ran: bf16 with D % 16 == 0 on wgmma's bf16
     products, float32 and other bf16 head dims on its split tf32
     products, "tf32x3"); at the timed shapes of both attention
     kernels the profiler also gives the kernel's own device time and
     shows one kernel launch a call, and at the float32 ones the
     kernel's drift against a float64 version is bounded and the plain
     version with TF32 products must miss the float32 tolerance;
     both attention kernels also at recurrentgemma_2b's head_dim 256 with
     10 query heads over 1 kv head (its prefill, a 2304-token prompt past
     the 2048 window, its decode cache and a local ring past the window),
     and at the dense family's serving shapes: codeqwen1_5_7b (MHA, D
     128), chatglm3_6b (32 heads over 2) and gemma3_4b (D 256, 8 heads
     over 4; its 1024-slot ring, a 1280-slot global cache, and a
     1152-token prefill with window 1024 and without),
     granite_moe_1b_a400m's (16 heads over 8, D 64), whisper_large_v3's
     (MHA, 20 heads, D 64: the encoder over 1500 frames, non-causal with a
     ragged last kv tile, the cross-attention over them at Sq 32 and at a
     decode step's Sq 1, the decoder's self-attention and its decode
     cache) and qwen2_vl_72b's (64 heads over 8, D 128: a 288-token
     prefill and a 320-slot decode cache); and the flash kernel's ragged
     last kv tile at the end of a batch row: a next row of 1e30 values
     leaves the row's output bit-equal to the row run alone.
     The RG-LRU kernel at ``launch.serve``'s prefill, the 2304-token
     prompt, ``tests/test_kernels.py``'s shapes, with h0, one step, a
     ragged width, a slow decay (a_t near 1), a large h0 and sequences
     ending one step either side of a chunk boundary, each case's plan
     printed and the cases bit-equal to the plain version counted, and its
     autograd gradient against the plain version's.  The sLSTM kernel at
     xlstm_350m's train shape, ``tests/test_kernels.py``'s shapes, a ragged
     head width, batches of 3, 5 and 1, one head and hb 512, each on the
     route its plan picks (the cluster-route counter says which ran; at
     the train shape the L2 route gives the cluster route's bits); the
     mLSTM kernel at the train shape
     (one chunk), over four chunks, at ``tests/test_kernels.py``'s shapes
     and chunks, a ragged head dim and the wgmma route's edges (a chunk
     of 100, D 320), each case on the route its (dtype, head dim) picks
     (the wgmma counter says which ran: bf16 with D % 64 == 0 on the
     tensor cores) and its plan held against the library's; both in
     float32 and bf16, with their autograd gradients against the plain
     versions'.  The fingerprint kernel bit for bit at the fold's 4 MiB
     chunk, a small leaf, a 210 MB leaf of 50 chunks, a ragged shape and
     the leaves of codeqwen1_5_7b's int8 KV cache (K or V in 32 chunks,
     scales, pos), with one device entry a call at the timed shapes;
  4. model: the paper consumer's decode steps on the card against the
     same steps on the CPU (the plain path); over five seeds, card against
     CPU, the gradients and three AdamW train steps of the paper consumer
     at full width, and the logits of smollm_360m at full width cut to 2
     layers (so that the CPU can run it too) through a forward, a prefill
     and decode steps at ``launch.serve``'s shapes; over three seeds, the
     logits of recurrentgemma_2b at full width cut to one 13-layer period
     (a prefill of 2 x 32 and 4 decode steps, in bf16 and in float32);
     over three seeds, the logits of xlstm_350m at full width cut to one
     group (7 mLSTM + 1 sLSTM: a forward through the kernels, then a
     prefill and 4 decode steps through the recurrences, in bf16 and in
     float32); over ``DENSE_SEEDS``, the logits of codeqwen1_5_7b and
     chatglm3_6b at full width cut to 2 layers and of gemma3_4b cut to its
     pattern's first 6 entries (a prefill of 8 x 32 and 4 decode steps, in
     bf16 and in float32); over ``MOE_SEEDS``, the logits of
     granite_moe_1b_a400m at full width cut to ``MOE_LAYERS`` layers and
     of llama4_maverick_400b_a17b's smoke config (the same prefill and
     decode steps, in bf16 and in float32), with the expert picks that
     differ between card and CPU per layer and the prefill's capacity
     drops printed; over ``FRONTEND_SEEDS``, the logits of
     whisper_large_v3 at full width cut to 2 encoder + 2 decoder layers
     (B 2 with 1500 audio frames, a prefill of 32 and 4 decode steps) and
     of qwen2_vl_72b at full width cut to 2 layers (B 1, a 288-token
     prompt with 256 image patches under image M-RoPE ids, 4 decode
     steps), in bf16 and in float32, and ``apply_mrope`` itself at
     qwen2-vl's q and k shapes; from the same draws, float32 gradient
     gates of recurrentgemma_2b (over ``RG_GRAD_SEEDS``) and
     granite_moe_1b_a400m (over ``MOE_SEEDS``, the card taking the CPU's
     expert picks, each of its own that differs a near-tie): the loss
     (over its per-token terms), the grad norm, the worst leaf's
     gradient and the params after one AdamW step of ``launch.train``'s
     settings on a [2, 32] batch
     (``GRAD_LIMITS``, TF32 products the control); each limit lies
     between the sound readings
     and a control's (TF32 products, attention without its masks, the
     RG-LRU without its carry, the mLSTM without its forget-gate decay,
     RoPE over chatglm3's whole head, gemma3 without QK-norm, experts
     taken from the lowest router probabilities, whisper's encoder run
     causal, qwen2-vl's prompt under t = h = w ids, M-RoPE's sections
     permuted), and the control must fail it; the CPU side of
     recurrentgemma's gate runs in a thread of its own from the start
     (``HostRuns``), beside the build and the kernel phase, and the CPU
     sides of the dense and frontend checks in another from the end of
     the MoE phase, beside the migrate paths, the examples and the trainer
     migrations, whose card sides then run (the card drawing the same
     weights itself);
  4b. remat (``remat_phase``, lines ``[remat]``): ``remat="none"``,
     ``"dots"`` (the reference's ``dots_with_no_batch_dims_saveable``: a
     selective checkpoint that saves the products with no batch dims)
     and ``"full"`` on the card: smollm_360m at full width and depth,
     ``launch.train``'s settings, one warm-up step then 2 steps under
     each, bit-equal across the three (losses, grad norms, params, AdamW
     state), 32 flash launches a step under ``none`` and 64 under the
     others (the recompute launches the kernel again), ``aten.mm``
     counted in the backward (``dots`` reruns none of the forward's),
     each policy's step walls, saved activations (falling from ``none``
     to ``full``) and forward + backward peak printed; recurrentgemma_2b's
     float32 gradient step (13 layers) under ``dots`` and ``full``,
     bit-equal to its gate's sound card run, ``rglru`` and flash launched
     twice as often;
  5. path: ``repro_torch.launch.migrate.main`` with its defaults (the
     paper consumer at full width, max_seq 2048), with ``--precopy``,
     with ``--precopy --compression int8`` and with ``--workload serving
     --precopy --compression int8`` (the serving engine on the card);
     each must verify its migrated state (and exactly-once delivery for
     serving) and launch the kernels of its path.  Every flash launch of
     ``launch.train``, ``launch.serve`` (smollm_360m and recurrentgemma_2b,
     bf16) must take the wgmma route, and every one of the paper-consumer
     trainer migrations (float32) the tf32x3 route.  Then training:
     ``repro_torch.launch.train`` with its defaults (smollm_360m at full
     width) for 8 steps, and ``--resume`` to 10 steps from its last image
     (about 13 GB of checkpoint images in a temporary registry under
     ``build/``, checked for room first and deleted after);
     ``launch.train --arch recurrentgemma_2b`` and ``--arch
     granite_moe_1b_a400m`` at full width and depth with the CLI's
     defaults for 3 steps (``train-rg``: 18 ``rglru`` and 8 flash
     launches a step; ``train-granite``: 24 flash launches a step; all
     flash launches on the wgmma route; a 32.2 GB and a 16.0 GB image
     pushed twice, at step 0 and at the end, fingerprints on the card;
     init, step walls, peak card memory, snapshot and push seconds and
     GB/s printed);
     ``repro_torch.launch.serve`` with its defaults (smollm_360m prefill
     and decode); ``launch.serve --arch recurrentgemma_2b`` with its
     defaults and with a 2304-token prompt, each launching ``rglru``,
     ``flash_attention`` and ``decode_attention`` the counts its layers
     give, and the default run's cache after prefill pushed through the
     registry (fingerprints on the card), pulled, and decoded 8 steps
     bit-equal to the source; ``launch.train --arch xlstm_350m`` (full
     width, 4 steps: 21 ``mlstm`` and 3 ``slstm`` launches a step, every
     ``slstm`` launch on the cluster route and every ``mlstm`` launch on
     the wgmma route) and
     ``launch.serve --arch xlstm_350m`` with its defaults, its cache after
     prefill (706,415,232 bytes of recurrent state) through the registry
     and decoded 8 steps bit-equal; ``launch.serve --arch codeqwen1_5_7b``
     and ``--arch chatglm3_6b`` with their defaults and ``--arch gemma3_4b
     --requests 2 --prompt-len 1152 --max-seq 1280 --decode-steps 16``
     (full width and depth; one flash launch per layer a prefill, one
     decode launch per layer a step; init, prefill and decode times
     printed), and codeqwen with an int8 KV cache from the same params:
     its prefill's quantized K/V bit-identical to the CPU's on the same
     inputs, the cache (272,629,760 bytes of K/V and scales) through the
     registry and decoded 8 steps bit-equal; ``launch.serve --arch
     granite_moe_1b_a400m`` with its defaults at full width and depth (24
     flash launches a prefill, 24 decode launches a step) and its cache
     after prefill (50,429,952 bytes: K/V and pos) through the registry
     and decoded 8 steps bit-equal; ``launch.serve --arch
     whisper_large_v3`` with its defaults at full width and depth (96
     flash launches a prefill: 32 encoder, 32 self, 32 cross; a decode
     step 32 decode and 32 flash launches, the cross-attention recomputed
     over the 1500 frames, all on the wgmma route) and its cache after
     prefill (198,623,232 bytes: K/V, pos and ``enc_out``) through the
     registry and decoded 8 steps bit-equal; qwen2_vl_72b at full width
     cut to 4 of its 80 layers (``serve-qwen2vl-4l``, through the step
     functions: 8 x 288 with 256 image patches each, 32 decode steps; 4
     flash launches a prefill and 4 decode launches a step);
     ``sharded-1x1``: smollm_360m at full width and depth through the
     multi-device layer on an NCCL world of one rank and the 1 x 1 host
     mesh (params, AdamW state, batches and cache as DTensors by the train
     step's shardings), 4 train steps and a prefill + 8 decode steps
     bit-equal to the unsharded path, the flash and decode kernels
     launched on local shards (no multi-rank mesh runs on the card); every
     path's ``init_lm`` seconds and params a second printed; and a
     paper-consumer
     ``TrainerWorker`` at full width
     migrated through ``ms2m_statefulset`` and through ``ms2m_precopy``
     with int8 deltas (``benchmarks/delta_precopy.py``'s trainer
     workload), each verified bit for bit against the reference fold;
  6. examples (``examples_phase``, lines ``[examples]``): the port's
     quickstart, serving-engine and StatefulSet-trainer examples run whole
     on the card, and the live example's replay-speedup measurement and
     its two ``ms2m_cutoff`` runs at 16 msg/s (paper-faithful, the cutoff
     firing, and batched at the card's speedup), each verified, with the
     virtual times and counts the JAX examples print; the live example's
     four strategies at 10 msg/s and the rolling example are held on the
     CPU by the tests (see the phase).

Before the two JSON lines it prints the script's own run time.  The line
before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside this file, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published H100 SXM peaks (data sheet): HBM bytes/s, float32 outside the
# tensor cores (which also stands for 32-bit integer multiply-add here) and
# bf16 on the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
# TF32 on the tensor cores, a third of it: the flash kernel's tf32x3 route
# makes three products of every one
PEAK_TF32X3_OPS_S = 495e12 / 3
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)      # float32, split-KV sum order
DECODE_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 output rounding
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)       # float32, tile-wise sum order
FLASH_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 output rounding
# float32 flash: the drift of the output along itself against a float64
# version, sum((got - want) * want) / sum(want * want).  FLASH_TOL, element
# by element, cannot see a bias: products carried through one truncating
# tensor-core accumulator over whisper's 1500 keys drift by about -1e-5
# (tests/test_torch_attention_plan.py's model of it), and such a kernel
# failed whisper's float32 gradient gate (loss 1.2e-6 over its 5e-7 limit,
# PERF.md); the plain version drifts by 1e-9 to 3e-9
FLASH_DRIFT = 1e-6
# card against CPU, worst over SEEDS; each limit lies between the sound
# readings and its control's (PERF.md, PR 13: on an H100 over seeds 0-4,
# sound / control).  Paper consumer (float32): the largest gradient
# difference at init over the leaf's largest gradient (2.5e-6 / 1.4e-3),
# the loss (6.2e-8 / 1.4e-6) and grad_norm (2.0e-7 / 3.4e-5) of three
# AdamW steps, relative, and the params after them, absolute (5.1e-5 /
# 7.4e-4: Adam's per-entry normalization turns a sum-order difference on
# a near-zero gradient into a visible part of lr); the control lets
# cuBLAS round to TF32.
SEEDS = (0, 1, 2, 3, 4)
TRAIN_LIMITS = dict(grads=5e-5, loss=3e-7, grad_norm=3e-6, params=2e-4)
# smollm_360m (bf16 compute), relative L2 error of the logits of a
# forward, a prefill and 4 decode steps (6.4e-3 / 0.38 at worst); the
# control drops attention's masks (a wrong attention forward); whether
# this check sees a lower-precision product is not measured.
SMOLLM_LIMITS = dict(forward=5e-2, prefill=5e-2, decode=5e-2)
# the benchmark's WAN profile for the trainer workload
# (benchmarks/delta_precopy.py:WAN_TIMINGS)
WAN_TIMINGS = dict(checkpoint_s=1.0, image_build_s=2.0, delta_build_s=0.5,
                   push_base_s=0.5, pull_base_s=0.5, restore_s=2.0,
                   registry_bw_Bps=10e6)
# request rate of the serving engine's run (req/s; the CLI's default is
# 10): low enough that the run stays near a minute on the card
SERVING_RATE = "2"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def graph_ms(fn, reps: int = 50, graphs: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``graphs`` times between CUDA events (no host launch
    overhead in the number)."""
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
    for _ in range(graphs):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (graphs * reps)


PROFILE_MARGIN_S = 0.02


def device_entries(fn, calls: int = 20, retries: int = 2) -> list:
    """Every device entry of ``calls`` eager ``fn()`` calls under
    ``torch.profiler``: (name, count per call, device us per call).

    Every call makes the same entries, so an entry counted a fractional
    number of times a call, or no device entry at all, is the profiler
    losing events (seen now and then on the H100, as often as twice in
    one run): then the calls are profiled again, up to ``retries`` more
    times, and the last profile stands."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler keeps the device events inside its window on the
        # host's clock, onto which it maps the card's, so the calls keep
        # clear of both edges of the window (without these margins one
        # call of twenty went missing in twelve profiles in a row of one
        # run, the host's CPUs busy with a thread's CPU work; with them
        # events are still lost now and then, and the retries catch it)
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((e.key, e.count / calls, us / calls))
    if retries and (not rows or any(c != int(c) for _, c, _ in rows)):
        print(f"[kernels] the profiler lost events ({rows}): profiling "
              "again")
        return device_entries(fn, calls, retries - 1)
    return rows


def kernel_entry(label, fn, name: str, calls: int = 20) -> float:
    """The device us per call of ``fn``'s kernel (entries whose name holds
    ``name``): one launch a call, beside the other entries it makes (the
    output's fill under deterministic mode)."""
    rows = device_entries(fn, calls)
    print(f"[kernels] {label} device entries per call: " + "; ".join(
        f"{n[:60]} x{c:g} {us:.2f} us" for n, c, us in rows))
    mine = [(c, us) for n, c, us in rows if name in n]
    check(len(mine) == 1 and mine[0][0] == 1,
          f"{label}: want one {name} kernel a call, the profiler shows "
          f"{rows}")
    return mine[0][1]


def bound(nbytes: int, ops: int, peak_ops_s: float = PEAK_F32_OPS_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_phase() -> str:
    check(torch.cuda.is_available(), "torch finds no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} "
          f"usable; torch intra-op threads {torch.get_num_threads()} (the "
          f"init draw's thread count)")
    return card


NEW_KERNELS = ("xor_fp_kernel", "int8_fp_kernel", "fingerprint_lanes_kernel")
TENSOR_CORE_KERNELS = ("flash_wgmma_kernel", "flash_tf32x3_kernel",
                       "mlstm_wgmma_kernel", "mlstm_state_kernel")


def build_phase() -> None:
    """Builds the kernels; prints ptxas's report (registers, shared memory,
    spills) and, where ``cuobjdump`` exists, the count of ``HGMMA``
    (wgmma) instructions in the SASS of each tensor-core kernel (flash and
    the mLSTM's two passes)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.library()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.3f} s")
    entry = None
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Compiling entry function" in line):
            print(f"[build] {line.strip()}")
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and any(k in entry for k in NEW_KERNELS) and (
                "spill" in line or "registers" in line):
            print(f"[build] new kernel {entry}: {line.strip()}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("[build] no cuobjdump: HGMMA not counted")
        return
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()[:200]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if any(k in fn for k in TENSOR_CORE_KERNELS):
                counts[fn] = 0
        elif fn in counts and "HGMMA" in line:
            counts[fn] += 1
    for fn, n in counts.items():
        print(f"[build] SASS {fn}: {n} HGMMA instructions")
    check(all(any(k in fn for fn in counts) for k in TENSOR_CORE_KERNELS)
          and all(counts.values()),
          f"a tensor-core kernel has no HGMMA in its SASS: {counts}")


def decode_inputs(gen, B, S, H, Hkv, D, dtype, ring: bool, window: int = 0):
    """q, k, v, q_pos, k_pos on the card; ``window`` > 0 marks the ring's
    slots outside the window empty (-1), as ``attention.attn_decode``
    does for a local layer."""
    dev = "cuda"
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    if ring:
        # ring buffer of a local layer: some slots empty (-1), some ahead
        # of the query (masked), the rest valid and out of order
        q_pos = torch.randint(S // 2, 2 * S, (B,), generator=gen, device=dev)
        k_pos = torch.randint(-1, 2 * S, (B, S), generator=gen, device=dev)
        k_pos[:, 0] = q_pos  # the current slot is always written
    else:
        q_pos = torch.full((B,), S - 1, device=dev)
        k_pos = torch.arange(S, device=dev)[None].repeat(B, 1)
    if window:
        k_pos = torch.where(q_pos[:, None] - k_pos < window, k_pos, -1)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


DECODE_TIMED = ("main", "smollm-serve", "rg-serve", "rg-ring", "cq-serve",
                "glm-serve", "g3-serve", "g3-ring", "gm-serve", "wh-serve",
                "qvl-serve", "qs-serve", "engine")


def kernel_phase():
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # -- decode attention -------------------------------------------------
    cases = [  # (label, B, S, H, Hkv, D, dtype, ring, window, tol)
        ("main", 1, 2048, 8, 4, 32, torch.float32, False, 0, DECODE_TOL),
        # launch.serve's shape: smollm_360m, batch 8, max_seq 128, g = 3
        ("smollm-serve", 8, 128, 15, 5, 64, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("smollm-serve-ring", 8, 128, 15, 5, 64, torch.bfloat16, True, 0,
         DECODE_TOL_BF16),
        ("ragged", 3, 1000, 12, 3, 48, torch.float32, True, 0, DECODE_TOL),
        ("ragged-bf16", 2, 777, 8, 2, 64, torch.bfloat16, True, 0,
         DECODE_TOL_BF16),
        # recurrentgemma_2b: launch.serve's shape (MQA, g = 10, D = 256),
        # and the 2048-slot ring of a local layer past its window
        ("rg-serve", 8, 128, 10, 1, 256, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("rg-ring", 2, 2048, 10, 1, 256, torch.bfloat16, True, 2048,
         DECODE_TOL_BF16),
        ("rg-ring-f32", 2, 300, 10, 1, 256, torch.float32, True, 128,
         DECODE_TOL),
        ("d200-g12", 3, 100, 12, 1, 200, torch.float32, True, 0,
         DECODE_TOL),
        # the dense family's launch.serve shapes: codeqwen1_5_7b (MHA,
        # D 128, 256 single-CTA units: two waves), chatglm3_6b (g 16) and
        # gemma3_4b (D 256, g 2), then gemma3's 1024-slot local ring past
        # its window and a 1280-slot global cache (the long prompt's)
        ("cq-serve", 8, 128, 32, 32, 128, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("glm-serve", 8, 128, 32, 2, 128, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("g3-serve", 8, 128, 8, 4, 256, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("g3-ring", 2, 1024, 8, 4, 256, torch.bfloat16, True, 1024,
         DECODE_TOL_BF16),
        ("g3-global", 2, 1280, 8, 4, 256, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        # granite_moe_1b_a400m's launch.serve shape (16 heads over 8, D 64)
        ("gm-serve", 8, 128, 16, 8, 64, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        # whisper_large_v3's launch.serve shape (MHA, 20 heads, D 64) and
        # serve-qwen2vl-4l's (64 heads over 8, D 128, 320 slots)
        ("wh-serve", 8, 128, 20, 20, 64, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        ("qvl-serve", 8, 320, 64, 8, 128, torch.bfloat16, False, 0,
         DECODE_TOL_BF16),
        # the examples: torch_quickstart.py's serve part (the smoke
        # smollm_360m, float32, D 20: 3 heads over 1, a 64-slot cache) and
        # torch_serving_engine_migration.py's engine (the smoke paper
        # consumer, D 16: 4 heads over 2, 2 slots of 128)
        ("qs-serve", 2, 64, 3, 1, 20, torch.float32, False, 0, DECODE_TOL),
        ("engine", 2, 128, 4, 2, 16, torch.float32, False, 0, DECODE_TOL),
    ]
    main_err = None
    timed = {}
    for label, B, S, H, Hkv, D, dtype, ring, window, tol in cases:
        q, k, v, qp, kp = decode_inputs(gen, B, S, H, Hkv, D, dtype, ring,
                                        window)
        plan = da.decode_plan(B, S, Hkv, H // Hkv, D, q.element_size())
        got = da.decode_attention(q, k, v, qp, kp)
        again = da.decode_attention(q, k, v, qp, kp)
        want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[kernels] decode_attention {label} B={B} S={S} H={H} "
              f"Hkv={Hkv} D={D} {str(dtype)[6:]} plan {tuple(plan)}: "
              f"max_abs_err={err:.3e}")
        check(bool(torch.isfinite(got).all()), f"decode {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"decode {label}: kernel disagrees with the plain version "
              f"({err:.3e}, tolerance {tol})")
        check(torch.equal(got, again),
              f"decode {label}: two launches differ")
        if label == "main":
            main_err = err
        if label in DECODE_TIMED:
            timed[label] = (q, k, v, qp, kp, err, tol)
    by_shape = {}
    for label, (q, k, v, qp, kp, err, tol) in timed.items():
        B, _, H, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        ms = graph_ms(lambda: da.decode_attention(q, k, v, qp, kp))
        kernel_us = kernel_entry(f"decode_attention {label}",
                                 lambda: da.decode_attention(q, k, v, qp, kp),
                                 "decode_cluster_kernel")
        plain_ms = graph_ms(lambda: ref.decode_attention(q, k, v, q_pos=qp,
                                                         k_pos=kp))
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = ((kp >= 0) & (kp <= qp[:, None]))[:, None, None, :]
        lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             enable_gqa=True).transpose(1, 2)
        check(torch.allclose(lib.float(), ref.decode_attention(
            q, k, v, q_pos=qp, k_pos=kp).float(), **tol),
            f"SDPA yardstick disagrees with the plain decode version "
            f"({label})")
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        n_valid = int(((kp >= 0) & (kp <= qp[:, None])).sum())  # rows read
        nbytes = (q.nbytes * 2 + 2 * n_valid * Hkv * D * k.element_size()
                  + qp.nbytes + kp.nbytes)
        b_ms, b_by = bound(nbytes, 4 * H * n_valid * D)
        plan = da.decode_plan(B, S, Hkv, H // Hkv, D, q.element_size())
        by_shape[label] = dict(shape=[B, S, H, Hkv, D], plan=list(plan),
                               max_abs_err=err,
                               ms=ms, kernel_us=kernel_us, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               library_ms=library_ms)
        print(f"[kernels] decode_attention {label}: {ms * 1e3:.2f} us "
              f"a call ({kernel_us:.2f} us the kernel alone), "
              f"{plain_ms * 1e3:.2f} us plain, {library_ms * 1e3:.2f}"
              f" us SDPA, bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes)")
    main = by_shape["main"]
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        max_abs_err=main_err, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], by_shape=by_shape)

    # -- chunk fingerprint lanes -------------------------------------------
    rows["fingerprint_lanes"] = fingerprint_kernel(gen)
    rows.update(codec_kernels())
    rows["flash_attention"] = flash_kernel(gen)
    flash_ragged_isolation(gen)
    rows["rglru"] = rglru_kernel(gen)
    rows["slstm"] = slstm_kernel(gen)
    rows["mlstm"] = mlstm_kernel(gen)
    decode_empty_row(gen)
    print("[kernels] " + json.dumps(sorted(rows)))
    return rows


FP_CASES = [  # (label, C, R): each [C, R, 128] words
    ("fold", 1, 8192),          # the fold's 4 MiB KV leaf: one chunk
    ("small-leaf", 1, 8),       # xlstm_350m's norm vectors
    ("leaf-210MB", 50, 8192),   # 50 chunks of 4 MiB
    ("ragged", 3, 77),
    # codeqwen1_5_7b's int8 KV cache through the registry: an int8 K or V
    # leaf (32 chunks), its bf16 scales and its pos leaf
    ("int8-kv", 32, 8192),
    ("int8-scales", 1, 4096),
    ("int8-pos", 1, 256),
    # the other leaf shapes of train-xl's image pushes (xlstm_350m's params
    # and AdamW moments: each push fingerprints 63 leaves of 12 chunks, 63
    # of 6, 3 of 50, 15 of 3, 12 of [1,6144], 21 of [1,384], 36 of [1,24],
    # 21 of [1,12], 3 of [1,8] and 22 of [1,1])
    ("xl-12ch", 12, 8192),
    ("xl-6ch", 6, 8192),
    ("xl-3ch", 3, 8192),
    ("xl-6144", 1, 6144),
    ("xl-384", 1, 384),
    ("xl-24", 1, 24),
    ("xl-12", 1, 12),
    ("xl-1", 1, 1),
    # the other leaf shapes of the train-rg, train-granite and
    # train-whisper pushes (params, AdamW moments and count, float32 words
    # on the 4 MiB grid: push_shapes)
    ("rg-625ch", 625, 8192),
    ("rg-38ch", 38, 8192),
    ("rg-13ch", 13, 8192),
    ("rg-2ch", 2, 8192),
    ("rg-160", 1, 160),
    ("rg-40", 1, 40),
    ("rg-20", 1, 20),
    ("gm-384ch", 384, 8192),
    ("gm-24ch", 24, 8192),
    ("gm-192", 1, 192),
    ("wh-200ch", 200, 8192),
    ("wh-65ch", 65, 8192),
    ("wh-10ch", 10, 8192),
    ("wh-320", 1, 320),
    ("wh-10", 1, 10),
]
FP_TIMED = ("fold", "small-leaf", "leaf-210MB", "int8-kv", "xl-12ch",
            "xl-6ch", "xl-3ch", "xl-6144", "xl-384", "xl-24", "xl-12", "xl-1",
            "rg-625ch", "rg-38ch", "rg-13ch", "rg-2ch", "rg-160", "rg-40",
            "rg-20", "gm-384ch", "gm-24ch", "gm-192", "wh-200ch", "wh-65ch",
            "wh-10ch", "wh-320", "wh-10")
# the trainer paths whose pushes FP_CASES times whole (push_shapes)
FP_PUSHES = {"train-rg": "recurrentgemma_2b",
             "train-granite": "granite_moe_1b_a400m",
             "train-whisper": "whisper_large_v3"}


def push_shapes(arch: str) -> dict:
    """{(C, R): launches} of one push of ``arch``'s trainer image at full
    width and depth: a params leaf is fingerprinted three times (params,
    m and v, float32) and the step count once, each as
    ``fingerprint.chunked_words`` lays it out on the registry's grid
    (shapes from the config's specs on the meta device: nothing drawn)."""
    import math

    from repro_torch import configs
    from repro_torch.checkpoint.registry import CHUNK_BYTES
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.models import common
    from repro_torch.models import transformer as T

    def shape(n: int):
        words = torch.empty(n, dtype=torch.float32, device="meta")
        return tuple(fp.chunked_words(words, CHUNK_BYTES).shape[:2])

    counts = collections.Counter({shape(1): 1})
    for _, leaf in common.leaf_paths(T.lm_specs(configs.get_config(arch))):
        counts[shape(math.prod(leaf.shape))] += 3
    return dict(counts)


def fingerprint_kernel(gen):
    """The fingerprint kernel bit for bit against its plain version at
    every case, and on a real float32 leaf through the registry's path on
    both devices; at the timed shapes its time a call, its device entries
    a call (one: the kernel, no memset and no fill) and its plan."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ops

    by_shape = {}
    for label, C, R in FP_CASES:
        words = torch.randint(-2 ** 31, 2 ** 31, (C, R, 128),
                              generator=gen, device="cuda",
                              dtype=torch.int64).to(torch.int32)
        got = fp.fingerprint_lanes(words)
        again = fp.fingerprint_lanes(words)
        want = fp.fingerprint_lanes_ref(words)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(again, want)
        plan = fp.fingerprint_plan(C, R)
        print(f"[kernels] fingerprint_lanes {label} [{C},{R},128] plan "
              f"{tuple(plan)}: bit-identical={same}")
        check(same, f"fingerprint {label}: kernel differs from plain version")
        if label not in FP_TIMED:
            continue
        ms = graph_ms(lambda: fp.fingerprint_lanes(words))
        entries = device_entries(lambda: fp.fingerprint_lanes(words))
        print(f"[kernels] fingerprint_lanes {label} device entries per call: "
              + "; ".join(f"{n[:60]} x{c:g} {us:.2f} us"
                          for n, c, us in entries))
        check(len(entries) == 1 and entries[0][1] == 1
              and "fingerprint_lanes_kernel" in entries[0][0],
              f"fingerprint {label}: want one device entry a call (the "
              f"kernel), the profiler shows {entries}")
        plain_ms = graph_ms(lambda: fp.fingerprint_lanes_ref(words),
                            reps=50 if C == 1 else 5)
        b_ms, b_by = bound(words.nbytes + C * 128 * 4, 2 * C * R * 128)
        by_shape[label] = dict(shape=[C, R, 128], plan=list(plan),
                               max_abs_err=0.0, ms=ms,
                               kernel_us=entries[0][2], device_entries=1,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
        print(f"[kernels] fingerprint_lanes {label}: {ms * 1e3:.2f} us a "
              f"call ({entries[0][2]:.2f} us the kernel alone), "
              f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
              f"({b_by})")
    # one whole push of each trainer path: its launches at each shape
    timed = {(C, R): label for label, C, R in FP_CASES if label in FP_TIMED}
    for path, arch in FP_PUSHES.items():
        shapes = push_shapes(arch)
        missing = [s for s in shapes if s not in timed]
        check(not missing, f"fingerprint: {path}'s push shapes {missing} "
              "are not timed")
        rows = [(by_shape[timed[s]], n) for s, n in shapes.items()]
        total = {k: sum(r[k] * n for r, n in rows)
                 for k in ("ms", "plain_ms", "bound_ms")}
        by_shape[path] = dict(launches=sum(shapes.values()),
                              shapes={timed[s]: n for s, n in shapes.items()},
                              **total)
        print(f"[kernels] fingerprint_lanes {path} push: "
              f"{sum(shapes.values())} launches over {len(shapes)} shapes, "
              f"{total['ms']:.3f} ms of calls, {total['plain_ms']:.3f} ms "
              f"plain, bound {total['bound_ms']:.3f} ms")
    # a real float32 leaf through the registry's path, both devices
    leaf = torch.randn((4, 1, 2048, 4, 32), generator=gen, device="cuda")
    on_card = ops.chunk_fingerprint(leaf, 4 * 1024 * 1024)
    on_host = ops.chunk_fingerprint(leaf.cpu(), 4 * 1024 * 1024)
    check(torch.equal(on_card.cpu(), on_host),
          "chunk_fingerprint: card and host differ")
    main = by_shape["fold"]
    return dict(name="fingerprint_lanes", route="cuda",
                source="src/repro_torch/csrc/fingerprint.cu",
                replaces="src/repro/kernels/fingerprint.py:87",
                max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, by_shape=by_shape)


FLASH_CASES = [  # (label, B, Sq, Sk, H, Hkv, D, dtype, causal, window)
    ("smollm-train", 8, 128, 128, 15, 5, 64, torch.bfloat16, True, 0),
    ("paper-train", 8, 128, 128, 8, 4, 32, torch.float32, True, 0),
    ("smollm-prefill", 8, 32, 32, 15, 5, 64, torch.bfloat16, True, 0),
    # tests/test_kernels.py's sweep
    *[(f"sweep-{B}x{S}x{H}x{Hkv}x{D}-w{w}", B, S, S, H, Hkv, D, dt, True, w)
      for B, S, H, Hkv, D in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                              (1, 256, 4, 1, 128), (2, 128, 6, 3, 32)]
      for dt in (torch.float32, torch.bfloat16) for w in (0, 64)],
    # rows 64..127 walk kv tile 0 first, and for rows >= 103 every key of
    # that tile lies outside the window
    ("first-tile-masked", 2, 256, 256, 4, 2, 64, torch.float32, True, 40),
    ("first-tile-masked-bf16", 2, 256, 256, 4, 2, 64, torch.bfloat16, True,
     40),
    ("ragged", 2, 100, 100, 6, 2, 48, torch.float32, True, 0),
    ("no-valid-key", 2, 128, 48, 4, 2, 16, torch.float32, True, 16),
    ("no-mask", 2, 96, 96, 4, 4, 32, torch.float32, False, 0),
    # recurrentgemma_2b's local layers (MQA, g = 10, D = 256, window
    # 2048): launch.serve's prefill, and a 2304-token prompt where the
    # window bites
    ("rg-prefill", 8, 32, 32, 10, 1, 256, torch.bfloat16, True, 2048),
    ("rg-long-prefill", 2, 2304, 2304, 10, 1, 256, torch.bfloat16, True,
     2048),
    ("d256-f32-window", 2, 100, 100, 10, 1, 256, torch.float32, True, 40),
    ("d256-f32-no-valid-key", 2, 72, 40, 4, 2, 256, torch.float32, True, 16),
    ("d200-ragged", 1, 77, 77, 3, 1, 200, torch.float32, True, 0),
    # the dense family's prefills: codeqwen1_5_7b (MHA, D 128 as two
    # 64-column boxes), chatglm3_6b (32 heads over 2), gemma3_4b's local
    # layers (window 1024) at launch.serve's 8 x 32 and at a 1152-token
    # prompt where the window bites, and its global layers there
    ("cq-prefill", 8, 32, 32, 32, 32, 128, torch.bfloat16, True, 0),
    ("glm-prefill", 8, 32, 32, 32, 2, 128, torch.bfloat16, True, 0),
    ("g3-prefill", 8, 32, 32, 8, 4, 256, torch.bfloat16, True, 1024),
    ("g3-long-prefill", 2, 1152, 1152, 8, 4, 256, torch.bfloat16, True,
     1024),
    ("g3-long-global", 2, 1152, 1152, 8, 4, 256, torch.bfloat16, True, 0),
    # granite_moe_1b_a400m's launch.serve prefill (16 heads over 8, D 64)
    ("gm-prefill", 8, 32, 32, 16, 8, 64, torch.bfloat16, True, 0),
    # whisper_large_v3 at launch.serve's shapes (MHA, 20 heads, D 64): the
    # encoder over 1500 frames (non-causal; 1500 = 23 * 64 + 28, a ragged
    # last kv tile), the decoder's cross-attention over them in the
    # prefill (Sq 32) and in every decode step (Sq 1), and the decoder's
    # causal self-attention; serve-qwen2vl-4l's 288-token prefill (64
    # heads over 8, D 128)
    ("wh-encoder", 8, 1500, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    ("wh-cross", 8, 32, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    ("wh-cross-decode", 8, 1, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    ("wh-self", 8, 32, 32, 20, 20, 64, torch.bfloat16, True, 0),
    ("qvl-prefill", 8, 288, 288, 64, 8, 128, torch.bfloat16, True, 0),
    # train-whisper's 8 x 128 decoder: causal self-attention, and the
    # cross-attention over the 1500 frames (its encoder calls are
    # wh-encoder's shape)
    ("wh-train-self", 8, 128, 128, 20, 20, 64, torch.bfloat16, True, 0),
    ("wh-train-cross", 8, 128, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    # train-rg's local layers at 8 x 128 (the window does not bite),
    # train-granite's 16 heads over 8, and remat-rg's float32 [2, 32]
    ("rg-train", 8, 128, 128, 10, 1, 256, torch.bfloat16, True, 2048),
    ("gm-train", 8, 128, 128, 16, 8, 64, torch.bfloat16, True, 0),
    ("rg-remat-f32", 2, 32, 32, 10, 1, 256, torch.float32, True, 2048),
    # torch_quickstart.py's train steps: the smoke smollm_360m, float32,
    # 8 x 64, 3 heads over 1 of D 20, and its trainer example's, 4 x 64
    ("qs-train", 8, 64, 64, 3, 1, 20, torch.float32, True, 0),
    ("ex-trainer-train", 4, 64, 64, 3, 1, 20, torch.float32, True, 0),
    # whisper_large_v3's float32 gradient gate: the encoder over 1500
    # frames of a [2, 1500] batch (the largest float32 call of the script)
    ("wh-gate-f32-encoder", 2, 1500, 1500, 20, 20, 64, torch.float32, False,
     0),
]
FLASH_TIMED = ("smollm-train", "paper-train", "rg-prefill", "rg-long-prefill",
               "cq-prefill", "glm-prefill", "g3-prefill", "g3-long-prefill",
               "gm-prefill", "wh-encoder", "wh-cross", "wh-cross-decode",
               "wh-self", "qvl-prefill", "wh-train-self", "wh-train-cross",
               "rg-train", "gm-train", "rg-remat-f32", "qs-train",
               "ex-trainer-train", "wh-gate-f32-encoder")


def flash_work(q, k, causal: bool, window: int):
    """(bytes, operations) of one call: q, k, v read once, o written once;
    4 * D operations (two multiply-adds) per (query, kept key) pair."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= qp >= kp
    if window:
        keep &= qp - kp < window
    nbytes = 2 * q.nbytes + 2 * k.nbytes
    return nbytes, 4 * B * H * D * int(keep.sum())


def sdpa_mask(Sq, Sk, causal: bool, window: int):
    """The boolean mask ``F.scaled_dot_product_attention`` needs for the
    plain version's causal and window masks (None where none bites)."""
    qp = torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        keep &= qp >= kp
    if window:
        keep &= qp - kp < window
    return keep


def attention64(q, k, v, causal: bool, window: int):
    """The plain version's function in float64 (the drift's yardstick),
    with its float32 scale and its finite NEG_INF."""
    from repro_torch.kernels import ref

    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, Sq, Hkv, H // Hkv, D) * ref.attn_scale(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    s = s.masked_fill(~sdpa_mask(Sq, Sk, causal, window), ref.NEG_INF)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, D)


def drift(got, want) -> float:
    """sum((got - want) * want) / sum(want * want): a bias along want."""
    got, want = got.double(), want.double()
    return float(((got - want) * want).sum() / (want * want).sum())


def flash_kernel(gen):
    """``fa.flash_f32_plan`` equal to the launch code's plan at every D;
    the flash kernel against its plain version at every case, on the
    route ``fa.route`` names (its counter moves by the case's two
    launches), two launches bit-equal; times at ``FLASH_TIMED``'s shapes,
    the first of them the table's row; at each float32 timed shape the
    kernel's drift against a float64 version must be within
    ``FLASH_DRIFT``, and the plain version with TF32 products (the
    control) must miss ``FLASH_TOL``: the check can tell TF32 from a
    sound kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    bad = [D for D in range(1, fa.MAX_HEAD_DIM + 1)
           if fa.launch_f32_plan(D) != fa.flash_f32_plan(D)]
    check(not bad, f"flash: flash_f32_plan differs from the tf32x3 launch "
          f"code's plan at D {bad}")
    row = None
    by_shape = {}
    for label, B, Sq, Sk, H, Hkv, D, dtype, causal, window in FLASH_CASES:
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
        before = fa.WGMMA_LAUNCHES, fa.TF32X3_LAUNCHES
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.naive_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL if dtype == torch.float32 else FLASH_TOL_BF16
        err = (got.float() - want.float()).abs().max().item()
        route = fa.route(dtype, D)
        print(f"[kernels] flash_attention {label} q[{B},{Sq},{H},{D}] "
              f"k[{B},{Sk},{Hkv},{D}] {str(dtype)[6:]} causal={causal} "
              f"window={window} route={route}: max_abs_err={err:.3e}")
        moved = (fa.WGMMA_LAUNCHES - before[0], fa.TF32X3_LAUNCHES - before[1])
        check(moved == ((2, 0) if route == "wgmma" else (0, 2)),
              f"flash {label}: want both launches on the {route} route, "
              f"the (wgmma, tf32x3) counters moved by {moved}")
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"flash {label}: kernel disagrees with the plain version "
              f"({err:.3e}, tolerance {tol})")
        check(torch.equal(got, again), f"flash {label}: two launches differ")
        if label not in FLASH_TIMED:
            continue
        # a 2304-token call takes milliseconds: fewer calls per graph
        reps = 50 if Sq <= 128 else 5
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                 window=window), reps=reps)
        kernel_us = kernel_entry(
            f"flash_attention {label}",
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            f"flash_{route}_kernel", calls=20 if Sq <= 128 else 5)
        plain_ms = graph_ms(lambda: ref.naive_attention(
            q, k, v, causal=causal, window=window), reps=reps)
        extra = {}
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = ref.naive_attention(q, k, v, causal=causal,
                                           window=window)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32_err = (tf32 - want).abs().max().item()
            want64 = attention64(q, k, v, causal, window)
            drifts = (drift(got, want64), drift(want, want64))
            print(f"[kernels] flash_attention {label}: control (the plain "
                  f"version, TF32 products) max_abs_err={tf32_err:.3e}; "
                  f"drift against float64 {drifts[0]:.2e} (the plain "
                  f"version's {drifts[1]:.2e})")
            check(abs(drifts[0]) <= FLASH_DRIFT,
                  f"flash {label}: the output drifts by {drifts[0]:.2e} "
                  f"against float64 (FLASH_DRIFT {FLASH_DRIFT:.0e})")
            extra["drift"] = drifts[0]
            check(not torch.allclose(tf32, want, **FLASH_TOL),
                  f"flash {label}: the TF32 control passes FLASH_TOL "
                  f"({tf32_err:.3e}); the check cannot see TF32")
            extra["tf32_control_err"] = tf32_err
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if window and window < Sk:
            lib_kw = dict(attn_mask=sdpa_mask(Sq, Sk, causal, window))
        else:
            lib_kw = dict(is_causal=causal)
        lib = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                             **lib_kw).transpose(1, 2)
        # the yardstick must compute the same function; its own internal
        # precision is the library's business, hence the loose bound
        check(torch.allclose(lib.float(), want.float(), **FLASH_TOL_BF16),
              f"SDPA yardstick disagrees with the plain flash version "
              f"({label})")
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True, **lib_kw), reps=reps)
        nbytes, ops_n = flash_work(q, k, causal, window)
        peak = PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S
        b_ms, b_by = bound(nbytes, ops_n, peak)
        note = ""
        if route == "tf32x3":
            # the route's own floor: three TF32 products on the tensor cores
            extra["bound_tf32x3_ms"], by = bound(nbytes, ops_n,
                                                 PEAK_TF32X3_OPS_S)
            note = (f", {extra['bound_tf32x3_ms'] * 1e3:.3f} us on the "
                    f"tensor cores at 3 x TF32 ({by})")
        print(f"[kernels] flash_attention {label}: {ms * 1e3:.2f} us a call "
              f"({kernel_us:.2f} us the kernel alone, route {route}), "
              f"{plain_ms * 1e3:.2f} us plain, {library_ms * 1e3:.2f} us "
              f"SDPA, bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes, "
              f"{ops_n} operations){note}")
        by_shape[label] = dict(shape=[B, Sq, Sk, H, Hkv, D], route=route,
                               max_abs_err=err, ms=ms, kernel_us=kernel_us,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library_ms, **extra)
        if row is None:
            row = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:102",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)
    row["by_shape"] = by_shape
    return row


def flash_ragged_isolation(gen) -> None:
    """Non-causal over 1500 keys (a last kv tile of 28 keys, whose box runs
    past the batch row's end): batch row 1's V holds 1e30, and batch row
    0's output at Sq 32 and Sq 1 must be finite and bit-equal to row 0 run
    alone (masked keys add exactly 0, nothing of row 1 is read)."""
    from repro_torch.kernels import flash_attention as fa

    for Sq in (32, 1):
        q = torch.randn((2, Sq, 20, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((2, 1500, 20, 64), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        v[1] = 1e30
        got = fa.flash_attention(q, k, v, causal=False)
        alone = fa.flash_attention(q[:1].contiguous(), k[:1].contiguous(),
                                   v[:1].contiguous(), causal=False)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"flash ragged tile Sq {Sq}: non-finite output")
        check(torch.equal(got[:1], alone), f"flash ragged tile Sq {Sq}: "
              "batch row 0 moves with batch row 1's values")
        print(f"[kernels] flash_attention ragged tile q[2,{Sq},20,64] over "
              f"k[2,1500,20,64], row 1's V at 1e30: row 0 finite and "
              f"bit-equal to row 0 alone")


RGLRU_CASES = [  # (label, B, S, W, dtype, h0: None, "zeros" or "random")
    # launch.serve's prefill (a fresh cache's h is a zero tensor), and the
    # 2304-token prompt
    ("rg-serve", 8, 32, 2560, torch.bfloat16, "zeros"),
    ("rg-long", 2, 2304, 2560, torch.bfloat16, "zeros"),
    # train-rg's forward: 8 x 128 from a fresh state (no h0)
    ("rg-train", 8, 128, 2560, torch.bfloat16, None),
    # tests/test_kernels.py's shapes
    *[(f"sweep-{B}x{S}x{W}", B, S, W, dt, None)
      for B, S, W in [(1, 64, 128), (2, 128, 256), (1, 96, 512)]
      for dt in (torch.float32, torch.bfloat16)],
    ("h0", 2, 128, 256, torch.float32, "random"),
    ("h0-bf16", 2, 128, 256, torch.bfloat16, "random"),
    ("one-step", 3, 1, 2560, torch.bfloat16, "random"),
    ("ragged-width", 2, 33, 70, torch.float32, "random"),
    # a_t = 0.95..1.0 (a_param drawn near +6), where a state carried across
    # chunks keeps its rounding longest; a large h0; the long prompt's chunk
    # of 56 steps (rglru.scan_plan) ending one step before and after S
    ("slow-decay", 2, 2304, 2560, torch.float32, "random"),
    ("slow-decay-bf16", 2, 2304, 2560, torch.bfloat16, "random"),
    ("h0-large", 2, 2304, 2560, torch.float32, "large"),
    ("slow-decay-h0-large", 2, 2304, 2560, torch.float32, "large"),
    ("chunk-boundary+1", 2, 56 * 40 + 1, 2560, torch.float32, "random"),
    ("chunk-boundary-1", 2, 56 * 40 - 1, 2560, torch.bfloat16, "random"),
]
RGLRU_TIMED = ("rg-serve", "rg-long", "rg-train")
RGLRU_TOL = dict(rtol=1e-5, atol=1e-6)        # float32 state, libm ulps
RGLRU_TOL_BF16 = dict(rtol=8e-3, atol=1e-6)   # one bf16 rounding of h_seq
# operations per (b, t, w): two sigmoids, log_at, two exps, 1 - e, max,
# sqrt, two products for gated, then a product and a sum for h (the
# log_sigmoid of a_param is per w); about 20 counting a sigmoid as 3
RGLRU_OPS_PER_ELEMENT = 20


def rglru_kernel(gen):
    """The RG-LRU kernel against its plain version at every case (both
    outputs), two launches bit-equal, the autograd gradient equal to the
    plain version's; times at ``RGLRU_TIMED``, the first the row's."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru as rg

    row, by_shape, bit_equal = None, {}, []
    for label, B, S, W, dtype, h0 in RGLRU_CASES:
        x, ga, gx = (torch.randn((B, S, W), generator=gen, device="cuda")
                     .to(dtype) for _ in range(3))
        a = torch.randn((W,), generator=gen, device="cuda")
        if label.startswith("slow-decay") or label.startswith("chunk"):
            a = 6.0 + 0.5 * a
        h = {None: None,
             "zeros": torch.zeros((B, W), device="cuda"),
             "random": torch.randn((B, W), generator=gen, device="cuda"),
             "large": 100 * torch.randn((B, W), generator=gen,
                                        device="cuda")}[h0]
        got = rg.rglru(x, a, ga, gx, h)
        again = rg.rglru(x, a, ga, gx, h)
        want = ref.naive_rglru(x, a, ga, gx, h)
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        if all(torch.equal(g, w) for g, w in zip(got, want)):
            bit_equal.append(label)
        print(f"[kernels] rglru {label} [{B},{S},{W}] {str(dtype)[6:]} "
              f"h0={h0} plan={tuple(rg.scan_plan(B, S, W))}: "
              f"max_abs_err={err:.3e}")
        check(got[0].dtype == dtype and got[1].dtype == torch.float32,
              f"rglru {label}: output dtypes {got[0].dtype}, {got[1].dtype}")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"rglru {label}: non-finite")
        tol = RGLRU_TOL if dtype == torch.float32 else RGLRU_TOL_BF16
        check(torch.allclose(got[0].float(), want[0].float(), **tol)
              and torch.allclose(got[1], want[1], **RGLRU_TOL),
              f"rglru {label}: kernel disagrees with the plain version "
              f"({err:.3e}, tolerance {tol})")
        check(all(torch.equal(g, w) for g, w in zip(got, again)),
              f"rglru {label}: two launches differ")
        if label not in RGLRU_TIMED:
            continue
        # the plain version is a Python loop of S steps: one call a graph
        # at the long prompt
        reps = 50 if S <= 32 else 1
        ms = graph_ms(lambda: rg.rglru(x, a, ga, gx, h))
        plain_ms = graph_ms(lambda: ref.naive_rglru(x, a, ga, gx, h),
                            reps=reps, graphs=5 if S <= 32 else 2)
        nbytes = (4 * x.nbytes + a.nbytes + 2 * B * W * 4)  # h0 and h_last
        b_ms, b_by = bound(nbytes, RGLRU_OPS_PER_ELEMENT * B * S * W)
        print(f"[kernels] rglru {label}: {ms * 1e3:.2f} us kernel, "
              f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
              f"({b_by}, {nbytes} bytes)")
        by_shape[label] = dict(shape=[B, S, W],
                               plan=list(rg.scan_plan(B, S, W)),
                               max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
        if row is None:
            row = dict(name="rglru", route="cuda",
                       source="src/repro_torch/csrc/rglru.cu",
                       replaces="src/repro/kernels/rglru.py:63",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the gradient: RGLRUScan's backward is the plain version's autograd
    x, ga, gx = (torch.randn((2, 40, 96), generator=gen, device="cuda")
                 for _ in range(3))
    a, h = (torch.randn(s, generator=gen, device="cuda") for s in ((96,),
                                                                   (2, 96)))
    wy = [torch.randn((2, 40, 96), generator=gen, device="cuda"),
          torch.randn((2, 96), generator=gen, device="cuda")]
    grads = []
    for fn in (ops.rglru_scan, ref.naive_rglru):
        leaves = [t.clone().requires_grad_() for t in (x, a, ga, gx, h)]
        out = fn(*leaves)
        sum((o * w).sum() for o, w in zip(out, wy)).backward()
        grads.append([t.grad for t in leaves])
    check(all(torch.equal(p, q) for p, q in zip(*grads)),
          "rglru: the kernel's autograd gradients differ from the plain "
          "version's")
    print("[kernels] rglru autograd: gradients bit-equal to the plain "
          "version's")
    print(f"[kernels] rglru: bit-equal to the plain version at "
          f"{len(bit_equal)} of {len(RGLRU_CASES)} cases ({bit_equal})")
    row["by_shape"] = by_shape
    row["bit_equal_cases"] = len(bit_equal)
    return row


SLSTM_CASES = [  # (label, B, S, H, hb, dtype)
    # launch.train's shape: xlstm_350m, batch 8 x 128, d_model 1024, 4 heads
    ("xl-train", 8, 128, 4, 256, torch.bfloat16),
    ("xl-train-f32", 8, 128, 4, 256, torch.float32),
    # tests/test_kernels.py's shapes
    *[(f"sweep-{B}x{S}x{H}x{hb}", B, S, H, hb, dt)
      for B, S, H, hb in [(1, 32, 2, 16), (2, 64, 4, 32)]
      for dt in (torch.float32, torch.bfloat16)],
    ("ragged", 3, 7, 3, 40, torch.float32),  # hb not a multiple of 32
    # batch groups that do not divide, one head, and hb 512, whose r slice
    # does not fit a cluster's shared memory (the L2 route)
    ("b3", 3, 128, 4, 256, torch.bfloat16),
    ("b5", 5, 64, 4, 256, torch.float32),
    ("b1", 1, 128, 4, 256, torch.bfloat16),
    ("h1", 8, 64, 1, 256, torch.float32),
    ("hb512-l2", 2, 32, 2, 512, torch.float32),
]
SLSTM_TOL = dict(rtol=1e-5, atol=1e-5)       # float32, dot-product order
SLSTM_TOL_BF16 = dict(rtol=8e-3, atol=1e-5)  # one bf16 rounding of h_seq
# operations per (b, t, w) besides the four matvecs (2 * 4 * hb): the
# gate sums, the stabilizer, three exps, tanh, sigmoid, the c / n / h
# updates and a division, about 25
SLSTM_OPS_PER_ELEMENT = 25
MLSTM_CASES = [  # (label, B, S, H, D, chunk, dtype)
    # launch.train's shape (one chunk of 128), and four chunks
    ("xl-train", 8, 128, 4, 512, 128, torch.bfloat16),
    ("xl-train-f32", 8, 128, 4, 512, 128, torch.float32),
    ("xl-4chunks", 2, 512, 4, 512, 128, torch.bfloat16),
    ("xl-4chunks-f32", 2, 512, 4, 512, 128, torch.float32),
    # tests/test_kernels.py's shapes and chunks
    *[(f"sweep-{B}x{S}x{H}x{D}-c{ch}", B, S, H, D, ch, dt)
      for B, S, H, D in [(1, 64, 2, 32), (2, 128, 4, 64)]
      for ch in (32, 64) for dt in (torch.float32, torch.bfloat16)],
    ("ragged", 2, 12, 3, 40, 4, torch.float32),  # D not a multiple of 32
    # the wgmma route's edges: a chunk of 100 over two row tiles, D 320
    # (column slices of 2 + 2 + 1 boxes, the state pass's of 3 + 2)
    ("wg-chunk100", 2, 200, 2, 64, 100, torch.bfloat16),
    ("wg-d320", 2, 128, 3, 320, 64, torch.bfloat16),
]
# max |kernel - plain| over max |plain|: float32 sums over D and over the
# chunk in another order, divided by a denominator that cancels (h reaches
# ~70 with |v| ~ 1); bf16 output rounding, under one ulp of the largest
# (on the wgmma route also S, C and w o V as bf16 hi + lo: about 4e-6,
# tests/test_torch_mlstm_plan.py)
MLSTM_REL = {torch.float32: 5e-5, torch.bfloat16: 8e-3}
TIMED_XL = ("xl-train", "xl-4chunks")


def _two_launches(fn, plain, label, name, tol=None, rel=None):
    """``fn()`` twice against ``plain()``: finite, in the input's dtype,
    within ``tol`` (allclose) or ``rel`` (of the largest |plain|), and
    bit-equal between the launches.  -> max abs error."""
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {label}: {got.dtype} {tuple(got.shape)}, plain "
          f"{want.dtype} {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
    ok = (torch.allclose(got.float(), want.float(), **tol) if tol else
          err <= rel * want.float().abs().max().item())
    check(ok, f"{name} {label}: kernel disagrees with the plain version "
          f"({err:.3e}, tolerance {tol or rel})")
    check(torch.equal(got, again), f"{name} {label}: two launches differ")
    return err


def _grads_equal(name, apply, plain, inputs, weight):
    """The kernel's autograd gradients bit-equal to the plain version's."""
    grads = []
    for fn in (apply, plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        (fn(*leaves) * weight).sum().backward()
        grads.append([t.grad for t in leaves])
    check(all(torch.equal(p, q) for p, q in zip(*grads)),
          f"{name}: the kernel's autograd gradients differ from the plain "
          "version's")
    print(f"[kernels] {name} autograd: gradients bit-equal to the plain "
          "version's")


def slstm_kernel(gen):
    """The sLSTM kernel against its plain version (``ref.naive_slstm``
    from a fresh state) at every case, two launches bit-equal, the
    autograd gradients equal to the plain version's; times at the train
    shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as sl

    row = None
    for label, B, S, H, hb, dtype in SLSTM_CASES:
        W = H * hb
        xs = [torch.randn((B, S, W), generator=gen, device="cuda").to(dtype)
              for _ in range(4)]
        # the model's scale for r (0.02) at hb 256; 0.2 at the sweep's
        rs = [torch.randn((H, hb, hb), generator=gen, device="cuda")
              * (0.02 if hb >= 256 else 0.2) for _ in range(4)]
        tol = SLSTM_TOL if dtype == torch.float32 else SLSTM_TOL_BF16
        plan = sl.slstm_plan(B, H, hb)
        before = sl.CLUSTER_LAUNCHES
        err = _two_launches(lambda: sl.slstm(*xs, *rs),
                            lambda: ref.naive_slstm(*xs, *rs)[0], label,
                            "slstm", tol=tol)
        on_cluster = sl.CLUSTER_LAUNCHES - before
        check(on_cluster == (2 if plan.route == "cluster" else 0),
              f"slstm {label}: {on_cluster} of 2 launches on the cluster "
              f"route, plan {plan}")
        check((label != "hb512-l2" or plan.route == "l2")
              and (not label.startswith("xl-train")
                   or plan.route == "cluster"),
              f"slstm {label}: plan {plan}")
        print(f"[kernels] slstm {label} [{B},{S},{W}] H={H} "
              f"{str(dtype)[6:]} plan={tuple(plan)}: max_abs_err={err:.3e}")
        if label.startswith("xl-train"):
            # both routes share their arithmetic: the same bits
            l2 = sl.slstm(*xs, *rs, plan=sl.SLSTMPlan("l2", 0, hb, 1))
            check(torch.equal(l2, sl.slstm(*xs, *rs)),
                  f"slstm {label}: the L2 route's bits differ from the "
                  "cluster route's")
            print(f"[kernels] slstm {label}: the L2 route gives the cluster "
                  "route's bits")
        if label != "xl-train":
            continue
        ms = graph_ms(lambda: sl.slstm(*xs, *rs))
        # the plain version is a Python loop of S steps: one call a graph
        plain_ms = graph_ms(lambda: ref.naive_slstm(*xs, *rs), reps=1,
                            graphs=2)
        nbytes = 5 * xs[0].nbytes + sum(r.nbytes for r in rs)
        ops = B * S * W * (8 * hb + SLSTM_OPS_PER_ELEMENT)
        b_ms, b_by = bound(nbytes, ops)
        print(f"[kernels] slstm {label}: {ms * 1e3:.2f} us kernel, "
              f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
              f"({b_by}, {nbytes} bytes, {ops} operations)")
        row = dict(name="slstm", route="cuda",
                   source="src/repro_torch/csrc/slstm.cu",
                   replaces="src/repro/kernels/slstm.py:71",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None,
                   by_shape={label: dict(shape=[B, S, W, H], plan=list(plan),
                                         max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=None)})
    xs = [torch.randn((2, 20, 64), generator=gen, device="cuda")
          for _ in range(4)]
    rs = [torch.randn((2, 32, 32), generator=gen, device="cuda") * 0.2
          for _ in range(4)]
    _grads_equal("slstm", sl.SLSTMScan.apply,
                 lambda *a: ref.naive_slstm(*a)[0], xs + rs,
                 torch.randn((2, 20, 64), generator=gen, device="cuda"))
    return row


def mlstm_ops(B, S, H, D, T) -> int:
    """Operations the chunkwise mLSTM needs on these shapes: per chunk the
    kept (t, j <= t) pairs of q.k and S.v (4 D each, and 4 for the decay
    weight), then per chunk after the first q C^T and q.n, and per chunk
    before the last the C and n update (2 T D (D + 1) each)."""
    nc = S // T
    pairs = T * (T + 1) // 2
    carry = 2 * T * D * (D + 1)
    return B * H * (nc * pairs * (4 * D + 4) + 2 * (nc - 1) * carry)


def mlstm_kernel(gen):
    """The mLSTM kernels against their plain version
    (``ref.chunkwise_mlstm``) at every case, each on the route its (dtype,
    D) picks (bf16 with D % 64 == 0 on the wgmma route, counted in
    ``WGMMA_LAUNCHES``), two launches bit-equal, the autograd gradients
    equal to the plain version's on both routes; times at the train shape
    and over four chunks, with the wgmma route's plan held against the
    one the library computes."""
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import ref

    row, by_shape = None, {}
    for label, B, S, H, D, ch, dtype in MLSTM_CASES:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        ig = torch.randn((B, S, H), generator=gen, device="cuda")
        fg = torch.randn((B, S, H), generator=gen, device="cuda") + 3.0
        route = ml.route(dtype, D)
        before = ml.WGMMA_LAUNCHES
        err = _two_launches(
            lambda: ml.mlstm(q, k, v, ig, fg, chunk=ch),
            lambda: ref.chunkwise_mlstm(q, k, v, ig, fg, chunk=ch), label,
            "mlstm", rel=MLSTM_REL[dtype])
        on_wgmma = ml.WGMMA_LAUNCHES - before
        check(on_wgmma == (2 if route == "wgmma" else 0)
              and (route == "wgmma") == (dtype == torch.bfloat16
                                         and D % 64 == 0),
              f"mlstm {label}: {on_wgmma} of 2 launches on the wgmma "
              f"route, route {route}")
        rel = err / ref.chunkwise_mlstm(q, k, v, ig, fg, chunk=ch).float(
        ).abs().max().item()
        print(f"[kernels] mlstm {label} [{B},{S},{H},{D}] chunk {ch} "
              f"{str(dtype)[6:]} route={route}: max_abs_err={err:.3e} "
              f"(of the largest |h|: {rel:.3e}, limit {MLSTM_REL[dtype]})")
        if route == "wgmma":
            plan = ml.mlstm_plan(B, S, H, D, min(ch, S))
            check(ml.native_plan(B, S, H, D, min(ch, S)) == plan,
                  f"mlstm {label}: the library's plan differs from "
                  f"mlstm_plan {plan}")
        if label not in TIMED_XL:
            continue
        ms = graph_ms(lambda: ml.mlstm(q, k, v, ig, fg, chunk=ch))
        entries = device_entries(lambda: ml.mlstm(q, k, v, ig, fg, chunk=ch))
        print(f"[kernels] mlstm {label} device entries per call: " + "; ".join(
            f"{n[:60]} x{c:g} {us:.2f} us" for n, c, us in entries))
        plain_ms = graph_ms(
            lambda: ref.chunkwise_mlstm(q, k, v, ig, fg, chunk=ch))
        nbytes = 4 * q.nbytes + ig.nbytes + fg.nbytes
        ops = mlstm_ops(B, S, H, D, ch)
        b_ms, b_by = bound(nbytes, ops, PEAK_BF16_OPS_S if route == "wgmma"
                           else PEAK_F32_OPS_S)
        print(f"[kernels] mlstm {label}: {ms * 1e3:.2f} us a call (route "
              f"{route}, plan {tuple(ml.mlstm_plan(B, S, H, D, ch))}), "
              f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
              f"({b_by}, {nbytes} bytes, {ops} operations)")
        by_shape[label] = dict(shape=[B, S, H, D], chunk=ch, route=route,
                               max_abs_err=err, ms=ms,
                               kernel_us=sum(us for _, _, us in entries),
                               device_entries=sum(c for _, c, _ in entries),
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
        if row is None:
            row = dict(name="mlstm", route="cuda",
                       source="src/repro_torch/csrc/mlstm.cu",
                       replaces="src/repro/kernels/mlstm.py:100",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for shape, ch, dtype in (((2, 48, 2, 40), 16, torch.float32),
                             ((2, 128, 2, 64), 64, torch.bfloat16)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        ig = torch.randn(shape[:3], generator=gen, device="cuda")
        fg = torch.randn(shape[:3], generator=gen, device="cuda") + 3.0
        _grads_equal(f"mlstm {ml.route(dtype, shape[3])} route",
                     lambda *a, ch=ch: ml.MLSTMScan.apply(*a, ch),
                     lambda *a, ch=ch: ref.chunkwise_mlstm(*a, chunk=ch),
                     [q, k, v, ig, fg],
                     torch.randn(shape, generator=gen, device="cuda"))
    row["by_shape"] = by_shape
    return row


def decode_empty_row(gen) -> None:
    """A batch row with no valid slot: the mean of V, as the plain version;
    the other rows keep the bits they have with a valid slot."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    for dtype, tol in ((torch.float32, DECODE_TOL),
                       (torch.bfloat16, DECODE_TOL_BF16)):
        q, k, v, qp, kp = decode_inputs(gen, 3, 2048, 8, 4, 32, dtype, False)
        before = da.decode_attention(q, k, v, qp, kp)
        kp[1] = -1
        got = da.decode_attention(q, k, v, qp, kp)
        again = da.decode_attention(q, k, v, qp, kp)
        want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[kernels] decode_attention empty row {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e}")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"decode empty row: kernel disagrees with the plain version "
              f"({err:.3e}, tolerance {tol})")
        check(torch.equal(got, again), "decode empty row: launches differ")
        check(torch.equal(got[0], before[0]) and torch.equal(got[2], before[2]),
              "decode empty row: the rows with valid slots changed")


def _kv_leaf(cache):
    """The largest float32 leaf of a KV cache (the K or V tensor)."""
    from repro_torch.tree import leaves

    return max((t for t in leaves(cache) if t.dtype == torch.float32),
               key=lambda t: t.numel())


def codec_inputs():
    """(label, cur words, parent words, chunk bytes, leaf, parent bytes)
    on the card: the fold's real KV leaf against its parent (16 more
    decoded tokens: a dirty stripe), the serving engine's leaf on its
    slot-aligned chunk grid, the paper-consumer trainer's embedding table
    against its parent two AdamW steps earlier on the trainer pre-copy's
    64 KiB grid (words [C, 128, 128]), then every float32 leaf of that
    trainer's params and AdamW moments the same way (labels
    ``trainer-leaf-k``; no chunk bytes: their blobs are not re-encoded),
    a ragged odd-row shape and the edge values."""
    from repro_torch import configs
    from repro_torch.broker.broker import Message
    from repro_torch.checkpoint.codecs import leaf_raw
    from repro_torch.checkpoint.registry import CHUNK_BYTES
    from repro_torch.core.consumer import StatefulConsumer
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine, slot_aligned_chunk_bytes
    from repro_torch.serving.handoff import ServingWorker
    from repro_torch.tree import leaves

    cfg = configs.get_config("paper_consumer")
    params = T.init_lm(cfg, seed=0, device="cuda")
    consumer = StatefulConsumer(cfg, params, 2048)
    msgs = [Message(i, {"token": (7 * i + 3) % cfg.vocab_size}, 0.0)
            for i in range(112)]
    consumer.replay_sequential(msgs[:96])
    parent = _kv_leaf(consumer.state_tree()["cache"])
    consumer.replay_sequential(msgs[96:])
    fold_leaf = _kv_leaf(consumer.cache).clone()

    worker = ServingWorker(ServingEngine(cfg, params, num_slots=8,
                                         max_seq=128), decode_rounds=1)
    reqs = [{"request_id": i, "prompt": [3 + i, 9], "max_new_tokens": 6}
            for i in range(12)]
    for i, p in enumerate(reqs[:8]):
        worker.process(Message(i, p, 0.0))
    s_parent = _kv_leaf(worker.state_tree()["cache"])
    for i, p in enumerate(reqs[8:], start=8):
        worker.process(Message(i, p, 0.0))
    s_leaf = _kv_leaf(worker.engine.cache).clone()
    s_chunk = slot_aligned_chunk_bytes(worker)
    print(f"[kernels] serving engine (8 slots, max_seq 128): "
          f"slot_aligned_chunk_bytes={s_chunk}")

    trainer = trainer_factory("cuda")()
    for i in range(6):
        if i == 4:
            t_parent = trainer.state_tree()
        trainer.process(Message(i, {"batch_id": i}, 0.0))
    t_state = trainer.state_tree()
    t_leaves = [(cur, par) for cur, par in zip(
        leaves({"params": t_state["params"], "opt": t_state["opt"]}),
        leaves({"params": t_parent["params"], "opt": t_parent["opt"]}))
        if cur.dtype == torch.float32]
    print(f"[kernels] trainer state: {len(t_leaves)} float32 leaves")
    t_leaf = t_state["params"]["embed"]["table"]
    t_par = t_parent["params"]["embed"]["table"]

    out = []
    for label, leaf, par, cb in (("fold", fold_leaf, parent, CHUNK_BYTES),
                                 ("serving", s_leaf, s_parent, s_chunk),
                                 ("trainer", t_leaf, t_par, 64 * 1024)):
        praw = leaf_raw(par)
        cw, pw = ops._codec_words(leaf, praw, cb)
        out.append((label, cw, pw, cb, leaf, praw))
    for k, (leaf, par) in enumerate(t_leaves):
        cw, pw = ops._codec_words(leaf, leaf_raw(par), 64 * 1024)
        out.append((f"trainer-leaf-{k}", cw, pw, None, None, None))
    gen = torch.Generator(device="cuda").manual_seed(2)
    cur = torch.randn((3, 77, 128), generator=gen, device="cuda")
    par = cur.clone()
    par[:, 20:29] += 1.0
    out.append(("ragged", cur.view(torch.int32), par.view(torch.int32),
                None, None, None))
    e_cur, e_par = ck.edge_blocks()
    out.append(("edge",
                torch.from_numpy(e_cur).view(torch.int32).reshape(1, -1, 128)
                .cuda(),
                torch.from_numpy(e_par).view(torch.int32).reshape(1, -1, 128)
                .cuda(), None, None, None))
    return out


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def codec_work(name: str, C: int, R: int):
    """(bytes, operations) a codec call must do at words [C, R, 128]: each
    input read once and each output written once (q as int8); per word a
    multiply and an add for the fingerprint, then the XOR, or subtract,
    abs, max, divide, round and two clamps."""
    words = C * R * 128
    lane_bytes = C * 128 * 4
    if name == "xor_fp_lanes":
        return 3 * words * 4 + lane_bytes, 3 * words
    qwords = C * -(-R // 2) * 256
    return 2 * words * 4 + qwords + (qwords // 256) * 4 + lane_bytes, \
        9 * qwords


def codec_kernels():
    """The fused fingerprint+XOR and fingerprint+int8 kernels, bit for bit
    against their plain versions (two launches equal) at every input of
    ``codec_inputs``, and the codec blobs of a CUDA leaf; at the fold, the
    serving grid and one leaf of every trainer leaf shape, a call's time,
    its device entries (one, the kernel, on the one-launch route) and the
    kernel's time alone, the plain version's time and the bound."""
    import numpy as np

    from repro_torch.checkpoint.codecs import (FusedLeafEncoding, get_codec,
                                               leaf_raw)
    from repro_torch.kernels import codec as ck

    inputs = codec_inputs()
    kernels = (("xor_fp_lanes", "xor", ck.xor_fp_lanes, ck.xor_fp_ref),
               ("int8_fp_lanes", "int8", ck.int8_fp_lanes, ck.int8_fp_ref))
    timed = {}
    for label, cw, pw, cb, leaf, praw in inputs:
        for name, _, fn, plain in kernels:
            got, again, want = fn(cw, pw), fn(cw, pw), plain(cw, pw)
            torch.cuda.synchronize()
            same = all(_same_bits(g, w) for g, w in zip(got, want))
            print(f"[kernels] {name} {label} {list(cw.shape)}: "
                  f"bit-identical={same}")
            check(same, f"{name} {label}: kernel differs from plain version")
            check(all(_same_bits(g, a) for g, a in zip(got, again)),
                  f"{name} {label}: two launches differ")
        shape = tuple(cw.shape)
        if label in ("fold", "serving"):
            timed[shape] = (label, cw, pw)
        elif label.startswith("trainer-leaf") and shape not in timed:
            timed[shape] = (f"trainer {list(shape)}", cw, pw)
        if leaf is None:
            continue
        dt = np.dtype(np.float32)
        raw = leaf_raw(leaf)
        for codec in ("xor_rle", "int8"):
            enc = FusedLeafEncoding(leaf, praw, codec, dt, cb)
            n = -(-len(raw) // cb)
            same = all(enc.blob(c) == get_codec(codec).encode(
                raw[c * cb:(c + 1) * cb], praw[c * cb:(c + 1) * cb], dt)
                for c in range(n))
            print(f"[kernels] FusedLeafEncoding {codec} {label}: {n} chunks, "
                  f"card blobs == host codec blobs: {same}")
            check(same, f"FusedLeafEncoding {codec} {label}: blobs differ")
    rows = {}
    for name, kind, fn, plain in kernels:
        by_shape = {}
        for shape, (label, cw, pw) in timed.items():
            C, R, _ = shape
            plan = ck.codec_plan(C, R, kind)
            ms = graph_ms(lambda: fn(cw, pw))
            want = 1 if plan.route == "cluster" else 2
            for _ in range(3):  # the profiler now and then drops an event
                entries = device_entries(lambda: fn(cw, pw))
                n_entries = sum(c for _, c, _ in entries)
                if n_entries == want:
                    break
            alone = sum(us for _, _, us in entries)
            print(f"[kernels] {name} {label} plan {tuple(plan)} device "
                  "entries per call: " + "; ".join(
                      f"{n[:60]} x{c:g} {us:.2f} us" for n, c, us in entries))
            check(any(f"{kind}_fp_kernel" in n for n, _, _ in entries)
                  and n_entries == want
                  and (want == 1 or any("fingerprint_lanes_kernel" in n
                                        for n, _, _ in entries)),
                  f"{name} {label}: want one device entry a call on the "
                  "cluster route, the kernel (the split route: and the "
                  f"fingerprint kernel); got {entries}")
            plain_ms = graph_ms(lambda: plain(cw, pw),
                                reps=50 if C * R <= 8192 else 5)
            nbytes, ops_n = codec_work(name, C, R)
            b_ms, b_by = bound(nbytes, ops_n)
            by_shape[label] = dict(
                shape=list(shape), plan=list(plan), max_abs_err=0.0, ms=ms,
                kernel_us=alone, device_entries=n_entries, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
            print(f"[kernels] {name} {label}: {ms * 1e3:.2f} us a call "
                  f"({alone:.2f} us alone, {n_entries:g} device entries), "
                  f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
                  f"({b_by}, {nbytes} bytes)")
        main = by_shape["fold"]
        rows[name] = dict(
            name=name, route="cuda", source="src/repro_torch/csrc/codec.cu",
            replaces=("src/repro/kernels/codec.py:101"
                      if name == "xor_fp_lanes"
                      else "src/repro/kernels/codec.py:175"),
            max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, by_shape=by_shape)
    return rows


def host_and_card(cfg, seed: int, label: str):
    """``init_lm(seed)`` drawn on the CPU, and a copy on the card; prints
    the seconds of both, and the draw's alone with its rate.  -> (params
    on the CPU, params on the card)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map

    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=seed, device="cpu")
    draw = time.perf_counter() - t0
    on_card = tree_map(lambda t: t.to("cuda"), params)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    print(f"[model] {label} seed {seed}: {cfg.num_layers} layers, init "
          f"{time.perf_counter() - t0:.1f} s (draw {draw:.2f} s: {n} params, "
          f"{n / draw / 1e6:.0f} M params/s)")
    return params, on_card


def model_phase() -> None:
    """Decode steps of the paper consumer: card against CPU plain path."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg = configs.get_config("paper_consumer")
    params = T.init_lm(cfg, seed=0, device="cuda")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    cache = T.init_cache(cfg, 1, 256, device="cuda")
    cache_cpu = T.init_cache(cfg, 1, 256, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (48,), generator=gen)
    worst = 0.0
    for i, tok in enumerate(tokens.tolist()):
        t = torch.tensor([[tok]], dtype=torch.int32)
        p = torch.tensor([[i]], dtype=torch.int32)
        lg, _ = T.lm_decode_step(params, t.cuda(), p.cuda(), cfg, cache)
        lc, _ = T.lm_decode_step(params_cpu, t, p, cfg, cache_cpu)
        check(lg.shape == (1, 1, cfg.padded_vocab), f"logits {lg.shape}")
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
    print(f"[model] paper_consumer 48 decode steps, card vs CPU: "
          f"max |logit diff| = {worst:.3e} (tolerance 1e-4)")
    check(worst <= 1e-4, "model decode on the card disagrees with the CPU path")


def trainer_settings():
    """The paper consumer at full width, ``launch/train``'s data shape
    (batch 8, seq 128) and the reference benchmark's trainer settings
    (``make_trainer_factory``): -> (model, step and data configs)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib

    cfg = configs.get_config("paper_consumer")
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=5, total_steps=10_000,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    return cfg, tcfg, dcfg


def trainer_factory(device):
    from repro_torch.core.trainer_worker import TrainerWorker

    cfg, tcfg, dcfg = trainer_settings()
    return lambda: TrainerWorker(cfg, tcfg, dcfg, device=device)


def _grads(params, batch, cfg):
    """Gradients of ``lm_loss`` at ``params`` (a list, leaf order)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, unflatten

    flat, treedef = flatten(params)
    with torch.enable_grad():
        inputs = [p.detach().requires_grad_() for p in flat]
        loss, _ = T.lm_loss(unflatten(treedef, inputs), batch, cfg)
        return torch.autograd.grad(loss, inputs)


def _rel_max(got, want) -> float:
    """Largest |got - want| over the largest |want|, worst over leaves."""
    return max(((g.cpu().float() - w.float()).abs().max()
                / w.float().abs().max()).item() for g, w in zip(got, want))


def _rel_norm(got, want) -> float:
    got, want = got.cpu().float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def paper_train_run(seed: int, device: str):
    """The paper consumer at full width from ``init_lm(seed)``: gradients
    at init on the seed's first batch, then three AdamW train steps.
    -> (grads, [loss], [grad_norm], params)."""
    import dataclasses

    from repro_torch.convert import to_tensor
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib

    cfg, tcfg, dcfg = trainer_settings()
    ds = SyntheticTokenDataset(dataclasses.replace(dcfg, seed=seed))
    params = T.init_lm(cfg, seed=seed, device=device)
    batches = [{k: to_tensor(a, device) for k, a in ds.batch(i).items()}
               for i in range(3)]
    grads = _grads(params, batches[0], cfg)
    opt = adamw.adamw_init(params, tcfg.opt)
    train_step = steplib.build_train_step(cfg, tcfg)
    losses, norms = [], []
    for i, b in enumerate(batches):
        params, opt, met = train_step(params, opt, b,
                                      torch.tensor(i, dtype=torch.int32))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return grads, losses, norms, params


def paper_train_readings(seed: int, host, tf32: bool = False) -> dict:
    """Card against the CPU run ``host`` (``paper_train_run(seed,
    "cpu")``); ``tf32`` lets cuBLAS round its float32 inputs to TF32 (the
    control: a lower-precision product)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tree import leaves

    cfg = trainer_settings()[0]
    before = fa.LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        grads, losses, norms, params = paper_train_run(seed, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    # one forward for the gradients, three train steps
    check(fa.LAUNCHES - before == 4 * cfg.num_layers,
          f"paper_consumer train: flash kernel launches "
          f"{fa.LAUNCHES - before}, want {4 * cfg.num_layers}")
    check(all(math.isfinite(x) for x in losses + norms),
          "paper_consumer train on the card: loss or grad_norm not finite")
    h_grads, h_losses, h_norms, h_params = host
    return {
        "grads": _rel_max(grads, h_grads),
        "loss": max(abs(c - h) / abs(h) for c, h in zip(losses, h_losses)),
        "grad_norm": max(abs(c - h) / abs(h) for c, h in zip(norms, h_norms)),
        "params": max((a.cpu() - b).abs().max().item() for a, b in
                      zip(leaves(params), leaves(h_params))),
    }


def smollm_run(seed: int, device: str):
    """smollm_360m at full width cut to 2 layers: ``lm_forward`` logits on
    a [8, 128] batch (flash at the train shape), then ``lm_prefill`` of
    8 prompts of 32 tokens into a max_seq-128 cache (flash at the prefill
    shape) and 4 teacher-forced ``lm_decode_step`` calls (the decode
    kernel at ``launch.serve``'s shape).  -> (forward, prefill, decode
    logits), float32."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.convert import to_tensor
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_config("smollm_360m"), num_layers=2)
    params = T.init_lm(cfg, seed=seed, device=device)
    batch = SyntheticTokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
        seed=seed)).batch(0)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (8, 36)).astype(np.int32)
    with torch.no_grad():
        fwd, _ = T.lm_forward(params, {k: to_tensor(a, device)
                                       for k, a in batch.items()}, cfg)
        cache = T.init_cache(cfg, 8, 128, device=device)
        pre, cache = T.lm_prefill(
            params, {"tokens": to_tensor(toks[:, :32], device)}, cfg, cache)
        dec = []
        for t in range(32, 36):
            pos = torch.full((8, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return fwd.float(), pre.float(), torch.cat(dec, 1).float()


@contextlib.contextmanager
def main_thread_patch(module, **fns):
    """``module``'s attributes ``fns`` (functions) replaced for the ``with``
    block in the main thread only: a host thread (``HostRuns``) running a
    CPU side beside a control keeps the plain functions."""
    plain = {name: getattr(module, name) for name in fns}

    def switch(name):
        def call(*args, **kwargs):
            main = threading.current_thread() is threading.main_thread()
            return (fns[name] if main else plain[name])(*args, **kwargs)
        return call

    for name in fns:
        setattr(module, name, switch(name))
    try:
        yield
    finally:
        for name, fn in plain.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def wrong_attention():
    """The control of the smollm check: attention with its masks dropped,
    i.e. train/prefill attention without the causal mask and decode
    attention over every cache slot, empty ones included."""
    from repro_torch.kernels import ops

    attention, decode = ops.attention, ops.decode_attention

    def no_mask(q, k, v, *, causal=True, window=0):
        return attention(q, k, v, causal=False, window=0)

    def all_slots(q, k_cache, v_cache, q_pos, k_pos):
        every = torch.arange(k_pos.shape[1], dtype=k_pos.dtype,
                             device=k_pos.device).expand_as(k_pos)
        return decode(q, k_cache, v_cache, q_pos + k_pos.shape[1], every)

    with main_thread_patch(ops, attention=no_mask,
                           decode_attention=all_slots):
        yield


def smollm_readings(seed: int, host, control: bool = False) -> dict:
    """Card against the CPU run ``host`` (``smollm_run(seed, "cpu")``):
    relative L2 error of each logits tensor; ``control`` runs the card
    with ``wrong_attention``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = dataclasses.replace(configs.get_config("smollm_360m"), num_layers=2)
    f0, d0 = fa.LAUNCHES, da.LAUNCHES
    with wrong_attention() if control else contextlib.nullcontext():
        got = smollm_run(seed, "cuda")
    check(fa.LAUNCHES - f0 == 2 * cfg.num_layers
          and da.LAUNCHES - d0 == 4 * cfg.num_layers,
          f"smollm check: {fa.LAUNCHES - f0} flash and {da.LAUNCHES - d0} "
          "decode launches, want 4 and 8")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "smollm logits on the card not finite")
    return {name: _rel_norm(g, h)
            for name, g, h in zip(("forward", "prefill", "decode"), got, host)}


def train_model_phase() -> None:
    """Card against CPU, over ``SEEDS``: gradients and three AdamW train
    steps of the paper consumer at full width, and the logits of
    smollm_360m at full width cut to 2 layers (only so that the CPU runs
    it in seconds) through forward, prefill and decode.  Each check's
    limit (``TRAIN_LIMITS``, ``SMOLLM_LIMITS``) must hold for every seed
    and fail for its control at every seed."""
    for kind, run, readings, limits, control in (
            ("paper_consumer train", paper_train_run, paper_train_readings,
             TRAIN_LIMITS, dict(tf32=True)),
            ("smollm_360m logits", smollm_run, smollm_readings,
             SMOLLM_LIMITS, dict(control=True))):
        sound, ctl = [], []
        for seed in SEEDS:
            host = run(seed, "cpu")
            sound.append(readings(seed, host))
            ctl.append(readings(seed, host, **control))
            for label, r in (("card vs CPU", sound[-1]),
                             (f"control {control}", ctl[-1])):
                print(f"[model] {kind}, {label}, seed {seed}: "
                      + " ".join(f"{k}={v:.3e}" for k, v in r.items()))
        for name, limit in limits.items():
            worst = max(r[name] for r in sound)
            least = min(r[name] for r in ctl)
            print(f"[model] {kind} {name}: worst sound {worst:.3e}, limit "
                  f"{limit:.1e}, least control {least:.3e}")
            check(worst <= limit, f"{kind}: card disagrees with the CPU "
                  f"({name} {worst:.3e} > {limit:.1e})")
            check(least > limit, f"{kind}: a control passes the {name} "
                  f"limit ({least:.3e} <= {limit:.1e}); the check cannot "
                  "see it")


# recurrentgemma_2b at full width cut to one 13-layer period of its
# pattern (9 RG-LRU and 4 local-attention layers, so that the CPU runs it
# too): relative L2 error of the logits of a prefill of 2 x 32 tokens and
# of 4 decode steps, card against CPU, worst over RG_SEEDS, in its bf16
# compute and in float32; the control drops the recurrence's carry
# (h_t = gated_t).  PERF.md (its recurrentgemma finding), on an H100
# over seeds 0-2, sound / control: bf16 prefill 1.42e-2-1.45e-2 / 2.73e-2-2.80e-2, decode
# 1.43e-2-1.47e-2 / 2.82e-2-2.90e-2 (with random weights the carry
# a_t * h is a few percent of h, so the bf16 limit has less than 2x room
# on either side); float32 prefill 1.79e-6-1.80e-6 / 2.01e-2-2.12e-2,
# decode 1.21e-6-1.23e-6 / 2.14e-2-2.23e-2 (100x room on each side).
RG_LAYERS = 13
RG_SEEDS = (0, 1, 2)
RG_LIMITS = {"bfloat16": dict(prefill=2e-2, decode=2e-2),
             "float32": dict(prefill=2e-4, decode=2e-4)}

# float32 gradient gates of the three families that train on the card
# (train_family_paths), in rg_model_phase, moe_model_phase and
# frontend_model_phase from their draws: one forward and backward of
# lm_loss on a [2, 32] batch of SyntheticTokenDataset(seed) (whisper's
# with [2, 1500, 1280] stub frames) and one AdamW step of launch.train's
# settings (lr 3e-4 at step 0, weight decay 0.01, clip 1.0), card against
# CPU.  Readings: the loss as the relative L2 error of its per-token
# terms (lm_loss_terms: a token's cross-entropy plus the router's aux
# term; their mean is the loss, so the loss's own relative error is at
# most this reading times the terms' rms over their mean), the
# grad norm (relative), the worst leaf's relative L2 gradient error, and
# the params after the step as the relative L2 error of the step's change
# (Adam's first step moves each entry by about lr times the sign of its
# gradient, so a near-zero gradient whose sign flips moves one entry by
# up to 2 lr: the maximum over a billion entries says nothing, the L2
# error weighs how many flip).  The control lets cuBLAS round its float32
# inputs to TF32.  TF32's errors cancel in a mean: read on the loss
# itself, granite's control at seed 0 came to one ulp of the loss
# (8.7e-8), as its sound run did, once float32 attention's last bits
# changed (PERF.md, the flash kernel's tf32x3 finding); in the terms they
# do not cancel.  On an H100 over each arch's seeds, worst sound / least
# control (the loss from the run of its terms, the rest from PERF.md's
# training findings): recurrentgemma_2b loss 1.6e-6 / 4.8e-5, grad
# norm 6.5e-6 / 1.5e-5 (TF32's errors mostly cancel in the norm: its
# limit has 1.5x room on either side), grads 4.3e-5 / 1.8e-3, params
# 5.1e-4 / 2.4e-2; granite_moe_1b_a400m loss 1.5e-7 / 5.6e-5, grad norm
# 6.8e-8 / 1.6e-5, grads 3.8e-6 / 2.1e-3, params 5.9e-5 / 2.1e-2.
# whisper_large_v3 (2 + 2 layers, 1500 frames; in frontend_model_phase,
# PERF.md's whisper training finding) loss 1.7e-7 / 2.9e-5, grad norm
# 1.0e-7 / 7.0e-6, grads 2.4e-6 / 9.5e-4, params 4.2e-5 / 1.4e-2.  Each
# limit was set near the geometric mean of the readings on the loss
# itself and is unchanged; the terms' readings lie below it, their
# controls 15x or more above.
GRAD_LIMITS = {
    "recurrentgemma_2b": dict(loss=3e-6, grad_norm=1e-5, grads=3e-4,
                              params=3e-3),
    "granite_moe_1b_a400m": dict(loss=1e-6, grad_norm=1e-6, grads=1e-4,
                                 params=1e-3),
    "whisper_large_v3": dict(loss=5e-7, grad_norm=1e-6, grads=5e-5,
                             params=1e-3),
}
# two of RG_SEEDS, for the script's time: the CPU's gradient and AdamW
# step of the 13-layer model (1.7 B params) take 40-47 s a seed on the
# 8-core host of an H100 machine
RG_GRAD_SEEDS = (0, 1)
# a card's own expert pick that differs from the CPU's must be a near-tie
# in the CPU's float32 router probabilities: within PICK_TIE, relative
PICK_TIE = 1e-5


class FollowPicks:
    """granite's gradient gate: the CPU run's expert picks and router
    probabilities recorded in call order (``host``), and the card's runs
    made to take them (``card``), so that a float32 near-tie cannot swap
    an expert and move a whole token's gradient.  The card's own picks
    that differ are counted; in a sound run (``strict``) each must be a
    near-tie (``PICK_TIE``), else the phase fails."""

    def __init__(self):
        self.picks = []
        self.differ = self.total = 0
        self.gap = 0.0  # the largest relative gap of a differing pick

    @contextlib.contextmanager
    def host(self):
        from repro_torch.models import moe

        plain = moe.top_k

        def recording(probs, k):
            vals, ids = plain(probs, k)
            self.picks.append((probs.detach().clone(), ids.clone()))
            return vals, ids

        with main_thread_patch(moe, top_k=recording):
            yield

    @contextlib.contextmanager
    def card(self, strict: bool):
        from repro_torch.models import moe

        plain = moe.top_k
        queue = list(self.picks)
        self.differ = self.total = 0
        self.gap = 0.0

        def following(probs, k):
            own = plain(probs, k)[1].cpu()
            host_probs, ids = queue.pop(0)
            self.total += ids.numel()
            for at in map(tuple, (own != ids).nonzero().tolist()):
                row = host_probs[at[:-1]]
                a, b = float(row[ids[at]]), float(row[own[at]])
                self.gap = max(self.gap, abs(a - b) / max(a, b))
                check(not strict or abs(a - b) <= PICK_TIE * max(a, b),
                      f"granite gradient gate: the card picks expert "
                      f"{int(own[at])} ({b:.9g}) over the CPU's "
                      f"{int(ids[at])} ({a:.9g}) at {at}: no near-tie")
                self.differ += 1
            ids = ids.to(probs.device)
            return torch.gather(probs, -1, ids), ids

        with main_thread_patch(moe, top_k=following):
            yield
        check(not queue, f"granite gradient gate: {len(queue)} router calls "
              "of the CPU run not made on the card")


def grad_step(cfg, params, seed: int, device: str, remat: str = "none",
              mem=None):
    """One float32 forward and backward of ``lm_loss`` (under ``remat``) on
    a [2, 32] batch of ``SyntheticTokenDataset(seed)`` (with [2, F,
    d_model] stub audio frames from the seed for an ``audio_frames``
    config), then one AdamW step with ``launch.train``'s settings at step
    0, in place on ``params``; ``mem`` (a dict, on the card) receives
    ``forward_and_backward``'s readings.  -> (loss, gradients in leaf
    order, grad norm, the loss's per-token terms)."""
    import dataclasses

    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.tree import flatten, unflatten

    cfg = dataclasses.replace(cfg, dtype="float32")
    batch = SyntheticTokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
        seed=seed)).batch(0)
    if cfg.frontend == "audio_frames":
        batch["frames"] = np.random.default_rng(seed).normal(
            0, 0.02, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch = {k: to_tensor(a, device) for k, a in batch.items()}
    loss, grads, terms = forward_and_backward(cfg, params, batch, remat,
                                              mem)
    opt_cfg = adamw.AdamWConfig(weight_decay=0.01)
    lr = cosine_schedule(torch.tensor(0, dtype=torch.int32, device=device),
                         peak=3e-3, warmup_steps=10, total_steps=3)
    treedef = flatten(params)[1]
    _, _, met = adamw.adamw_update(params, unflatten(treedef, list(grads)),
                                   adamw.adamw_init(params, opt_cfg),
                                   opt_cfg, lr=lr)
    return float(loss.detach()), grads, float(met["grad_norm"]), terms


def lm_loss_terms(params, batch, cfg, remat: str):
    """``transformer.lm_loss`` (the same operations in the same order, so
    the same bits) and its per-token terms: -> (loss, the terms detached),
    each term a kept token's cross-entropy plus the router's aux term, so
    that their mean is the loss."""
    from repro_torch.models import transformer as T

    logits, aux = T.lm_forward(params, batch, cfg, remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = -(ll * mask).sum() / denom
    loss = xent + cfg.router_aux_coef * aux
    terms = (cfg.router_aux_coef * aux - ll)[mask > 0]
    return loss, terms.detach()


def forward_and_backward(cfg, params, batch, remat: str, mem=None):
    """``lm_loss`` under ``remat`` and its gradients for every leaf of
    ``params`` -> (loss, gradients in leaf order, the loss's per-token
    terms: ``lm_loss_terms``).  ``mem`` (a dict, on the card) receives,
    after a garbage collection, what the forward leaves allocated for the
    backward (``saved``: the activations, bytes above what was allocated
    before) and the forward and backward's peak allocation above it
    (``peak``: the gradients included)."""
    from repro_torch.tree import flatten, unflatten

    flat, treedef = flatten(params)
    if mem is not None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with torch.enable_grad():
        inputs = [p.detach().requires_grad_() for p in flat]
        loss, terms = lm_loss_terms(unflatten(treedef, inputs), batch, cfg,
                                    remat)
        if mem is not None:
            mem["saved"] = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(loss, inputs)
    if mem is not None:
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated() - before
    return loss, grads, terms


def host_grad_step(cfg, seed: int):
    """``grad_step`` on the CPU from a fresh ``init_lm(seed)`` draw ->
    (loss, gradients, grad norm, the loss's per-token terms, the params
    after the step in leaf order, seconds)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=seed, device="cpu")
    loss, grads, norm, terms = grad_step(cfg, params, seed, "cpu")
    return loss, grads, norm, terms, leaves(params), time.perf_counter() - t0


class HostRuns:
    """The CPU sides of card-against-CPU checks in a thread of their own:
    ``jobs`` is a list of (key, function of no arguments), run in order,
    and ``result(key)`` hands a job's result over once.  torch's ops let
    go of the GIL, so the thread's work overlaps the main thread's card
    phases; ``threads`` sets the thread's own torch intra-op thread count
    (OpenMP's count is a thread's own: the main thread's is unchanged).

    recurrentgemma's gradient gate (``HOST_GATES``) starts before the
    build and runs beside it and the kernel phase until ``rg_model_phase``
    asks for it; started after the kernel phase instead, it shared the
    host's cores with the model phases' CPU runs and both took 2.5x as
    long.  The dense and frontend model checks' CPU sides (``HOST_RUNS``)
    start after the MoE model phase, on all host CPUs but two, and run
    beside the migrate paths, the examples and the trainer migrations:
    card phases whose host side is one thread dispatching."""

    def __init__(self, jobs, threads=None):
        self.results, self.error = {}, None
        self.ready = {key: threading.Event() for key, _ in jobs}
        threading.Thread(target=self._run, args=(jobs, threads),
                         daemon=True).start()

    def _run(self, jobs, threads):
        try:
            if threads:
                torch.set_num_threads(threads)
            for key, fn in jobs:
                t0 = time.perf_counter()
                self.results[key] = fn()
                print(f"[model] {key}: {time.perf_counter() - t0:.1f} s in "
                      f"its thread ({torch.get_num_threads()} torch threads)",
                      flush=True)
                self.ready[key].set()
        except BaseException as e:  # noqa: BLE001  (raised by result)
            self.error = e
            for ready in self.ready.values():
                ready.set()

    def result(self, key):
        """-> the result of job ``key`` (handed over once), and the seconds
        spent waiting for it."""
        t0 = time.perf_counter()
        self.ready[key].wait()
        if self.error is not None:
            raise self.error
        return self.results.pop(key), time.perf_counter() - t0


def rg_gate_key(seed: int) -> str:
    return f"recurrentgemma_2b gradient gate's CPU side, seed {seed}"


def host_gates() -> HostRuns:
    """``host_grad_step`` of recurrentgemma_2b for each of
    ``RG_GRAD_SEEDS``, in a thread (``HostRuns``)."""
    cfg = rg_config()
    return HostRuns([(rg_gate_key(seed),
                      functools.partial(host_grad_step, cfg, seed))
                     for seed in RG_GRAD_SEEDS])


HOST_GATES = None  # set by main()
HOST_RUNS = None  # set by main()


def grad_gate(arch, cfg, params, on_card, seed: int, launches: dict,
              follow=None, nonzero=(), host=None, keep=None):
    """The float32 gradient gate of ``arch`` (``GRAD_LIMITS``) for one
    seed: ``grad_step`` on the CPU from ``params`` (or ``host``, that
    step's ``host_grad_step`` result from the same draw), on the card
    from a copy of ``on_card`` (sound) and from ``on_card`` itself with
    TF32 products (the control), each card run launching ``launches``
    (flash on the tf32x3 route); ``follow`` (``FollowPicks``) makes the
    card take the CPU's expert picks; the sound run's gradients of the
    leaves at ``nonzero`` (paths) must not be all zero; ``keep`` (a dict)
    receives the sound card run's loss, gradients, grad norm and params
    after the step.  Both trees are updated in place (this is their last
    use).  -> (sound readings, control readings)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    from repro_torch.tree import leaves, tree_map

    if host is None:
        t0 = time.perf_counter()
        with follow.host() if follow else contextlib.nullcontext():
            h_loss, h_grads, h_norm, h_terms = grad_step(cfg, params, seed,
                                                         "cpu")
        t_host = time.perf_counter() - t0
        h_params = leaves(params)
    else:
        h_loss, h_grads, h_norm, h_terms, h_params, t_host = host
    # the CPU step's change, against the card's untouched copy of the init
    step_sq = sum(float((h.to("cuda") - c).double().square().sum())
                  for h, c in zip(h_params, leaves(on_card)))
    named = dict(common.leaf_paths(on_card))
    watched = {path: next(i for i, t in enumerate(leaves(on_card))
                          if t is named[path]) for path in nonzero}
    out = []
    for control in (False, True):
        card = on_card if control else tree_map(torch.clone, on_card)
        reset_counts()
        torch.backends.cuda.matmul.allow_tf32 = control
        try:
            mem = {} if keep is not None and not control else None
            t0 = time.perf_counter()
            with (follow.card(strict=not control) if follow
                  else contextlib.nullcontext()):
                loss, grads, norm, terms = grad_step(cfg, card, seed,
                                                     "cuda", mem=mem)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        n = read_counts()
        check({k: n[k] for k in launches} == launches
              and fa.TF32X3_LAUNCHES == n["flash_attention"],
              f"{arch} gradient gate: launches {n}, "
              f"{fa.TF32X3_LAUNCHES} on the tf32x3 route, want {launches} "
              "all on it")
        check(math.isfinite(loss) and math.isfinite(norm)
              and all(bool(torch.isfinite(g).all()) for g in grads),
              f"{arch} gradient gate: loss, grad norm or a gradient on the "
              "card not finite")
        for path, j in watched.items():
            check(control or bool(grads[j].any()), f"{arch} gradient gate: "
                  f"the card's gradient of {path} is all zero")
        rel = []
        for g, h in zip(grads, h_grads):
            h = h.to("cuda")
            d, ref = float((g - h).double().norm()), float(h.double().norm())
            rel.append(d / ref if ref else (0.0 if d == 0 else math.inf))
        diff_sq = sum(float((c - h.to("cuda")).double().square().sum())
                      for c, h in zip(leaves(card), h_params))
        h_t = h_terms.to("cuda").double()
        out.append({"loss": float((terms.double() - h_t).norm())
                    / float(h_t.norm()),
                    "grad_norm": abs(norm - h_norm) / abs(h_norm),
                    "grads": max(rel),
                    "params": math.sqrt(diff_sq / step_sq)})
        label = "control (TF32)" if control else "card vs CPU"
        picks = (f"; the card's own expert picks differing from the CPU's: "
                 f"{follow.differ} of {follow.total} (largest gap in the "
                 f"CPU's probabilities {follow.gap:.2e}, relative)"
                 if follow else "")
        nz = (" (non-zero gradients: " + ", ".join(watched) + ")"
              if watched and not control else "")
        print(f"[model] {arch} {cfg.num_layers} layers float32 gradient "
              f"gate, {label}, seed {seed}: " + " ".join(
                  f"{k}={v:.3e}" for k, v in out[-1].items())
              + f" (loss {loss:.6f}, grad norm {norm:.6f}){picks}{nz}"
              + (f" (CPU run {t_host:.1f} s)" if not control else ""))
        if keep is not None and not control:
            keep.update(loss=loss, grads=grads, norm=norm, params=card,
                        launches=n, wall=wall, mem=mem)
        del card, grads
    return out


KERNELS = ("decode_attention", "fingerprint_lanes", "xor_fp_lanes",
           "int8_fp_lanes", "flash_attention", "rglru", "slstm", "mlstm")
CODEC = ("xor_fp_lanes", "int8_fp_lanes")


def _counters():
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sl

    return ck, {"decode_attention": da, "fingerprint_lanes": fp,
                "flash_attention": fa, "rglru": rg, "slstm": sl,
                "mlstm": ml}


def reset_counts() -> None:
    ck, mods = _counters()
    for mod in mods.values():
        mod.LAUNCHES = 0
    mods["flash_attention"].WGMMA_LAUNCHES = 0
    mods["flash_attention"].TF32X3_LAUNCHES = 0
    mods["mlstm"].WGMMA_LAUNCHES = 0
    mods["slstm"].CLUSTER_LAUNCHES = 0
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def read_counts() -> dict:
    ck, mods = _counters()
    counts = {**{name: mod.LAUNCHES for name, mod in mods.items()},
              **ck.LAUNCHES}
    return {name: counts[name] for name in KERNELS}


def run_path(label, fn, needs, flash_route=None, tag="path"):
    """Run ``fn()`` with every counter set to 0 just before and read just
    after; each kernel in ``needs`` must have launched, and with
    ``flash_route`` ("wgmma" or "tf32x3") every flash launch must have
    taken that route (its counter moved by all of them); the printed line starts with ``[tag]``.  ->
    (launches, fn's result, wall seconds)."""
    from repro_torch.kernels import flash_attention as fa

    reset_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    on = {"wgmma": fa.WGMMA_LAUNCHES, "tf32x3": fa.TF32X3_LAUNCHES}
    print(f"[{tag}] {label}: wall={wall:.3f} s launches={launches} "
          f"flash on the wgmma route={on['wgmma']}, on the tf32x3 "
          f"route={on['tf32x3']}")
    for name in needs:
        check(launches[name] > 0, f"{label}: kernel {name} never launched")
    if flash_route:
        flash = launches["flash_attention"]
        check(flash > 0 and on[flash_route] == flash,
              f"{label}: flash launches {flash}, by route {on}; want every "
              f"one on the {flash_route} route")
    return launches, result, wall


def path_phase(argv, label, needs):
    """One ``launch/migrate`` run; its state must verify."""
    from repro_torch import configs
    from repro_torch.launch import migrate

    launches, rc, wall = run_path(label, lambda: migrate.main(argv), needs)
    # one launch per layer per decode step (source, replay and reference)
    steps = (launches["decode_attention"]
             // configs.get_config("paper_consumer").num_layers)
    print(f"[path] {label}: rc={rc} decode_steps={steps} wall_per_step_ms="
          f"{wall / max(steps, 1) * 1e3:.3f}")
    check(rc == 0, f"{label}: migrate exited {rc} (its state must verify)")
    return launches


def _captured(fn, argv):
    """Run a CLI ``main`` with its standard output captured, then echo it."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    text = out.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    return rc, text


def train_paths(paths) -> None:
    """``launch.train`` (smollm_360m, full width) for 8 steps, then
    ``--resume`` to 10 steps, then ``launch.serve`` with its defaults.
    Registry pushes are timed."""
    from repro_torch import configs
    from repro_torch.checkpoint import registry as registry_mod
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train

    cfg = configs.get_config("smollm_360m")
    image_bytes = 12 * cfg.param_count()  # params, m and v in float32
    need = 3 * image_bytes + 2 * 2 ** 30
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(build.BUILD_DIR).free
    print(f"[path] train: {cfg.param_count()} params, image {image_bytes} "
          f"bytes, three images to write; {free} bytes free under "
          f"{build.BUILD_DIR}")
    check(free >= need, f"train: {free} bytes free, need {need} for the "
          "checkpoint images")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build.BUILD_DIR)
    pushes = []
    plain_push = registry_mod.Registry.push_image

    def timed_push(self, trees, *args, **kwargs):
        t0 = time.perf_counter()
        rep = plain_push(self, trees, *args, **kwargs)
        pushes.append((time.perf_counter() - t0, rep.total_bytes))
        return rep

    registry_mod.Registry.push_image = timed_push
    try:
        base = ["--ckpt-every", "100", "--registry", root]
        for label, argv, expect in (
                ("train", ["--steps", "8"] + base, None),
                ("train-resume", ["--resume", "--steps", "10"] + base,
                 "[train] resumed from step 7 image")):
            launches, (rc, text), wall = run_path(
                label, lambda: _captured(train.main, argv),
                ("flash_attention", "fingerprint_lanes"), "wgmma")
            paths[label] = launches
            check(rc == 0, f"{label}: launch.train exited {rc}")
            loss = float(text.split("[train] done; final loss")[1].split()[0])
            check(math.isfinite(loss), f"{label}: final loss {loss}")
            if expect:
                check(expect in text, f"{label}: no line {expect!r}")
            steps = launches["flash_attention"] // cfg.num_layers
            print(f"[path] {label}: rc={rc} final_loss={loss:.4f} "
                  f"train_steps={steps}")
    finally:
        registry_mod.Registry.push_image = plain_push
        shutil.rmtree(root, ignore_errors=True)
    for dt, nbytes in pushes:
        print(f"[path] train checkpoint push: {nbytes} bytes in {dt:.3f} s "
              f"({nbytes / dt / 1e9:.3f} GB/s)")
    check(len(pushes) == 3, f"train: {len(pushes)} pushes, want 3")

    # its logits at these shapes are held card against CPU in the model
    # phase (smollm_readings)
    launches, (rc, text), _ = run_path(
        "serve", lambda: _captured(serve.main, []),
        ("flash_attention", "decode_attention"), "wgmma")
    paths["serve"] = launches
    check(rc == 0, f"serve: launch.serve exited {rc}")
    check("[serve] decoded 32 steps x 8 requests" in text,
          "serve: no decode line")
    check(launches["flash_attention"] == cfg.num_layers
          and launches["decode_attention"] == 32 * cfg.num_layers,
          f"serve: launches {launches}, want one prefill and 32 decode "
          "steps")


TRAIN_FAMILY_STEPS = 3
# the trainers' memory chunk store: copy threads, 4 MiB chunks in flight
STORE_THREADS = 4
STORE_IN_FLIGHT = 64


def train_family_path(paths, label: str, arch: str, per_step: dict,
                      run=None) -> None:
    """``arch`` at full width and depth trained for ``TRAIN_FAMILY_STEPS``
    steps by ``run(root)`` -> (rc, its printed lines), a registry at
    ``root``: by default ``launch.train --arch <arch>`` with the CLI's
    defaults (batch 8, seq 128, bf16 compute, float32 params, AdamW).
    Checks rc 0, a finite loss at every step, exactly ``per_step``
    launches a step and no other kernel but the fingerprint kernel, once
    per leaf of params, m, v and the count at each of the two saves (the
    step-0 snapshot's fingerprints on the card, then the final blocking
    push's), every flash launch on the wgmma route, both pushes of 12 n +
    4 bytes and the peak card memory below the card's.  Prints init
    seconds, each step's wall, the peak card memory, the snapshot's
    seconds and each push's bytes, GB/s and host-side parts."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.checkpoint import registry as registry_mod
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.train import step as steplib
    from repro_torch.tree import leaves

    cfg = configs.get_config(arch)
    # the image from the leaves' shapes (meta tensors: nothing allocated);
    # param_count() overcounts whisper_large_v3 by 197,457,920
    shapes = leaves(steplib.param_shapes_and_axes(cfg)[0])
    n_leaves, n_params = len(shapes), sum(t.numel() for t in shapes)
    image_bytes = 12 * n_params + 4  # params, m, v in float32; the count
    # both images in the memory store
    need = 2 * image_bytes + 2 * 2 ** 30
    with open("/proc/meminfo") as f:
        free = 1024 * int(next(line for line in f if line.startswith(
            "MemAvailable:")).split()[1])
    print(f"[path] {label}: {n_params} params in {n_leaves} leaves, image "
          f"{image_bytes} bytes, pushed twice (the step-0 image, then the "
          f"final one) into host memory; {free} bytes of host memory "
          "available")
    check(free >= need, f"{label}: {free} bytes of host memory available, "
          f"need {need} for two checkpoint images")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_",
                            dir=build.BUILD_DIR)
    pushes, saves, inits = [], [], []
    plain_push = registry_mod.Registry.push_image
    plain_save = ckpt_mod.Checkpointer.save
    # the push's host side in parts: a leaf's bytes as a host byte view
    # (``leaf_view``: a copy from the card, none from the snapshot's host
    # copy), its fingerprints where the push takes them (the blocking
    # push), its chunks' sha256 keys (``hash``, on the host's cores) and
    # the chunks' store (``put``: waiting for room among the copies in
    # flight, and at the push's end for the last of them)
    parts = {"leaf_view": 0.0, "fingerprints": 0.0, "hash": 0.0,
             "put": 0.0}

    def timing(fn, part):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[part] += time.perf_counter() - t0
        return timed

    class MemoryChunkStore(registry_mod.ChunkStore):
        """The chunks in host memory: the machine's disk takes 45 GiB of
        writes a call, and these paths push 133.6 GB (two images each).
        A chunk's copy into fresh memory (its page faults are most of its
        cost) runs on ``STORE_THREADS`` threads (numpy's copy lets go of
        the GIL), at most ``STORE_IN_FLIGHT`` chunks at a time; a push
        ends when its copies have (``wait``)."""

        def __init__(self, root):
            self.root, self._lock, self._blobs = root, threading.Lock(), {}
            self._room = threading.BoundedSemaphore(STORE_IN_FLIGHT)

        def has(self, key):
            return key in self._blobs

        def _copy(self, data):
            try:
                return np.frombuffer(data, np.uint8).copy()
            finally:
                self._room.release()

        @functools.partial(timing, part="put")
        def put(self, data, key=None):
            key = key or hashlib.sha256(data).hexdigest()
            with self._lock:
                new = key not in self._blobs
                if new:
                    self._room.acquire()
                    self._blobs[key] = copies.submit(self._copy, data)
            return key, new

        @functools.partial(timing, part="put")
        def wait(self):
            for blob in list(self._blobs.values()):
                blob.result()

        def get(self, key):
            return self._blobs[key].result().tobytes()

    patched = ((registry_mod._codecs, "leaf_view",
                timing(registry_mod._codecs.leaf_view, "leaf_view")),
               (registry_mod, "leaf_fingerprints",
                timing(registry_mod.leaf_fingerprints, "fingerprints")),
               (registry_mod, "_chunk_keys",
                timing(registry_mod._chunk_keys, "hash")),
               (registry_mod, "ChunkStore", MemoryChunkStore))
    plain_fns = [getattr(obj, name) for obj, name, _ in patched]
    for obj, name, fn in patched:
        setattr(obj, name, fn)

    def timed_push(self, trees, *args, **kwargs):
        t0 = time.perf_counter()
        rep = plain_push(self, trees, *args, **kwargs)
        self.store.wait()
        pushes.append((time.perf_counter() - t0, rep.total_bytes))
        return rep

    def timed_save(self, step, trees, meta=None, block=False):
        t0 = time.perf_counter()
        out = plain_save(self, step, trees, meta, block)
        saves.append((step, block, time.perf_counter() - t0))
        return out

    if run is None:
        def run(root):
            return _captured(train.main, [
                "--arch", arch, "--steps", str(TRAIN_FAMILY_STEPS),
                "--ckpt-every", "100", "--log-every", "1", "--registry",
                root])

    registry_mod.Registry.push_image = timed_push
    ckpt_mod.Checkpointer.save = timed_save
    copies = ThreadPoolExecutor(STORE_THREADS,
                                thread_name_prefix="chunk-store")
    torch.cuda.reset_peak_memory_stats()
    try:
        with timed_init(inits):
            launches, (rc, text), wall = run_path(
                label, lambda: run(root),
                tuple(per_step) + ("fingerprint_lanes",), "wgmma")
    finally:
        registry_mod.Registry.push_image = plain_push
        ckpt_mod.Checkpointer.save = plain_save
        for (obj, name, _), fn in zip(patched, plain_fns):
            setattr(obj, name, fn)
        copies.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    paths[label] = launches
    check(rc == 0, f"{label}: the trainer exited {rc}")
    loss = float(text.split("[train] done; final loss")[1].split()[0])
    steps = re.findall(
        r"\[train\] step +\d+ loss (\S+) lr \S+ gnorm \S+ (\d+)ms", text)
    check(len(steps) == TRAIN_FAMILY_STEPS, f"{label}: {len(steps)} step "
          "lines")
    losses = [float(x) for x, _ in steps]
    check(all(map(math.isfinite, losses + [loss])),
          f"{label}: losses {losses}, final {loss}")
    want = {k: TRAIN_FAMILY_STEPS * per_step.get(k, 0) for k in launches}
    want["fingerprint_lanes"] = 2 * (3 * n_leaves + 1)
    check(launches == want, f"{label}: launches {launches}, want {want}")
    check(len(inits) == 1 and len(pushes) == 2,
          f"{label}: {len(inits)} init_lm calls and {len(pushes)} pushes, "
          "want 1 and 2")
    (init_s, n), = inits
    check(n == n_params, f"{label}: init_lm made {n} params, the leaves' "
          f"shapes hold {n_params}")
    check(peak < total, f"{label}: peak card memory {peak} bytes, the card "
          f"holds {total}")
    print(f"[path] {label}: rc={rc} losses {losses} final_loss={loss:.4f} "
          f"per step {per_step}; init {init_s:.3f} s ({n / init_s / 1e6:.0f}"
          f" M params/s); step walls {[int(ms) for _, ms in steps]} ms; "
          f"peak card memory {peak} bytes of {total}; path wall "
          f"{wall:.3f} s")
    for step, block, dt in saves:
        what = ("blocking: waits for the pending push, then pushes"
                if block else "snapshot: fingerprints on the card, bytes "
                "to host")
        print(f"[path] {label}: save at step {step} ({what}) {dt:.3f} s")
    for dt, nbytes in pushes:
        check(nbytes == image_bytes, f"{label}: a push of {nbytes} bytes, "
              f"want {image_bytes}")
        print(f"[path] {label} checkpoint push: {nbytes} bytes in {dt:.3f} "
              f"s ({nbytes / dt / 1e9:.3f} GB/s)")
    print(f"[path] {label}: both pushes' host side, s: " + " ".join(
        f"{k}={v:.3f}" for k, v in parts.items()))


def whisper_train(root) -> int:
    """train-whisper's trainer: ``launch.train``'s loop and printed lines
    (``src/repro_torch/launch/train.py``) with its settings (remat none,
    lr 3e-3 with 10 warmup steps, AdamW with weight decay 0.01, batch 8 x
    128, a ``Checkpointer`` every 100 steps into ``root``, the last save
    blocking) for whisper_large_v3 at full width and depth, each batch
    given [8, 1500, 1280] stub audio frames drawn from (0, step): the
    CLI's data pipeline makes tokens and labels only, so neither
    package's ``launch.train`` can train whisper.  -> 0."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer, Registry
    from repro_torch.convert import to_tensor
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib

    arch, B, steps = "whisper_large_v3", 8, TRAIN_FAMILY_STEPS
    cfg = configs.get_config(arch)
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=3e-3, warmup_steps=10, total_steps=steps,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    ds = SyntheticTokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=128, global_batch=B))
    ckpt = Checkpointer(Registry(root), f"train-{arch}", interval_steps=100)
    params = T.init_lm(cfg, seed=0, device="cuda")
    opt_state = adamw.adamw_init(params, tcfg.opt)
    step_fn = steplib.build_train_step(cfg, tcfg)
    for step in range(steps):
        batch = ds.batch(step)
        batch["frames"] = np.random.default_rng([0, step]).normal(
            0, 0.02, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batch = {k: to_tensor(a, "cuda") for k, a in batch.items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(
            params, opt_state, batch, torch.tensor(step, dtype=torch.int32))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
              f"lr {float(metrics['lr']):.2e} gnorm "
              f"{float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
        ckpt.maybe_save(step, {"params": params, "opt": opt_state})
    ckpt.save(steps - 1, {"params": params, "opt": opt_state}, block=True)
    print("[train] done; final loss", float(metrics["loss"]))
    return 0


def train_family_paths(paths) -> None:
    """``train-rg`` (recurrentgemma_2b: 18 ``rglru`` and 8
    ``flash_attention`` launches a step) and ``train-granite``
    (granite_moe_1b_a400m: 24 ``flash_attention`` launches a step)
    through ``launch.train``, and ``train-whisper`` (whisper_large_v3: 96
    ``flash_attention`` launches a step, 32 encoder, 32 decoder self and
    32 cross) through ``whisper_train``, each by ``train_family_path``;
    each trainer is freed and the card's cache emptied before the next
    (43, 21 and 25 GB of state and gradients must not sit on the card
    together)."""
    import gc

    from repro_torch import configs
    from repro_torch.models import BlockKind

    rg = configs.get_config("recurrentgemma_2b")
    n_rec = rg.num_groups * sum(m == BlockKind.RGLRU for m, _ in rg.pattern)
    wh = configs.get_config("whisper_large_v3")
    for label, arch, per_step, run in (
            ("train-rg", "recurrentgemma_2b",
             dict(rglru=n_rec, flash_attention=rg.num_layers - n_rec), None),
            ("train-granite", "granite_moe_1b_a400m",
             dict(flash_attention=configs.get_config(
                 "granite_moe_1b_a400m").num_layers), None),
            ("train-whisper", "whisper_large_v3",
             dict(flash_attention=wh.num_encoder_layers + 2 * wh.num_layers),
             lambda root: _captured(whisper_train, root))):
        train_family_path(paths, label, arch, per_step, run)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[path] {label}: {torch.cuda.memory_allocated()} bytes "
              "still allocated on the card after the path")


SHARDED_TRAIN_STEPS = 4
SHARDED_DECODE_STEPS = 8


def _bits_equal(sharded, plain) -> bool:
    """A DTensor tree's local shards on a 1 x 1 mesh against a plain tree:
    the same keys, shapes, dtypes and bits."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import flatten

    a, b = flatten(sharded)[0], flatten(plain)[0]
    return len(a) == len(b) and all(
        isinstance(x, DTensor) and x.to_local().dtype == y.dtype
        and torch.equal(x.to_local(), y) for x, y in zip(a, b))


def sharded_1x1_phase(paths) -> None:
    """smollm_360m at full width and depth through the multi-device layer
    on the card: an NCCL world of one rank and ``make_host_mesh()`` (1 x
    1, data x model), params, AdamW state, batches and cache placed as
    DTensors by the train step's shardings; 4 sharded train steps against
    4 unsharded ones from the same weights (loss and every param bit for
    bit), then a prefill and 8 decode steps on a sharded cache against
    the unsharded path (logits and every cache leaf bit for bit), the
    flash and decode kernels launched on local shards
    (``ops.LOCAL_SHARD_CALLS``).  No multi-rank mesh runs here."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib
    from repro_torch.tree import tree_map

    print("[sharded-1x1] the multi-rank mesh was not run on the card: one "
          "card, an NCCL world of one rank, a 1 x 1 (data, model) mesh "
          "(multi-rank runs: the CPU gloo tests); torch.cuda.device_count()="
          f"{torch.cuda.device_count()}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_", dir=build.BUILD_DIR)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        cfg = configs.get_config("smollm_360m")
        B, S, prompt, max_seq = 8, 128, 32, 128
        tcfg = steplib.TrainStepConfig(
            remat="none", lr_peak=3e-3, warmup_steps=2,
            total_steps=SHARDED_TRAIN_STEPS,
            opt=adamw.AdamWConfig(weight_decay=0.01))
        ds = SyntheticTokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=S, global_batch=B))
        t0 = time.perf_counter()
        params = T.init_lm(cfg, seed=0, device="cuda")
        init_s = time.perf_counter() - t0
        _, p_sh, _, o_sh = steplib.train_state_shardings(cfg, mesh, tcfg.opt)
        b_sh = steplib.batch_shardings(cfg, ShapeSpec("t", "train", S, B),
                                       mesh)
        step_fn = steplib.build_train_step(cfg, tcfg)
        batches = [{k: torch.from_numpy(a).cuda()
                    for k, a in ds.batch(i).items()}
                   for i in range(SHARDED_TRAIN_STEPS)]

        def train(sharded: bool):
            p = tree_map(torch.clone, params)
            o = adamw.adamw_init(p, tcfg.opt)
            if sharded:
                p, o = steplib.distribute(p, p_sh), steplib.distribute(o, o_sh)
            losses, times = [], []
            for i, b in enumerate(batches):
                if sharded:
                    b = steplib.distribute(b, {k: b_sh[k] for k in b})
                t0 = time.perf_counter()
                p, o, m = step_fn(p, o, b, torch.tensor(i, dtype=torch.int32))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(m["loss"])
            return p, o, losses, times

        plain_p, plain_o, plain_l, plain_t = train(False)
        ops.LOCAL_SHARD_CALLS.clear()
        launches, (sh_p, sh_o, sh_l, sh_t), wall = run_path(
            "sharded-1x1-train", lambda: train(True), ("flash_attention",),
            "wgmma")
        paths["sharded-1x1-train"] = launches
        calls = dict(ops.LOCAL_SHARD_CALLS)
        loss_eq = all(isinstance(a, DTensor)
                      and torch.equal(a.to_local(), b)
                      for a, b in zip(sh_l, plain_l))
        print(f"[sharded-1x1] train: {cfg.param_count()} params (init "
              f"{init_s:.3f} s), {SHARDED_TRAIN_STEPS} steps of {B} x {S}; "
              f"losses {[float(x) for x in plain_l]}; step ms unsharded "
              f"{[round(t * 1e3, 1) for t in plain_t]}, sharded "
              f"{[round(t * 1e3, 1) for t in sh_t]}; local-shard calls "
              f"{calls}; launches {launches}")
        check(loss_eq, "sharded-1x1: train losses differ from the unsharded "
              "step's bits")
        check(_bits_equal(sh_p, plain_p) and _bits_equal(sh_o, plain_o),
              "sharded-1x1: params or AdamW state after the sharded steps "
              "differ from the unsharded steps' bits")
        want = SHARDED_TRAIN_STEPS * cfg.num_layers  # one a layer a step
        check(calls == {"attention": want}
              and launches["flash_attention"] == want,
              f"sharded-1x1: local-shard calls {calls}, flash launches "
              f"{launches['flash_attention']}, want {want} each")
        del sh_p, sh_o, plain_p, plain_o

        # serving: a prefill and 8 decode steps on a sharded cache
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, prompt)).astype(np.int32)).cuda()
        prefill = steplib.build_prefill_step(cfg)
        decode = steplib.build_decode_step(cfg)
        c_shapes, c_sh = steplib.cache_shardings(
            cfg, ShapeSpec("c", "decode", max_seq, B), mesh)
        p_sh2 = steplib.batch_shardings(cfg, ShapeSpec("p", "prefill",
                                                       prompt, B), mesh)
        d_sh = steplib.batch_shardings(cfg, ShapeSpec("d", "decode", max_seq,
                                                      B), mesh)

        def serve(sharded: bool):
            p = steplib.distribute(params, p_sh) if sharded else params
            cache = T.init_cache(cfg, B, max_seq, device="cuda")
            batch = {"tokens": tokens}
            if sharded:
                cache = steplib.distribute(cache, c_sh)
                batch = steplib.distribute(batch, {"tokens": p_sh2["tokens"]})
            out = []
            with torch.no_grad():
                logits, cache = prefill(p, cache, batch)
                out.append(logits)
                tok = tokens[:, -1:]
                for i in range(SHARDED_DECODE_STEPS):
                    pos = torch.full((B, 1), prompt + i, dtype=torch.int32,
                                     device="cuda")
                    step = {"tokens": tok, "positions": pos}
                    if sharded:
                        step = steplib.distribute(step, {k: d_sh[k]
                                                         for k in step})
                    logits, cache = decode(p, cache, step["tokens"],
                                           step["positions"])
                    out.append(logits)
                    nxt = logits.to_local() if sharded else logits
                    tok = torch.argmax(nxt, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            return out, cache

        plain_out, plain_cache = serve(False)
        ops.LOCAL_SHARD_CALLS.clear()
        launches, (sh_out, sh_cache), wall = run_path(
            "sharded-1x1-serve", lambda: serve(True),
            ("flash_attention", "decode_attention"), "wgmma")
        paths["sharded-1x1-serve"] = launches
        calls = dict(ops.LOCAL_SHARD_CALLS)
        L = cfg.num_layers
        print(f"[sharded-1x1] serve: prefill {B} x {prompt} and "
              f"{SHARDED_DECODE_STEPS} decode steps into max_seq {max_seq}; "
              f"wall {wall:.3f} s; local-shard calls {calls}; launches "
              f"{launches}")
        check(_bits_equal(sh_out, plain_out),
              "sharded-1x1: logits differ from the unsharded path's bits")
        check(_bits_equal(sh_cache, plain_cache),
              "sharded-1x1: the cache differs from the unsharded path's bits")
        want = dict(attention=L, decode_attention=SHARDED_DECODE_STEPS * L)
        check(calls == want and launches["flash_attention"] == L
              and launches["decode_attention"] == SHARDED_DECODE_STEPS * L,
              f"sharded-1x1: local-shard calls {calls}, launches "
              f"{launches}, want {want} each")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()


def rg_config(dtype: str = "bfloat16"):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                               num_layers=RG_LAYERS, dtype=dtype)


def rg_run(seed: int, params, device: str, dtype: str):
    """``lm_prefill`` of 2 prompts of 32 tokens into a max_seq-128 cache,
    then 4 teacher-forced ``lm_decode_step`` calls, from ``params`` (on
    ``device``), computing in ``dtype``.  -> (prefill, decode logits),
    float32."""
    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.models import transformer as T

    cfg = rg_config(dtype)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 36)).astype(np.int32)
    with torch.no_grad():
        cache = T.init_cache(cfg, 2, 128, device=device)
        pre, cache = T.lm_prefill(
            params, {"tokens": to_tensor(toks[:, :32], device)}, cfg, cache)
        dec = []
        for t in range(32, 36):
            pos = torch.full((2, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return pre.float(), torch.cat(dec, 1).float()


@contextlib.contextmanager
def carry_dropped():
    """The control of the recurrentgemma check: the RG-LRU with its carry
    dropped (h_t = gated_t).  Prefill runs each step as a scan of its own
    from zero state (through the kernel on the card); a decode step
    starts from zero state."""
    from repro_torch.kernels import ops, ref

    scan, step = ops.rglru_scan, ref.rglru_decode_step

    def no_carry_scan(x, a_param, gate_a, gate_x, h0=None, *, c=8.0):
        outs = [scan(x[:, t:t + 1], a_param, gate_a[:, t:t + 1],
                     gate_x[:, t:t + 1], None, c=c)
                for t in range(x.shape[1])]
        return torch.cat([o[0] for o in outs], 1), outs[-1][1]

    def no_carry_step(h, x, a_param, gate_a, gate_x, *, c=8.0):
        return step(torch.zeros_like(h), x, a_param, gate_a, gate_x, c=c)

    with main_thread_patch(ops, rglru_scan=no_carry_scan), \
            main_thread_patch(ref, rglru_decode_step=no_carry_step):
        yield


def rg_model_phase() -> dict:
    """Card against CPU, over ``RG_SEEDS`` and in each dtype of
    ``RG_LIMITS``: recurrentgemma_2b's logits at full width cut to
    ``RG_LAYERS`` layers.  The weights are drawn once a seed on the CPU
    (``init_lm`` draws there for every device) and copied to the card.
    Each limit must hold for every seed and fail for the control
    (``carry_dropped``) at every seed.  The gradient gate's CPU side comes
    from ``HOST_GATES``.  -> what ``remat_phase`` takes of the first
    gate's seed: the config, the seed, the params on the card as drawn,
    and the gate's sound card run."""
    from repro_torch.models import BlockKind
    from repro_torch.tree import tree_map

    cfg = rg_config()
    n_rec = sum(m == BlockKind.RGLRU for m, _ in cfg.pattern)
    n_attn = len(cfg.pattern) - n_rec
    sound = {dtype: [] for dtype in RG_LIMITS}
    ctl = {dtype: [] for dtype in RG_LIMITS}
    grad = {"float32": []}, {"float32": []}
    for seed in RG_SEEDS:
        params, on_card = host_and_card(cfg, seed, "recurrentgemma_2b")
        for dtype in RG_LIMITS:
            t0 = time.perf_counter()
            host = rg_run(seed, params, "cpu", dtype)
            t_host = time.perf_counter() - t0
            for control, out in ((False, sound), (True, ctl)):
                reset_counts()
                with carry_dropped() if control else contextlib.nullcontext():
                    got = rg_run(seed, on_card, "cuda", dtype)
                n = read_counts()
                want = (n_rec * (32 if control else 1), n_attn, 4 * n_attn)
                check((n["rglru"], n["flash_attention"],
                       n["decode_attention"]) == want,
                      f"recurrentgemma check: launches {n}, want rglru, "
                      f"flash and decode {want}")
                check(all(bool(torch.isfinite(g).all()) for g in got),
                      "recurrentgemma logits on the card not finite")
                out[dtype].append({name: _rel_norm(g, h) for name, g, h in
                                   zip(("prefill", "decode"), got, host)})
                label = "carry dropped (control)" if control else "card vs CPU"
                print(f"[model] recurrentgemma_2b {RG_LAYERS} layers {dtype}, "
                      f"{label}, seed {seed}: " + " ".join(
                          f"{k}={v:.3e}" for k, v in out[dtype][-1].items())
                      + (f" (CPU run {t_host:.1f} s)" if not control else ""))
        if seed in RG_GRAD_SEEDS:
            host, waited = HOST_GATES.result(rg_gate_key(seed))
            print(f"[model] recurrentgemma_2b gradient gate, seed {seed}: "
                  f"waited {waited:.1f} s for its CPU side")
            keep = None
            if seed == RG_GRAD_SEEDS[0]:
                keep = {}
                handover = dict(cfg=cfg, seed=seed, sound=keep,
                                start=tree_map(torch.clone, on_card))
            for out, r in zip(grad, grad_gate(
                    "recurrentgemma_2b", cfg, params, on_card, seed,
                    dict(rglru=n_rec, flash_attention=n_attn), host=host,
                    keep=keep)):
                out["float32"].append(r)
            del host
        del params, on_card
    check_limits("recurrentgemma_2b gradient gate",
                 {"float32": GRAD_LIMITS["recurrentgemma_2b"]}, *grad)
    for dtype, limits in RG_LIMITS.items():
        for name, limit in limits.items():
            worst = max(r[name] for r in sound[dtype])
            least = min(r[name] for r in ctl[dtype])
            print(f"[model] recurrentgemma_2b {dtype} {name}: worst sound "
                  f"{worst:.3e}, limit {limit:.1e}, least control "
                  f"{least:.3e}")
            check(worst <= limit, f"recurrentgemma_2b {dtype}: card "
                  f"disagrees with the CPU ({name} {worst:.3e} > "
                  f"{limit:.1e})")
            check(least > limit, f"recurrentgemma_2b {dtype}: the control "
                  f"passes the {name} limit ({least:.3e} <= {limit:.1e}); "
                  "the check cannot see it")
    return handover


# the remat phase: smollm_360m at full width and depth, launch.train's
# settings but remat (lr 3e-3, 10 warmup steps, AdamW wd 0.01, 8 x 128):
# one warm-up step, then REMAT_STEPS steps under each policy from it
REMAT_STEPS = 2


class MMCount(TorchDispatchMode):
    """Counts ``aten.mm``: in the forward inside the layer groups
    (``groups``, while ``T._run_groups`` runs; ``counting`` marks it), in
    the rest of the forward (``forward``) and in the backward
    (``backward``: where the autograd engine runs a node, a recompute
    included)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.in_groups = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            if torch._C._current_autograd_node() is not None:
                self.counts["backward"] += 1
            else:
                self.counts["groups" if self.in_groups else "forward"] += 1
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def counting(self):
        from repro_torch.models import transformer as T

        plain = T._run_groups

        def groups(*args, **kwargs):
            self.in_groups = True
            try:
                return plain(*args, **kwargs)
            finally:
                self.in_groups = False

        T._run_groups = groups
        try:
            with self:
                yield
        finally:
            T._run_groups = plain


def remat_phase(paths, rg) -> None:
    """``remat="none"``, ``"dots"`` and ``"full"`` on the card.

    smollm_360m at full width and depth through ``build_train_step``: one
    warm-up step under ``none``, then ``REMAT_STEPS`` steps under each
    policy from copies of its params and AdamW state.  The losses, grad
    norms, every param and every AdamW leaf after the steps must be the
    same bits under the three; the flash kernel launches once a layer a
    step under ``none`` and twice under ``dots`` and ``full`` (the
    recompute launches it again), all on the wgmma route.  Then one more
    forward and backward of ``lm_loss`` under each, from the warm-up
    state, counting ``aten.mm`` (``MMCount``): ``dots`` runs as many in
    the backward as ``none`` (every forward one is saved), ``full`` one
    more for each forward one in the layer groups but each group's last
    (``w_down``: only the group's output reads it, and the recompute
    stops before it).  Printed: each policy's step walls, what the
    garbage collector frees after the steps, and that forward and
    backward's allocations (``forward_and_backward``): the activations
    the forward saves, which must fall from ``none`` to ``dots`` to
    ``full``, and the peak (the gradients included, which set it at
    this batch), which must be lower under ``full`` than under
    ``none``.

    recurrentgemma_2b at full width cut to ``RG_LAYERS`` layers, from the
    params its gradient gate drew on the card (``rg``, from
    ``rg_model_phase``): one float32 ``grad_step`` under ``dots`` and one
    under ``full``, each bit-equal to the gate's sound card run under
    ``none`` (loss, grad norm, every gradient, every param after the
    AdamW step), launching ``rglru`` and flash twice as often as it, the
    flash launches on the tf32x3 route."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib
    from repro_torch.tree import leaves, tree_map

    cfg = configs.get_config("smollm_360m")
    B, S, L = 8, 128, cfg.num_layers
    ds = SyntheticTokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B))
    batches = [{k: torch.from_numpy(a).cuda() for k, a in ds.batch(i).items()}
               for i in range(1 + REMAT_STEPS)]

    def tcfg(remat):
        return steplib.TrainStepConfig(
            remat=remat, lr_peak=3e-3, warmup_steps=10,
            total_steps=1 + REMAT_STEPS,
            opt=adamw.AdamWConfig(weight_decay=0.01))

    params = T.init_lm(cfg, seed=0, device="cuda")
    opt = adamw.adamw_init(params, tcfg("none").opt)
    steplib.build_train_step(cfg, tcfg("none"))(
        params, opt, batches[0], torch.tensor(0, dtype=torch.int32))
    torch.cuda.synchronize()
    runs = {}
    for remat in T.REMAT:
        p, o = tree_map(torch.clone, params), tree_map(torch.clone, opt)
        step = steplib.build_train_step(cfg, tcfg(remat))

        def train():
            out = []
            for i in range(1, 1 + REMAT_STEPS):
                t0 = time.perf_counter()
                _, _, m = step(p, o, batches[i],
                               torch.tensor(i, dtype=torch.int32))
                torch.cuda.synchronize()
                out.append((m["loss"], m["grad_norm"],
                            time.perf_counter() - t0))
            return out

        launches, steps, wall = run_path(f"remat-{remat}", train,
                                         ("flash_attention",), "wgmma",
                                         tag="remat")
        paths[f"remat-{remat}"] = launches
        held = torch.cuda.memory_allocated()
        gc.collect()
        cyclic = held - torch.cuda.memory_allocated()
        # one forward and backward from the warm-up state, its products
        # counted and its allocations read
        mm, mem = MMCount(), {}
        with mm.counting():
            forward_and_backward(cfg, params, batches[1], remat, mem)
        runs[remat] = dict(steps=steps, params=p, opt=o, mm=mm.counts,
                           mem=mem, launches=launches)
        print(f"[remat] smollm_360m {L} layers, remat={remat}: "
              f"{REMAT_STEPS} steps of {B} x {S}, losses "
              f"{[float(x) for x, _, _ in steps]}, grad norms "
              f"{[float(g) for _, g, _ in steps]}, step walls "
              f"{[round(t * 1e3, 1) for _, _, t in steps]} ms; forward + "
              f"backward: activations saved {mem['saved']} bytes, peak "
              f"{mem['peak']} bytes (gradients "
              f"{4 * sum(t.numel() for t in leaves(params))}); left to the "
              f"garbage collector after the steps {cyclic} bytes; flash "
              f"launches {launches['flash_attention']} ({REMAT_STEPS} "
              f"steps); aten.mm in one forward + backward: "
              f"{dict(mm.counts)}")
    none = runs["none"]
    for remat in ("dots", "full"):
        r = runs[remat]
        check(all(torch.equal(a, b) for x, y in zip(r["steps"], none["steps"])
                  for a, b in zip(x[:2], y[:2]))
              and all(torch.equal(a, b) for a, b in
                      zip(leaves((r["params"], r["opt"])),
                          leaves((none["params"], none["opt"])))),
              f"remat: smollm_360m's losses, grad norms, params or AdamW "
              f"state under {remat} differ from remat=none's bits")
    for remat, per_step in (("none", L), ("dots", 2 * L), ("full", 2 * L)):
        n = runs[remat]["launches"]["flash_attention"]
        check(n == REMAT_STEPS * per_step, f"remat: {n} flash launches "
              f"under {remat}, want {per_step} a step")
    groups = none["mm"]["groups"]
    check(groups == 7 * L, f"remat: {groups} forward mm in the groups, want "
          "7 a layer (q, k, v, o, up, gate, down)")
    for remat, extra in (("dots", 0), ("full", groups - cfg.num_groups)):
        got, want = runs[remat]["mm"]["backward"], none["mm"]["backward"]
        check(got == want + extra and runs[remat]["mm"]["groups"] == groups,
              f"remat: {got} mm in the backward under {remat}, want "
              f"{want} + {extra}")
    saved = [runs[r]["mem"]["saved"] for r in ("full", "dots", "none")]
    check(saved[0] < saved[1] < saved[2], "remat: the activations the "
          f"forward saves under full, dots and none ({saved} bytes) do not "
          "fall in that order")
    peaks = [runs[r]["mem"]["peak"] for r in ("full", "none")]
    check(peaks[0] < peaks[1], f"remat: the forward and backward's peak "
          f"under full ({peaks[0]} bytes) is not below none's ({peaks[1]})")
    del runs, params, opt, batches
    torch.cuda.empty_cache()

    cfg, seed, sound = rg["cfg"], rg["seed"], rg["sound"]
    once = {k: sound["launches"][k] for k in ("rglru", "flash_attention")}
    print(f"[remat] recurrentgemma_2b {cfg.num_layers} layers float32, "
          f"seed {seed}, remat=none (the gradient gate's sound card run): "
          f"loss {sound['loss']!r}, grad norm {sound['norm']!r}, wall "
          f"{sound['wall'] * 1e3:.1f} ms, forward + backward: activations "
          f"saved {sound['mem']['saved']} bytes, peak "
          f"{sound['mem']['peak']} bytes; launches {once}")
    for remat in ("dots", "full"):
        card = (rg.pop("start") if remat == "full"
                else tree_map(torch.clone, rg["start"]))
        mem = {}

        def run():
            return grad_step(cfg, card, seed, "cuda", remat=remat, mem=mem)

        launches, (loss, grads, norm, _), wall = run_path(
            f"remat-rg-{remat}", run, ("rglru", "flash_attention"), "tf32x3",
            tag="remat")
        paths[f"remat-rg-{remat}"] = launches
        print(f"[remat] recurrentgemma_2b {cfg.num_layers} layers float32, "
              f"seed {seed}, remat={remat}: loss {loss!r}, grad norm "
              f"{norm!r}, wall {wall * 1e3:.1f} ms, forward + backward: "
              f"activations saved {mem['saved']} bytes, peak {mem['peak']} "
              f"bytes; launches {({k: launches[k] for k in once})}")
        check(loss == sound["loss"] and norm == sound["norm"]
              and all(torch.equal(a, b) for a, b in zip(grads, sound["grads"]))
              and all(torch.equal(a, b) for a, b in
                      zip(leaves(card), leaves(sound["params"]))),
              f"remat: recurrentgemma_2b's float32 step under {remat} "
              "differs from the gradient gate's sound card run's bits")
        check(all(launches[k] == 2 * n for k, n in once.items()),
              f"remat: recurrentgemma_2b launches {launches} under {remat}, "
              f"want twice {once}")
        del card, grads
    torch.cuda.empty_cache()


@contextlib.contextmanager
def capturing_prefill(captured):
    """``launch.serve``'s prefill step, wrapped so that its params, its
    prompt batch, logits and the cache right after it land in
    ``captured``."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_map

    plain_build = serve.steplib.build_prefill_step

    def capturing_build(c):
        prefill = plain_build(c)

        def prefill_step(params, cache, batch):
            logits, cache = prefill(params, cache, batch)
            captured.update(params=params, batch=batch,
                            logits=logits.clone(),
                            cache=tree_map(torch.clone, cache))
            return logits, cache

        return prefill_step

    serve.steplib.build_prefill_step = capturing_build
    try:
        yield
    finally:
        serve.steplib.build_prefill_step = plain_build


def rg_serve_paths(paths) -> None:
    """``launch.serve --arch recurrentgemma_2b`` at full width with the
    reference's defaults and with a 2304-token prompt (the local layers'
    2048-slot ring rolls and their window bites): each prints the
    reference's lines and launches, per prefill, ``rglru`` once per
    RG-LRU layer and ``flash_attention`` once per local layer, and per
    decode step ``decode_attention`` once per local layer.  The default
    run's cache after its prefill then goes through the registry
    (``ms2m_state``)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import BlockKind

    cfg = configs.get_config("recurrentgemma_2b")
    n_rec = cfg.num_groups * sum(m == BlockKind.RGLRU for m, _ in cfg.pattern)
    n_attn = cfg.num_layers - n_rec
    captured = {}
    runs = (("serve-rg", ["--arch", "recurrentgemma_2b"], 8, 32, 32),
            ("serve-rg-long", ["--arch", "recurrentgemma_2b", "--requests",
                               "2", "--prompt-len", "2304", "--max-seq",
                               "2560", "--decode-steps", "16"], 2, 2304, 16))
    for label, argv, B, prompt, steps in runs:
        inits = []
        with (capturing_prefill(captured) if label == "serve-rg"
              else contextlib.nullcontext()), timed_init(inits):
            launches, (rc, text), wall = run_path(
                label, lambda: _captured(serve.main, argv),
                ("rglru", "flash_attention", "decode_attention"), "wgmma")
        paths[label] = launches
        check(rc == 0, f"{label}: launch.serve exited {rc}")
        for line in (f"[serve] prefill {prompt} tokens x {B} requests: ",
                     f"[serve] decoded {steps} steps x {B} requests: ",
                     "[serve] sample continuation (request 0): "):
            check(line in text, f"{label}: no line {line!r}")
        want = dict(rglru=n_rec, flash_attention=n_attn,
                    decode_attention=steps * n_attn)
        check(all(launches[k] == (want.get(k, 0)) for k in launches),
              f"{label}: launches {launches}, want {want} (one prefill, "
              f"{steps} decode steps)")
        (init_s, n), = inits
        print(f"[path] {label}: rc={rc} per prefill rglru={n_rec} "
              f"flash_attention={n_attn}; per decode step "
              f"decode_attention={n_attn}; init {init_s:.3f} s ({n} params "
              f"drawn and copied, {n / init_s / 1e6:.0f} M params/s)")
        if label == "serve-rg":
            paths["serve-rg-ms2m"] = ms2m_state(
                "serve-rg-ms2m", cfg, captured,
                ("fingerprint_lanes", "decode_attention"))
            captured.clear()


def ms2m_state(label, cfg, state, needs, image_bytes=None,
               flash_route=None) -> dict:
    """A serving cache right after a prefill, pushed through the port's
    ``Registry`` (its fingerprints taken on the card) and pulled into a
    fresh cache; 8 greedy decode steps from each must give bit-equal
    tokens and logits.  ``state`` is a ``launch.serve`` run's captured
    prefill (a dict) or a function that runs one inside the path and
    returns (params, logits, cache).  -> launches.  Prints the image's
    bytes beside those of a KV cache of every layer at the same batch and
    length (the O(1)-state case); ``image_bytes``, where given, is the
    size the image must have; ``flash_route``, where given, the route
    every flash launch must take."""
    from repro_torch.checkpoint.registry import Registry
    from repro_torch.convert import to_tensor
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.train import step as steplib
    from repro_torch.tree import flatten, tree_map, unflatten

    max_seq = 128  # launch.serve's default
    decode = steplib.build_decode_step(cfg)

    def load():
        if callable(state):
            return state()
        return state["params"], state["logits"], state["cache"]

    def run():
        params, logits, cache = load()
        B, prompt = logits.shape[0], logits.shape[1]
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
            reg = Registry(root)
            report = reg.push_image({"cache": cache})
            trees, pulled = reg.pull_image(report.image_id)
        fresh = T.init_cache(cfg, B, max_seq, device="cuda")
        got, treedef = flatten(trees["cache"])
        _, fresh_def = flatten(fresh)
        check(treedef == fresh_def, "ms2m: pulled cache tree differs")
        restored = unflatten(fresh_def, [to_tensor(a, "cuda") for a in got])
        for a, b in zip(flatten(restored)[0], flatten(cache)[0]):
            check(a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(a, b), "ms2m: pulled leaf differs")
        outs = []
        for c in (tree_map(torch.clone, cache), restored):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            pos = torch.full((B, 1), prompt, dtype=torch.int32, device="cuda")
            toks, lgs = [], []
            for _ in range(8):
                lg, c = decode(params, c, tok, pos)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                pos = pos + 1
                toks.append(tok)
                lgs.append(lg)
            outs.append((torch.cat(toks, 1), torch.cat(lgs, 1), c))
        return report, pulled, outs, B

    launches, (report, pulled, outs, B), wall = run_path(label, run, needs,
                                                         flash_route)
    (ta, la, ca), (tb, lb, cb) = outs
    check(torch.equal(ta, tb) and torch.equal(la, lb),
          "ms2m: decoding from the pulled cache differs from the source")
    check(all(torch.equal(a, b) for a, b in zip(flatten(ca)[0],
                                                flatten(cb)[0])),
          "ms2m: caches differ after 8 decode steps")
    item = torch.tensor([], dtype=cfg.compute_dtype).element_size()
    kv_bytes = cfg.num_layers * B * max_seq * (
        2 * cfg.num_kv_heads * cfg.resolved_head_dim * item + 4)
    check(image_bytes in (None, report.total_bytes),
          f"ms2m: image of {report.total_bytes} bytes, want {image_bytes}")
    print(f"[path] {label}: image {report.total_bytes} bytes "
          f"({report.num_chunks} chunks, pulled {pulled}); a KV cache of all "
          f"{cfg.num_layers} layers at batch {B}, {max_seq} slots would "
          f"hold {kv_bytes} bytes ({report.total_bytes / kv_bytes:.3f}x); "
          f"8 decode steps from the pulled cache bit-equal to the source's "
          f"(tokens {ta[0].tolist()})")
    return launches


XL_SEEDS = (0, 1, 2)
# card against CPU, relative L2 error of the logits, worst over XL_SEEDS;
# each limit lies between the sound readings and the control's (PERF.md,
# xlstm_350m findings: on an H100 over seeds 0-2, worst sound / least
# control: bf16 5.1e-2 / 0.56 forward, 0.136 / 0.56 prefill, 3.9e-2 /
# 0.85 decode; float32 1.3e-5 / 0.56, 1.6e-5 / 0.56, 6.8e-6 / 0.85).
# bf16 rounding is amplified by the per-head norm of the mLSTM output,
# which is steep where k.q is near 0
XL_LIMITS = {"bfloat16": dict(forward=3e-1, prefill=3e-1, decode=3e-1),
             "float32": dict(forward=1e-3, prefill=1e-3, decode=1e-3)}


def xl_config(dtype: str = "bfloat16"):
    """xlstm_350m at full width cut to one group (7 mLSTM + 1 sLSTM)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config("xlstm_350m")
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern), dtype=dtype)


def xl_run(seed: int, params, device: str, dtype: str):
    """From ``params`` (on ``device``), computing in ``dtype``: an
    ``lm_forward`` of 2 x 32 tokens (the kernels on the card), then
    ``lm_prefill`` of the same prompts into a fresh cache and 4
    teacher-forced ``lm_decode_step`` calls (the recurrences).  ->
    (forward, prefill, decode logits), float32."""
    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.models import transformer as T

    cfg = xl_config(dtype)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 36)).astype(np.int32)
    with torch.no_grad():
        batch = {"tokens": to_tensor(toks[:, :32], device)}
        fwd, _ = T.lm_forward(params, batch, cfg)
        cache = T.init_cache(cfg, 2, 128, device=device)
        pre, cache = T.lm_prefill(params, batch, cfg, cache)
        dec = []
        for t in range(32, 36):
            pos = torch.full((2, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return fwd.float(), pre.float(), torch.cat(dec, 1).float()


@contextlib.contextmanager
def decay_dropped():
    """The control of the xLSTM check: every mLSTM without its forget-gate
    decay (log f = 0: f_gate pushed to +1e4), in the kernel on the card
    and in the recurrences of prefill and decode."""
    from repro_torch.kernels import ops, ref

    scan, step = ops.mlstm_scan, ref.mlstm_decode_step

    def no_decay_scan(q, k, v, i_gate, f_gate, state=None):
        return scan(q, k, v, i_gate, torch.full_like(f_gate, 1e4), state)

    def no_decay_step(state, q, k, v, i_gate, f_gate):
        return step(state, q, k, v, i_gate, torch.full_like(f_gate, 1e4))

    with main_thread_patch(ops, mlstm_scan=no_decay_scan), \
            main_thread_patch(ref, mlstm_decode_step=no_decay_step):
        yield


def xl_model_phase() -> None:
    """Card against CPU, over ``XL_SEEDS`` and in each dtype of
    ``XL_LIMITS``: xlstm_350m's logits at full width cut to one group.
    The weights are drawn once a seed on the CPU and copied to the card.
    Each limit must hold for every seed and fail for the control
    (``decay_dropped``) at every seed."""
    from repro_torch.models import BlockKind

    cfg = xl_config()
    n_m = sum(m == BlockKind.MLSTM for m, _ in cfg.pattern)
    n_s = sum(m == BlockKind.SLSTM for m, _ in cfg.pattern)
    sound = {dtype: [] for dtype in XL_LIMITS}
    ctl = {dtype: [] for dtype in XL_LIMITS}
    names = ("forward", "prefill", "decode")
    for seed in XL_SEEDS:
        params, on_card = host_and_card(cfg, seed, "xlstm_350m")
        for dtype in XL_LIMITS:
            t0 = time.perf_counter()
            host = xl_run(seed, params, "cpu", dtype)
            t_host = time.perf_counter() - t0
            for control, out in ((False, sound), (True, ctl)):
                reset_counts()
                with decay_dropped() if control else contextlib.nullcontext():
                    got = xl_run(seed, on_card, "cuda", dtype)
                n = read_counts()
                check((n["mlstm"], n["slstm"]) == (n_m, n_s),
                      f"xlstm check: launches {n}, want mlstm {n_m} and "
                      f"slstm {n_s} (the forward only)")
                check(all(bool(torch.isfinite(g).all()) for g in got),
                      "xlstm logits on the card not finite")
                out[dtype].append({name: _rel_norm(g, h) for name, g, h in
                                   zip(names, got, host)})
                label = ("decay dropped (control)" if control
                         else "card vs CPU")
                print(f"[model] xlstm_350m {len(cfg.pattern)} layers {dtype}, "
                      f"{label}, seed {seed}: " + " ".join(
                          f"{k}={v:.3e}" for k, v in out[dtype][-1].items())
                      + (f" (CPU run {t_host:.1f} s)" if not control else ""))
        del params, on_card
    for dtype, limits in XL_LIMITS.items():
        for name, limit in limits.items():
            worst = max(r[name] for r in sound[dtype])
            least = min(r[name] for r in ctl[dtype])
            print(f"[model] xlstm_350m {dtype} {name}: worst sound "
                  f"{worst:.3e}, limit {limit:.1e}, least control "
                  f"{least:.3e}")
            check(worst <= limit, f"xlstm_350m {dtype}: card disagrees "
                  f"with the CPU ({name} {worst:.3e} > {limit:.1e})")
            check(least > limit, f"xlstm_350m {dtype}: the control passes "
                  f"the {name} limit ({least:.3e} <= {limit:.1e}); the "
                  "check cannot see it")


XL_TRAIN_STEPS = 4


def xl_paths(paths) -> None:
    """``launch.train --arch xlstm_350m`` (full width) for
    ``XL_TRAIN_STEPS`` steps: each step's forward launches ``mlstm`` once
    per mLSTM layer (21) and ``slstm`` once per sLSTM layer (3), its
    backward neither (the plain versions), and the final image push the
    fingerprint kernel.  Then ``launch.serve --arch xlstm_350m`` with its
    defaults (prefill and decode thread the state: no xLSTM kernel), and
    its cache after prefill through the registry (``ms2m_state``): 8
    sequences x (21 mLSTM states of 4,202,512 bytes + 3 sLSTM states of
    16,384 bytes)."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    from repro_torch.models import BlockKind

    cfg = configs.get_config("xlstm_350m")
    n_m = cfg.num_groups * sum(m == BlockKind.MLSTM for m, _ in cfg.pattern)
    n_s = cfg.num_layers - n_m
    image_bytes = 12 * cfg.param_count()  # params, m and v in float32
    need = image_bytes + 2 * 2 ** 30
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(build.BUILD_DIR).free
    print(f"[path] train-xl: {cfg.param_count()} params, image "
          f"{image_bytes} bytes to write; {free} bytes free under "
          f"{build.BUILD_DIR}")
    check(free >= need, f"train-xl: {free} bytes free, need {need} for the "
          "checkpoint image")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_xl_",
                            dir=build.BUILD_DIR)
    try:
        argv = ["--arch", "xlstm_350m", "--steps", str(XL_TRAIN_STEPS),
                "--ckpt-every", "100", "--log-every", "1", "--registry", root]
        launches, (rc, text), wall = run_path(
            "train-xl", lambda: _captured(train.main, argv),
            ("mlstm", "slstm", "fingerprint_lanes"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths["train-xl"] = launches
    check(rc == 0, f"train-xl: launch.train exited {rc}")
    from repro_torch.kernels import slstm as sl
    check(sl.CLUSTER_LAUNCHES == launches["slstm"],
          f"train-xl: {sl.CLUSTER_LAUNCHES} of {launches['slstm']} slstm "
          "launches on the cluster route, want every one")
    plan = sl.slstm_plan(8, cfg.num_heads, cfg.d_model // cfg.num_heads)
    print(f"[path] train-xl: {sl.CLUSTER_LAUNCHES} of {launches['slstm']} "
          f"slstm launches on the cluster route (plan {tuple(plan)})")
    from repro_torch.kernels import mlstm as ml
    check(ml.WGMMA_LAUNCHES == launches["mlstm"],
          f"train-xl: {ml.WGMMA_LAUNCHES} of {launches['mlstm']} mlstm "
          "launches on the wgmma route, want every one")
    ml_plan = ml.mlstm_plan(8, 128, cfg.num_heads,
                            2 * cfg.d_model // cfg.num_heads, 128)
    print(f"[path] train-xl: {ml.WGMMA_LAUNCHES} of {launches['mlstm']} "
          f"mlstm launches on the wgmma route (plan {tuple(ml_plan)})")
    loss = float(text.split("[train] done; final loss")[1].split()[0])
    check(math.isfinite(loss), f"train-xl: final loss {loss}")
    check((launches["mlstm"], launches["slstm"])
          == (XL_TRAIN_STEPS * n_m, XL_TRAIN_STEPS * n_s),
          f"train-xl: launches {launches}, want {n_m} mlstm and {n_s} "
          f"slstm a step over {XL_TRAIN_STEPS} steps")
    print(f"[path] train-xl: rc={rc} final_loss={loss:.4f} per step "
          f"mlstm={n_m} slstm={n_s}; wall per step "
          f"{wall / XL_TRAIN_STEPS * 1e3:.0f} ms (the push included)")

    captured = {}
    with capturing_prefill(captured):
        launches, (rc, text), wall = run_path(
            "serve-xl", lambda: _captured(serve.main, ["--arch",
                                                      "xlstm_350m"]), ())
    paths["serve-xl"] = launches
    check(rc == 0, f"serve-xl: launch.serve exited {rc}")
    for line in ("[serve] prefill 32 tokens x 8 requests: ",
                 "[serve] decoded 32 steps x 8 requests: ",
                 "[serve] sample continuation (request 0): "):
        check(line in text, f"serve-xl: no line {line!r}")
    check(not any(launches.values()), f"serve-xl: launches {launches}, want "
          "none (prefill and decode thread the state)")
    H, D = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
    # per sequence: C [H,D,D], n [H,D], m [H] per mLSTM layer and c, n, h,
    # m [d_model] per sLSTM layer, all float32
    state = 8 * 4 * (n_m * (H * D * D + H * D + H) + n_s * 4 * cfg.d_model)
    paths["serve-xl-ms2m"] = ms2m_state("serve-xl-ms2m", cfg, captured,
                                        ("fingerprint_lanes",), state)


# The dense family at full width, cut in depth so that the CPU runs it
# too: codeqwen1_5_7b and chatglm3_6b at 2 layers, gemma3_4b with its
# pattern cut to its first 6 entries (5 local layers, window 1024, and 1
# global).  Relative L2 error of the logits of a prefill of 8 x 32 tokens
# and of 4 decode steps (launch.serve's shapes), card against CPU, worst
# over DENSE_SEEDS, in bf16 compute and in float32.  Each control removes
# what its config adds: codeqwen attention without its masks
# (wrong_attention), chatglm3 RoPE over the whole head, gemma3 no
# QK-norm.  The limits lie between the sound readings and the controls'
# (PERF.md, the dense-family finding: on an H100 over seeds 0-1, worst
# sound / least control, prefill and decode: bf16 4.5e-3 / 0.169
# codeqwen, 4.5e-3 / 0.140 chatglm3, 1.03e-2 / 0.112 gemma3; float32
# 1.5e-6 at worst / 0.111 at least).  Two seeds, for the script's time.
DENSE = ("codeqwen1_5_7b", "chatglm3_6b", "gemma3_4b")
DENSE_SEEDS = (0, 1)
DENSE_LIMITS = {
    "codeqwen1_5_7b": {"bfloat16": dict(prefill=5e-2, decode=5e-2),
                       "float32": dict(prefill=2e-4, decode=2e-4)},
    "chatglm3_6b": {"bfloat16": dict(prefill=5e-2, decode=5e-2),
                    "float32": dict(prefill=2e-4, decode=2e-4)},
    "gemma3_4b": {"bfloat16": dict(prefill=5e-2, decode=5e-2),
                  "float32": dict(prefill=2e-4, decode=2e-4)},
}


def dense_config(arch: str, dtype: str = "bfloat16", control: bool = False):
    """``arch`` at full width cut in depth (see ``DENSE``), computing in
    ``dtype``; ``control`` takes chatglm3's RoPE over the whole head or
    gemma3's QK-norm away (codeqwen's control is ``wrong_attention``)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    cut = (dict(pattern=cfg.pattern[:6], num_layers=6)
           if arch == "gemma3_4b" else dict(num_layers=2))
    if control and arch == "chatglm3_6b":
        cut["rope_fraction"] = 1.0
    if control and arch == "gemma3_4b":
        cut["use_qk_norm"] = False
    return dataclasses.replace(cfg, dtype=dtype, **cut)


def serve_run(cfg, seed: int, params, device: str):
    """``lm_prefill`` of 8 prompts of 32 tokens into a max_seq-128 cache,
    then 4 teacher-forced ``lm_decode_step`` calls, from ``params`` (on
    ``device``).  -> (prefill, decode logits), float32."""
    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.models import transformer as T

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (8, 36)).astype(np.int32)
    with torch.no_grad():
        cache = T.init_cache(cfg, 8, 128, device=device)
        pre, cache = T.lm_prefill(
            params, {"tokens": to_tensor(toks[:, :32], device)}, cfg, cache)
        dec = []
        for t in range(32, 36):
            pos = torch.full((8, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return pre.float(), torch.cat(dec, 1).float()


def dense_host(arch: str, seed: int) -> dict:
    """The CPU side of ``arch``'s check for ``seed``: ``serve_run`` on the
    CPU in each dtype of ``DENSE_LIMITS`` from ``init_lm(seed)`` drawn
    there.  -> {dtype: (logits, seconds)}."""
    from repro_torch.models import transformer as T

    params = T.init_lm(dense_config(arch), seed=seed, device="cpu")
    out = {}
    for dtype in DENSE_LIMITS[arch]:
        t0 = time.perf_counter()
        out[dtype] = (serve_run(dense_config(arch, dtype), seed, params,
                                "cpu"), time.perf_counter() - t0)
    return out


def card_params(cfg, seed: int, label: str):
    """``init_lm(seed)`` drawn straight onto the card (the CPU draw's
    bits); prints its seconds and rate."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(t.numel() for t in leaves(params))
    print(f"[model] {label} seed {seed}: {cfg.num_layers} layers, init on "
          f"the card {dt:.1f} s ({n} params, {n / dt / 1e6:.0f} M params/s)")
    return params


def host_key(arch: str, seed: int) -> str:
    return f"{arch} check's CPU side, seed {seed}"


def host_runs() -> HostRuns:
    """The CPU sides of the dense and frontend model checks
    (``dense_host``, ``frontend_host``), in a thread on all host CPUs but
    two (``HostRuns``)."""
    jobs = [(host_key(arch, seed), functools.partial(dense_host, arch, seed))
            for arch in DENSE for seed in DENSE_SEEDS]
    jobs += [(host_key(arch, seed), functools.partial(frontend_host, arch,
                                                      seed))
             for arch in FRONTEND for seed in FRONTEND_SEEDS]
    return HostRuns(jobs, threads=max(1, len(os.sched_getaffinity(0)) - 2))


def dense_model_phase() -> None:
    """Card against CPU, over ``DENSE_SEEDS`` and in each dtype of
    ``DENSE_LIMITS``: the dense family's logits at full width cut in
    depth.  The CPU side comes from ``HOST_RUNS`` (``dense_host``); the
    card draws the same weights itself.  Each limit must hold for every
    seed and fail for the config's control at every seed."""
    for arch in DENSE:
        cfg = dense_config(arch)
        sound = {dtype: [] for dtype in DENSE_LIMITS[arch]}
        ctl = {dtype: [] for dtype in DENSE_LIMITS[arch]}
        for seed in DENSE_SEEDS:
            host_out, waited = HOST_RUNS.result(host_key(arch, seed))
            print(f"[model] {arch} seed {seed}: waited {waited:.1f} s for "
                  "its CPU side")
            on_card = card_params(cfg, seed, arch)
            for dtype in DENSE_LIMITS[arch]:
                host, t_host = host_out[dtype]
                for control, out in ((False, sound), (True, ctl)):
                    reset_counts()
                    with (wrong_attention()
                          if control and arch == "codeqwen1_5_7b"
                          else contextlib.nullcontext()):
                        got = serve_run(dense_config(arch, dtype, control),
                                        seed, on_card, "cuda")
                    n = read_counts()
                    want = (cfg.num_layers, 4 * cfg.num_layers)
                    check((n["flash_attention"], n["decode_attention"])
                          == want, f"{arch} check: launches {n}, want flash "
                          f"and decode {want}")
                    check(all(bool(torch.isfinite(g).all()) for g in got),
                          f"{arch} logits on the card not finite")
                    out[dtype].append({name: _rel_norm(g, h) for name, g, h
                                       in zip(("prefill", "decode"), got,
                                              host)})
                    label = "control" if control else "card vs CPU"
                    print(f"[model] {arch} {cfg.num_layers} layers {dtype}, "
                          f"{label}, seed {seed}: " + " ".join(
                              f"{k}={v:.3e}" for k, v in
                              out[dtype][-1].items())
                          + (f" (CPU run {t_host:.1f} s, in the thread)"
                             if not control else ""))
            del host_out, on_card
        check_limits(arch, DENSE_LIMITS[arch], sound, ctl)


def check_limits(arch: str, limits_by_dtype, sound, ctl) -> None:
    """Each limit must hold for the worst sound reading over the seeds and
    fail for the control's least."""
    for dtype, limits in limits_by_dtype.items():
        for name, limit in limits.items():
            worst = max(r[name] for r in sound[dtype])
            least = min(r[name] for r in ctl[dtype])
            print(f"[model] {arch} {dtype} {name}: worst sound "
                  f"{worst:.3e}, limit {limit:.1e}, least control "
                  f"{least:.3e}")
            check(worst <= limit, f"{arch} {dtype}: card disagrees with "
                  f"the CPU ({name} {worst:.3e} > {limit:.1e})")
            check(least > limit, f"{arch} {dtype}: the control passes "
                  f"the {name} limit ({least:.3e} <= {limit:.1e}); the "
                  "check cannot see it")


@contextlib.contextmanager
def timed_init(times):
    """``transformer.init_lm`` wrapped so that each call's seconds (the
    draw on the host and its copies to the card) and its count of params
    land in ``times``."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    plain = T.init_lm

    def init_lm(*args, **kwargs):
        t0 = time.perf_counter()
        params = plain(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0,
                      sum(t.numel() for t in leaves(params))))
        return params

    T.init_lm = init_lm
    try:
        yield
    finally:
        T.init_lm = plain


def serve_path(paths, label: str, arch: str, extra, B: int, prompt: int,
               steps: int, captured=None, prefill=None, step=None):
    """``launch.serve --arch <arch>`` at full width and depth, with
    ``extra`` flags: rc 0, the reference's three lines, the launches of
    ``prefill`` a prefill and of ``step`` a decode step (by default
    ``flash_attention`` once per layer and ``decode_attention`` once per
    layer), every flash launch on the wgmma route, and one ``init_lm``
    (its seconds and rate printed).  ``captured``, where given, takes the
    prefill (``capturing_prefill``).  -> the config."""
    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = configs.get_config(arch)
    inits = []
    argv = ["--arch", arch] + extra
    with (capturing_prefill(captured) if captured is not None
          else contextlib.nullcontext()), timed_init(inits):
        launches, (rc, text), wall = run_path(
            label, lambda: _captured(serve.main, argv),
            ("flash_attention", "decode_attention"), "wgmma")
    paths[label] = launches
    check(rc == 0, f"{label}: launch.serve exited {rc}")
    lines = {}
    for key, line in (
            ("prefill", f"[serve] prefill {prompt} tokens x {B} requests: "),
            ("decode", f"[serve] decoded {steps} steps x {B} requests: "),
            ("sample", "[serve] sample continuation (request 0): ")):
        check(line in text, f"{label}: no line {line!r}")
        lines[key] = text.split(line)[1].split("ms")[0]
    prefill = prefill or dict(flash_attention=cfg.num_layers)
    step = step or dict(decode_attention=cfg.num_layers)
    want = {k: prefill.get(k, 0) + steps * step.get(k, 0) for k in launches}
    check(launches == want, f"{label}: launches {launches}, want {want} "
          f"(one prefill, {steps} decode steps)")
    check(len(inits) == 1, f"{label}: {len(inits)} init_lm calls")
    (init_s, n), = inits
    print(f"[path] {label}: rc={rc} {cfg.param_count()} params; per "
          f"prefill {prefill}, per decode step {step}; init {init_s:.3f} s ({n} "
          f"params drawn and copied, {n / init_s / 1e6:.0f} M params/s), "
          f"prefill {lines['prefill']} ms, wall per decode step "
          f"{float(lines['decode']) / steps:.3f} ms, path wall {wall:.3f} s")
    return cfg


def dense_serve_paths(paths) -> None:
    """``launch.serve`` at full width and full depth for the dense family
    (``serve_path``): codeqwen1_5_7b and chatglm3_6b with the reference's
    defaults (8 x 32, 32 decode steps, max_seq 128), gemma3_4b with a
    1152-token prompt into max_seq 1280 (its local layers' 1024-slot rings
    roll and the window bites; its 4 global layers hold all 1168
    positions) and 16 decode steps.  Then codeqwen's int8 KV cache from
    the captured params (``int8_ms2m``)."""
    runs = (
        ("serve-cq", "codeqwen1_5_7b", [], 8, 32, 32),
        ("serve-glm", "chatglm3_6b", [], 8, 32, 32),
        ("serve-g3-long", "gemma3_4b", ["--requests", "2", "--prompt-len",
                                        "1152", "--max-seq", "1280",
                                        "--decode-steps", "16"], 2, 1152, 16))
    for label, arch, extra, B, prompt, steps in runs:
        captured = {} if label == "serve-cq" else None
        cfg = serve_path(paths, label, arch, extra, B, prompt, steps,
                         captured)
        if label == "serve-cq":
            paths["serve-cq-int8-ms2m"] = int8_ms2m(cfg, captured)
            captured.clear()
        torch.cuda.empty_cache()


def int8_ms2m(cfg, captured) -> dict:
    """codeqwen1_5_7b with ``kv_cache_dtype="int8"`` from ``serve-cq``'s
    params (no second init): a prefill of its prompts (8 x 32) into an
    int8 cache, whose K/V quantizations must equal the CPU's bit for bit
    on the same inputs, then the cache through the registry and 8 decode
    steps from the pulled copy bit-equal to the source's (``ms2m_state``).
    The image holds 272,629,760 bytes of K/V and scales (the bf16 cache
    536,870,912), pos leaves aside.  -> launches."""
    import dataclasses

    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.train import step as steplib

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params, batch = captured["params"], captured["batch"]
    B, prompt = batch["tokens"].shape
    bf16_kv = sum(c[n].nbytes for c in captured["cache"].values()
                  for n in ("k", "v"))
    quantized, prefilled = [], {}
    plain = attention._quantize_kv

    def recording(x):
        q, scale = plain(x)
        quantized.append((x.clone(), q, scale))
        return q, scale

    def prefill():
        cache = T.init_cache(cfg8, B, 128, device="cuda")
        attention._quantize_kv = recording
        try:
            logits, cache = steplib.build_prefill_step(cfg8)(params, cache,
                                                             batch)
        finally:
            attention._quantize_kv = plain
        prefilled["cache"] = cache
        return params, logits, cache

    kv8 = 2 * cfg.num_layers * B * 128 * cfg.num_kv_heads * (
        cfg.resolved_head_dim + 2)
    pos = cfg.num_layers * B * 128 * 4
    launches = ms2m_state("serve-cq-int8-ms2m", cfg8, prefill,
                          ("flash_attention", "decode_attention",
                           "fingerprint_lanes"), kv8 + pos)
    cache = prefilled["cache"]  # as the prefill left it: decoding cloned it
    check(launches["flash_attention"] == cfg.num_layers
          and launches["decode_attention"] == 16 * cfg.num_layers,
          f"serve-cq-int8-ms2m: launches {launches}, want one prefill and "
          "16 decode steps (8 from the source, 8 from the pulled copy)")
    # each layer's prefill quantized its K, then its V
    check(len(quantized) == 2 * cfg.num_layers,
          f"int8: {len(quantized)} quantizer calls in the prefill, want "
          f"{2 * cfg.num_layers}")
    same = 0
    for g in range(cfg.num_layers):
        for j, (q_name, s_name) in enumerate((("k", "k_scale"),
                                              ("v", "v_scale"))):
            x, q, scale = quantized[2 * g + j]
            hq, hs = plain(x.cpu())
            leaf_q = cache["b0"][q_name][g, :, :prompt].cpu()
            leaf_s = cache["b0"][s_name][g, :, :prompt].cpu()
            same += (torch.equal(q.cpu(), hq) and torch.equal(scale.cpu(), hs)
                     and torch.equal(leaf_q, hq) and torch.equal(leaf_s, hs))
    check(same == 2 * cfg.num_layers,
          f"int8: {2 * cfg.num_layers - same} of {2 * cfg.num_layers} "
          "quantized K/V leaves differ between card and CPU")
    check(kv8 == 272_629_760 and bf16_kv == 536_870_912,
          f"int8: K/V and scales {kv8} bytes, bf16 cache {bf16_kv}")
    print(f"[path] serve-cq-int8-ms2m: k, v, k_scale and v_scale of all "
          f"{cfg.num_layers} layers bit-identical card and CPU from the "
          f"same prefill inputs; image {kv8 + pos} bytes ({kv8} of K/V and "
          f"scales, {pos} of pos) against {bf16_kv} of K/V in serve-cq's "
          f"bf16 cache ({kv8 / bf16_kv:.4f}x)")
    return launches


# The MoE slice, card against CPU: granite_moe_1b_a400m at full width (32
# experts top-8, d_model 1024, d_ff 512 an expert) cut to MOE_LAYERS of its
# 24 layers so that the CPU runs it too, and llama4_maverick_400b_a17b's
# smoke config as it is (a dense and an MoE layer, 4 experts top-1 with a
# shared expert; its full size, 397.7 B params, fits no card).  Relative
# L2 error of the logits of a prefill of 8 x 32 tokens and of 4 decode
# steps (launch.serve's shapes), worst over MOE_SEEDS, in bf16 compute and
# in float32, and the share of the first MoE layer's (token, k) expert
# picks (prefill and decode) that differ between card and CPU ("picks":
# the later layers' inputs differ through the earlier picks); the control
# takes each token's experts from the lowest router probabilities instead
# of the highest (moe.top_k inverted), a routing break.  The picks that
# differ in every MoE layer and the prefill's capacity drops are printed.
# In bf16 a router logit one rounding apart swaps a pick and the token's
# output with it, and the swaps compound over the layers; in llama4's
# top-1 smoke config two swapped decode picks of 32 move its decode logits
# by 0.36.  So the bf16 logits limits have little room on either side,
# and the first layer's picks are the firmer bf16 check (PERF.md, the MoE
# finding: on an H100 over seeds 0-1, worst sound / least control: bf16
# logits 0.153 / 1.413 granite and 0.362 / 1.355 llama4, picks 7.4e-3 /
# 1.0; float32 logits 2.5e-6 / 1.355, no pick differing).
MOE = ("granite_moe_1b_a400m", "llama4_maverick_400b_a17b")
MOE_LAYERS = 4
MOE_SEEDS = (0, 1)
_MOE_BF16 = dict(prefill=8e-1, decode=8e-1, picks=3e-2)
_MOE_F32 = dict(prefill=2e-4, decode=2e-4, picks=1e-3)
MOE_LIMITS = {arch: {"bfloat16": _MOE_BF16, "float32": _MOE_F32}
              for arch in MOE}


def moe_config(arch: str, dtype: str = "bfloat16"):
    """granite at full width cut to ``MOE_LAYERS`` layers, or llama4's smoke
    config, computing in ``dtype``."""
    import dataclasses

    from repro_torch import configs

    if arch == "granite_moe_1b_a400m":
        return dataclasses.replace(configs.get_config(arch), dtype=dtype,
                                   num_layers=MOE_LAYERS)
    return dataclasses.replace(configs.get_smoke(arch), dtype=dtype)


@contextlib.contextmanager
def recording_picks(picks, control: bool = False):
    """``moe._router`` wrapped so that each call's expert picks [B,S,K] land
    in ``picks`` (on the CPU); ``control`` takes the top-k from the lowest
    router probabilities."""
    from repro_torch.models import moe

    plain_router = moe._router

    def router(params, xf, cfg):
        out = plain_router(params, xf, cfg)
        picks.append(out[1].cpu())
        return out

    def lowest(probs, k):
        vals, ids = torch.sort(probs, dim=-1, stable=True)
        return vals[..., :k], ids[..., :k]

    with main_thread_patch(moe, _router=router,
                           **(dict(top_k=lowest) if control else {})):
        yield


def moe_model_phase() -> None:
    """Card against CPU, over ``MOE_SEEDS`` and in each dtype of
    ``MOE_LIMITS``, for each config of ``MOE`` (``moe_config``): the
    logits of ``serve_run``, each limit holding for every seed and failing
    for the control (``recording_picks(control=True)``) at every seed;
    per MoE layer, the (token, k) picks that differ between card and CPU,
    and the prefill's capacity drops."""
    from repro_torch.models import BlockKind
    from repro_torch.models import moe

    for arch in MOE:
        cfg = moe_config(arch)
        n_moe = sum(f == BlockKind.MOE for _, f in cfg.pattern) * (
            cfg.num_groups)
        sound = {dtype: [] for dtype in MOE_LIMITS[arch]}
        ctl = {dtype: [] for dtype in MOE_LIMITS[arch]}
        grad = {"float32": []}, {"float32": []}
        for seed in MOE_SEEDS:
            params, on_card = host_and_card(cfg, seed, arch)
            for dtype in MOE_LIMITS[arch]:
                dcfg = moe_config(arch, dtype)
                host_picks = []
                t0 = time.perf_counter()
                with recording_picks(host_picks):
                    host = serve_run(dcfg, seed, params, "cpu")
                t_host = time.perf_counter() - t0
                cap = moe.expert_capacity(dcfg, 32)
                drops = [int(torch.clamp(torch.nn.functional.one_hot(
                    ids.reshape(ids.shape[0], -1), dcfg.num_experts).sum(1)
                    - cap, min=0).sum()) for ids in host_picks[:n_moe]]
                for control, out in ((False, sound), (True, ctl)):
                    picks = []
                    reset_counts()
                    with recording_picks(picks, control):
                        got = serve_run(dcfg, seed, on_card, "cuda")
                    n = read_counts()
                    want = (cfg.num_layers, 4 * cfg.num_layers)
                    check((n["flash_attention"], n["decode_attention"])
                          == want, f"{arch} check: launches {n}, want flash "
                          f"and decode {want}")
                    check(len(picks) == len(host_picks) == 5 * n_moe,
                          f"{arch}: {len(picks)} router calls on the card, "
                          f"{len(host_picks)} on the CPU, want {5 * n_moe}")
                    check(all(bool(torch.isfinite(g).all()) for g in got),
                          f"{arch} logits on the card not finite")
                    # (token, k) picks that differ, per MoE layer: the
                    # prefill's, then the 4 decode steps' together
                    differ = [int((a != b).sum())
                              for a, b in zip(picks, host_picks)]
                    per_layer = [
                        (differ[i], sum(differ[i + n_moe * t]
                                        for t in range(1, 5)))
                        for i in range(n_moe)]
                    first = host_picks[::n_moe]
                    out[dtype].append(dict(
                        {name: _rel_norm(g, h) for name, g, h
                         in zip(("prefill", "decode"), got, host)},
                        picks=sum(per_layer[0]) / sum(p.numel()
                                                      for p in first)))
                    label = "control" if control else "card vs CPU"
                    print(f"[model] {arch} {cfg.num_layers} layers {dtype}, "
                          f"{label}, seed {seed}: " + " ".join(
                              f"{k}={v:.3e}" for k, v in
                              out[dtype][-1].items())
                          + f"; picks differing per MoE layer (prefill of "
                          f"{host_picks[0].numel()}, decode of "
                          f"{4 * host_picks[n_moe].numel()}): {per_layer}"
                          + (f"; prefill drops per layer at capacity {cap}: "
                             f"{drops} (CPU run {t_host:.1f} s)"
                             if not control else ""))
            if arch in GRAD_LIMITS:
                for out, r in zip(grad, grad_gate(
                        arch, cfg, params, on_card, seed,
                        dict(flash_attention=cfg.num_layers),
                        FollowPicks())):
                    out["float32"].append(r)
            del params, on_card
        check_limits(arch, MOE_LIMITS[arch], sound, ctl)
        if arch in GRAD_LIMITS:
            check_limits(f"{arch} gradient gate",
                         {"float32": GRAD_LIMITS[arch]}, *grad)


def moe_serve_paths(paths) -> None:
    """``launch.serve --arch granite_moe_1b_a400m`` at full width and depth
    with the reference's defaults (``serve_path``: 8 x 32, 32 decode steps,
    max_seq 128; 24 flash launches a prefill and 24 decode launches a
    step), then its cache after prefill through the registry from the
    captured params (``serve-granite-ms2m``: K and V of 24 layers x 8 x 128
    slots x 8 kv heads x 64 in bf16, 50,331,648 bytes, and 98,304 bytes of
    pos), 8 decode steps from the pulled copy bit-equal to the source's."""
    captured = {}
    cfg = serve_path(paths, "serve-granite", "granite_moe_1b_a400m", [], 8,
                     32, 32, captured)
    kv = 2 * cfg.num_layers * 8 * 128 * cfg.num_kv_heads * (
        cfg.resolved_head_dim * 2)
    pos = cfg.num_layers * 8 * 128 * 4
    check(kv == 50_331_648 and pos == 98_304, f"granite: K/V {kv} bytes, "
          f"pos {pos}")
    launches = ms2m_state("serve-granite-ms2m", cfg, captured,
                          ("fingerprint_lanes", "decode_attention"),
                          kv + pos)
    check(launches["decode_attention"] == 16 * cfg.num_layers
          and launches["flash_attention"] == 0,
          f"serve-granite-ms2m: launches {launches}, want 16 decode steps "
          "(8 from the source, 8 from the pulled copy) and no prefill")
    paths["serve-granite-ms2m"] = launches
    captured.clear()
    torch.cuda.empty_cache()


# The encoder-decoder and M-RoPE slice, card against CPU.  whisper_large_v3
# at full width (d_model 1280, 20 heads of 64, vocab 51,866) cut to 2
# encoder + 2 decoder layers, B 2 with its 1500 audio frames kept: the
# logits of a prefill of 32 tokens and of 4 decode steps (each decode step
# recomputes the cross-attention over the 1500 frames); the control runs
# the encoder causal, what a kernel that ignored causal=False would give.
# qwen2_vl_72b at full width (d_model 8192, 64 heads over 8 of 128, d_ff
# 29568, vocab 152,064, untied) cut to 2 of its 80 layers, B 1: a prefill
# of 288 tokens (256 image patches from token 1) under image ids
# (``image_ids``: within the patch span h and w walk a 16 x 16 grid) and
# 4 decode steps; the control feeds the same input t = h = w ids.  Beside
# it, ``apply_mrope`` itself card against CPU at the layer's q and k
# shapes under the image ids (float32, max abs), the sections permuted
# (24, 24, 16) as its control.  Worst over FRONTEND_SEEDS, bf16 and
# float32; each limit lies between the sound readings and the control's
# (PERF.md, the whisper and qwen2-vl finding: on an H100 over seeds 0-1,
# worst sound /
# least control, prefill and decode: whisper bf16 4.9e-3 and 5.2e-3 /
# 0.312 and 0.325, float32 9.8e-7 and 7.4e-7 / 0.312 and 0.325; qwen2-vl
# bf16 8.4e-3 and 3.4e-3 / 0.311 and 2.54e-2, float32 4.0e-6 and 1.1e-6
# / 0.311 and 2.47e-2).  The control's ids differ only at the 256 image
# positions, and a decode token's own ids are t = h = w in both runs, so
# it moves qwen2-vl's decode logits less than its prefill's (only through
# the cached keys of the image span): the bf16 decode limit has 2.9x room
# above the sound readings and 2.5x below the control.
FRONTEND = ("whisper_large_v3", "qwen2_vl_72b")
FRONTEND_SEEDS = (0, 1)
WHISPER_LIMITS = {"bfloat16": dict(prefill=5e-2, decode=5e-2),
                  "float32": dict(prefill=2e-4, decode=2e-4)}
QVL_LIMITS = {"bfloat16": dict(prefill=5e-2, decode=1e-2),
              "float32": dict(prefill=2e-4, decode=2e-4)}
# leaves whose gradient on the card must not be all zero in whisper's
# gradient gate: the encoder's, the cross-attention's and the learned
# decoder positions (tests/test_torch_whisper.py asserts them on the CPU)
WHISPER_NONZERO = ("encoder/groups/b0/attn/wq", "groups/b0/cross_attn/wk",
                   "dec_pos_embed")
# apply_mrope, float32 max abs: an ulp of a frequency (CUDA's powf against
# the host's) moves an angle of up to 288 rad by up to 2e-5 and an output
# of |x| ~ 4 by up to 1e-4; a permuted section moves it by O(1)
MROPE_LIMIT = 1e-3
QVL_PATCH_SIDE = 16  # 256 patches: a 16 x 16 grid
# serve-qwen2vl-4l: qwen2_vl_72b at full width cut to 4 of its 80 layers
# (6.00 B params, 24 GB in float32; all 80 are 72.7 B, 291 GB, which fit
# no card), driven through the port's step functions, since launch.serve
# has no depth flag
QVL_LAYERS = 4


def image_ids(B: int, S: int, P: int, side: int):
    """[3,B,S] int32 M-RoPE ids of a prompt with ``P`` image patches from
    token 1: t = 0..S-1; patch j has h = 1 + j // side and w = 1 + j %
    side; h = w = t outside the patch span."""
    t = torch.arange(S, dtype=torch.int32)
    h, w = t.clone(), t.clone()
    j = torch.arange(P, dtype=torch.int32)
    h[1:P + 1] = 1 + j // side
    w[1:P + 1] = 1 + j % side
    return torch.stack([t, h, w])[:, None].expand(3, B, S).contiguous()


def whisper_config(dtype: str = "bfloat16"):
    """whisper_large_v3 at full width cut to 2 encoder + 2 decoder layers."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("whisper_large_v3"),
                               dtype=dtype, num_layers=2,
                               num_encoder_layers=2)


def qvl_config(dtype: str = "bfloat16", layers: int = 2):
    """qwen2_vl_72b at full width cut to ``layers`` layers."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("qwen2_vl_72b"),
                               dtype=dtype, num_layers=layers)


def whisper_run(cfg, seed: int, params, device: str):
    """``lm_prefill`` of 2 prompts of 32 tokens with 1500 audio frames each
    into a max_seq-128 cache, then 4 teacher-forced decode steps.
    -> (prefill, decode logits), float32."""
    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 36)).astype(np.int32)
    frames = rng.normal(0, 0.02, (2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        cache = T.init_cache(cfg, 2, 128, device=device)
        pre, cache = T.lm_prefill(
            params, {"tokens": to_tensor(toks[:, :32], device),
                     "frames": to_tensor(frames, device)}, cfg, cache)
        dec = []
        for t in range(32, 36):
            pos = torch.full((2, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return pre.float(), torch.cat(dec, 1).float()


@contextlib.contextmanager
def causal_encoder():
    """The control of the whisper check: ``transformer._run_groups`` with
    ``causal=True`` forced, so the encoder runs causal."""
    from repro_torch.models import transformer as T

    plain = T._run_groups

    def run_groups(*args, **kwargs):
        return plain(*args, **{**kwargs, "causal": True})

    with main_thread_patch(T, _run_groups=run_groups):
        yield


def qvl_run(cfg, seed: int, params, device: str, flat_ids: bool = False):
    """``lm_prefill`` of one 288-token prompt (256 image patches from token
    1) under ``image_ids`` into a max_seq-320 cache, then 4 teacher-forced
    decode steps with [3,1,1] ids; ``flat_ids`` gives every token t = h =
    w (the control).  -> (prefill, decode logits), float32."""
    import numpy as np

    from repro_torch.convert import to_tensor
    from repro_torch.models import transformer as T

    S, P = 288, cfg.num_patches
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (1, S + 4)).astype(np.int32)
    patches = rng.normal(0, 0.02, (1, P, cfg.d_model)).astype(np.float32)
    ids = image_ids(1, S, P, QVL_PATCH_SIDE)
    if flat_ids:
        ids = ids[:1].expand(3, 1, S).contiguous()
    with torch.no_grad():
        cache = T.init_cache(cfg, 1, 320, device=device)
        pre, cache = T.lm_prefill(
            params, {"tokens": to_tensor(toks[:, :S], device),
                     "patch_embeds": to_tensor(patches, device),
                     "positions": ids.to(device)}, cfg, cache)
        dec = []
        for t in range(S, S + 4):
            pos = torch.full((3, 1, 1), t, dtype=torch.int32, device=device)
            lg, cache = T.lm_decode_step(
                params, to_tensor(toks[:, t:t + 1], device), pos, cfg, cache)
            dec.append(lg)
    return pre.float(), torch.cat(dec, 1).float()


def frontend_checks():
    """{arch: (config maker, run, limits, control context or None (qvl's
    control is ``flat_ids``), flash and decode launches of a card run)}."""
    return {
        "whisper_large_v3": (
            whisper_config, whisper_run, WHISPER_LIMITS, causal_encoder,
            # a prefill: 2 encoder + 2 self + 2 cross; a decode step: 2
            # cross (flash, Sq 1) and 2 self (decode)
            dict(flash_attention=6 + 4 * 2, decode_attention=4 * 2)),
        "qwen2_vl_72b": (
            qvl_config, qvl_run, QVL_LIMITS, None,
            dict(flash_attention=2, decode_attention=4 * 2)),
    }


def frontend_host(arch: str, seed: int) -> dict:
    """The CPU side of ``arch``'s check for ``seed``, from ``init_lm(seed)``
    drawn on the CPU: its run in each dtype, then (whisper) the gradient
    gate's float32 step on the same draw.  -> {dtype: (logits, seconds)},
    and under "grad" ``grad_gate``'s ``host`` tuple."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    make_cfg, run, limits, _, _ = frontend_checks()[arch]
    cfg = make_cfg()
    params = T.init_lm(cfg, seed=seed, device="cpu")
    out = {}
    for dtype in limits:
        t0 = time.perf_counter()
        out[dtype] = (run(make_cfg(dtype), seed, params, "cpu"),
                      time.perf_counter() - t0)
    if arch in GRAD_LIMITS:
        t0 = time.perf_counter()
        loss, grads, norm, terms = grad_step(cfg, params, seed, "cpu")
        out["grad"] = (loss, grads, norm, terms, leaves(params),
                       time.perf_counter() - t0)
    return out


def frontend_model_phase() -> None:
    """Card against CPU, over ``FRONTEND_SEEDS`` and in bf16 and float32:
    whisper's logits (``whisper_run``; control ``causal_encoder``) and
    qwen2-vl's (``qvl_run``; control ``flat_ids``), each limit holding for
    every seed and failing for the control at every seed, with the flash
    and decode launches of each card run checked; whisper's float32
    gradient gate (``grad_gate``, ``GRAD_LIMITS``) on each seed's draw;
    then ``apply_mrope`` card against CPU (``MROPE_LIMIT``).  The CPU
    sides come from ``HOST_RUNS`` (``frontend_host``); the card draws the
    same weights itself."""
    for arch, (make_cfg, run, limits, control_ctx,
               want) in frontend_checks().items():
        cfg = make_cfg()
        sound = {dtype: [] for dtype in limits}
        ctl = {dtype: [] for dtype in limits}
        grad = {"float32": []}, {"float32": []}
        for seed in FRONTEND_SEEDS:
            host_out, waited = HOST_RUNS.result(host_key(arch, seed))
            print(f"[model] {arch} seed {seed}: waited {waited:.1f} s for "
                  "its CPU side")
            on_card = card_params(cfg, seed, arch)
            for dtype in limits:
                host, t_host = host_out[dtype]
                for control, out in ((False, sound), (True, ctl)):
                    reset_counts()
                    if control_ctx is None:
                        got = run(make_cfg(dtype), seed, on_card, "cuda",
                                  flat_ids=control)
                    else:
                        with (control_ctx() if control
                              else contextlib.nullcontext()):
                            got = run(make_cfg(dtype), seed, on_card, "cuda")
                    n = read_counts()
                    check({k: n[k] for k in want} == want,
                          f"{arch} check: launches {n}, want {want}")
                    check(all(bool(torch.isfinite(g).all()) for g in got),
                          f"{arch} logits on the card not finite")
                    out[dtype].append({name: _rel_norm(g, h) for name, g, h
                                       in zip(("prefill", "decode"), got,
                                              host)})
                    label = "control" if control else "card vs CPU"
                    print(f"[model] {arch} {cfg.num_layers} layers {dtype}, "
                          f"{label}, seed {seed}: " + " ".join(
                              f"{k}={v:.3e}" for k, v in
                              out[dtype][-1].items())
                          + (f" (CPU run {t_host:.1f} s, in the thread)"
                             if not control else ""))
            if arch in GRAD_LIMITS:
                for out, r in zip(grad, grad_gate(
                        arch, cfg, None, on_card, seed,
                        dict(flash_attention=cfg.num_encoder_layers
                             + 2 * cfg.num_layers),
                        nonzero=WHISPER_NONZERO, host=host_out["grad"])):
                    out["float32"].append(r)
            del host_out, on_card
        check_limits(arch, limits, sound, ctl)
        if arch in GRAD_LIMITS:
            check_limits(f"{arch} gradient gate",
                         {"float32": GRAD_LIMITS[arch]}, *grad)
    mrope_check()


def mrope_check() -> None:
    """``apply_mrope`` on the card against the CPU at qwen2-vl's layer
    shapes (q [1,288,64,128], k [1,288,8,128], float32) under
    ``image_ids``: the largest difference within ``MROPE_LIMIT``, and the
    sections permuted (24, 24, 16) on the card outside it."""
    from repro_torch.models import common

    cfg = qvl_config()
    gen = torch.Generator().manual_seed(0)
    ids = image_ids(1, 288, cfg.num_patches, QVL_PATCH_SIDE)
    for name, H in (("q", cfg.num_heads), ("k", cfg.num_kv_heads)):
        x = torch.randn((1, 288, H, cfg.resolved_head_dim), generator=gen)
        want = common.apply_mrope(x, ids, cfg.mrope_sections, cfg.rope_theta)
        got, permuted = (
            common.apply_mrope(x.cuda(), ids.cuda(), secs,
                               cfg.rope_theta).cpu()
            for secs in (cfg.mrope_sections, (24, 24, 16)))
        err = float((got - want).abs().max())
        ctl = float((permuted - want).abs().max())
        print(f"[model] apply_mrope {name} {list(x.shape)} card vs CPU: "
              f"max_abs={err:.3e}, limit {MROPE_LIMIT:.1e}, control "
              f"(sections (24, 24, 16)) {ctl:.3e}")
        check(err <= MROPE_LIMIT, f"apply_mrope {name}: card disagrees with "
              f"the CPU ({err:.3e})")
        check(ctl > MROPE_LIMIT, f"apply_mrope {name}: the control passes "
              f"({ctl:.3e})")


def whisper_serve_paths(paths) -> None:
    """``launch.serve --arch whisper_large_v3`` at full width and depth
    with the reference's defaults (``serve_path``: 8 x 32 with 1500 audio
    frames each, 32 decode steps, max_seq 128; a prefill launches flash 96
    times: 32 encoder, 32 self, 32 cross layers; a decode step 32 decode
    and 32 flash launches, the cross-attention over the 1500 frames
    recomputed in every decoder layer, as in the reference), then its
    cache after prefill through the registry (``serve-whisper-ms2m``: K
    and V of 32 layers x 8 x 128 slots x 20 heads x 64 in bf16,
    167,772,160 bytes, pos 131,072 and ``enc_out`` 8 x 1500 x 1280 in
    bf16, 30,720,000), 8 decode steps from the pulled copy bit-equal to
    the source's."""
    captured = {}
    L = 32
    cfg = serve_path(paths, "serve-whisper", "whisper_large_v3", [], 8, 32,
                     32, captured, prefill=dict(flash_attention=3 * L),
                     step=dict(flash_attention=L, decode_attention=L))
    check(cfg.num_layers == cfg.num_encoder_layers == L,
          f"whisper: {cfg.num_layers} + {cfg.num_encoder_layers} layers")
    kv = 2 * L * 8 * 128 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    pos = L * 8 * 128 * 4
    enc = 8 * cfg.encoder_seq * cfg.d_model * 2
    check(kv + pos + enc == 198_623_232, f"whisper: K/V {kv}, pos {pos}, "
          f"enc_out {enc} bytes")
    launches = ms2m_state("serve-whisper-ms2m", cfg, captured,
                          ("fingerprint_lanes", "decode_attention",
                           "flash_attention"), kv + pos + enc, "wgmma")
    check(launches["decode_attention"] == 16 * L
          and launches["flash_attention"] == 16 * L,
          f"serve-whisper-ms2m: launches {launches}, want 16 decode steps "
          "(8 from the source, 8 from the pulled copy) of 32 decode and 32 "
          "flash (cross) launches, and no prefill")
    paths["serve-whisper-ms2m"] = launches
    captured.clear()
    torch.cuda.empty_cache()


def qvl_serve_path(paths) -> None:
    """qwen2_vl_72b at full width cut to ``QVL_LAYERS`` layers through the
    port's ``build_prefill_step`` / ``build_decode_step``: B 8, a 288-token
    prompt (256 image patches from token 1, then 31 text tokens) under
    ``image_ids`` into a max_seq-320 cache, 32 greedy decode steps with
    [3,B,1] ids; 4 flash launches a prefill (wgmma) and 4 decode launches
    a step, finite logits, init, prefill and decode step times printed."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.train import step as steplib
    from repro_torch.tree import leaves

    cfg = qvl_config("bfloat16", QVL_LAYERS)
    B, S, steps, max_seq = 8, 288, 32, 320
    P = cfg.num_patches
    label = "serve-qwen2vl-4l"

    def run():
        t0 = time.perf_counter()
        params = T.init_lm(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        batch = {
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda(),
            "patch_embeds": torch.from_numpy(rng.normal(
                0, 0.02, (B, P, cfg.d_model)).astype(np.float32)).cuda(),
            "positions": image_ids(B, S, P, QVL_PATCH_SIDE).cuda()}
        prefill = steplib.build_prefill_step(cfg)
        decode = steplib.build_decode_step(cfg)
        cache = T.init_cache(cfg, B, max_seq, device="cuda")
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = prefill(params, cache, batch)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            after_prefill = read_counts()
            finite = bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            pos = torch.full((3, B, 1), S, dtype=torch.int32, device="cuda")
            out = [tok]
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = decode(params, cache, tok, pos)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                pos = pos + 1
                out.append(tok)
            torch.cuda.synchronize()
            t_decode = time.perf_counter() - t0
            finite &= bool(torch.isfinite(logits).all())
        n = sum(t.numel() for t in leaves(params))
        del params, cache, logits
        return (init_s, n, t_prefill, t_decode, after_prefill, finite,
                torch.cat(out, 1)[0, :16].tolist())

    launches, (init_s, n, t_prefill, t_decode, after_prefill, finite,
               sample), wall = run_path(
        label, run, ("flash_attention", "decode_attention"), "wgmma")
    paths[label] = launches
    L = QVL_LAYERS
    want_prefill = dict(flash_attention=L, decode_attention=0)
    check({k: after_prefill[k] for k in want_prefill} == want_prefill,
          f"{label}: prefill launches {after_prefill}, want {want_prefill}")
    want = {k: 0 for k in launches}
    want.update(flash_attention=L, decode_attention=steps * L)
    check(launches == want, f"{label}: launches {launches}, want {want}")
    check(finite, f"{label}: logits not finite")
    print(f"[path] {label}: {cfg.dtype} compute, {L} of qwen2_vl_72b's 80 "
          f"layers (all 80 are 72.7 B params, 291 GB in float32, and fit "
          f"no card): {cfg.param_count()} params; per prefill flash="
          f"{L}, per decode step decode_attention={L}; init {init_s:.3f} s "
          f"({n} params drawn and copied, {n / init_s / 1e6:.0f} M "
          f"params/s), prefill {S} tokens x {B} requests "
          f"{t_prefill * 1e3:.0f} ms, wall per decode step "
          f"{t_decode / steps * 1e3:.3f} ms, path wall {wall:.3f} s; "
          f"sample continuation (request 0) {sample}")
    torch.cuda.empty_cache()


def trainer_migration_paths(paths) -> None:
    """A paper-consumer ``TrainerWorker`` at full width migrated through
    ``ms2m_statefulset`` and through ``ms2m_precopy`` with int8 deltas,
    each verified bit for bit against the reference fold on the card."""
    from repro_torch import configs
    from repro_torch.cluster import TimingConstants
    from repro_torch.core import MigrationPolicy, run_migration_experiment
    from repro_torch.kernels import build

    layers = configs.get_config("paper_consumer").num_layers
    make = trainer_factory("cuda")
    runs = (
        ("trainer-statefulset", "ms2m_statefulset",
         dict(seed=0, t_migrate=5.0, settle_time=2.0),
         ("flash_attention", "fingerprint_lanes")),
        ("trainer-precopy-int8", "ms2m_precopy",
         dict(seed=7, t_migrate=5.0, timings=TimingConstants(**WAN_TIMINGS),
              chunk_bytes=64 * 1024,
              policy=MigrationPolicy(compression="int8",
                                     precopy_max_rounds=8,
                                     precopy_converge_ratio=100.0)),
         ("flash_attention", "fingerprint_lanes", "int8_fp_lanes")),
    )
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for label, strategy, kw, needs in runs:
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
            launches, r, wall = run_path(
                label, lambda: run_migration_experiment(
                    strategy, 4.0, registry_root=root, worker_factory=make,
                    **kw), needs, "tf32x3")
        paths[label] = launches
        row = r.row()
        steps = launches["flash_attention"] // layers
        print(f"[path] {label}: verified={r.verified} downtime="
              f"{row['downtime']} replayed={r.report.replayed_messages} "
              f"precopy_rounds={row['precopy_rounds']} image_raw_bytes="
              f"{row['image_raw_bytes']} image_wire_bytes="
              f"{row['image_wire_bytes']} train_steps={steps} "
              f"wall_per_step_ms={wall / max(steps, 1) * 1e3:.3f}")
        check(r.verified, f"{label}: migrated trainer differs from the "
              "reference fold")
        check(r.report.replayed_messages > 0, f"{label}: nothing replayed")


# what the JAX package's examples print on the CPU (examples/*.py): the
# virtual times, counts and verdicts, which do not depend on the device,
# so the port's examples must print them on the card too
EXAMPLE_LINES = {
    "ex-quickstart": (
        "MS2M migration: migration_time=64.82s downtime=1.40s",
        "migrated state verified bit-exact: True"),
    "ex-engine": (
        "engine migration: migration_time=65.00s downtime=1.40s",
        "requests served by target engine: 180",
        "migrated engine state verified: True"),
    "ex-trainer": (
        "trainer at virtual t=15s: step=74 loss=",
        "migration done: migration_time=61.17s downtime=36.16s",
        "target trainer resumed: step=417 loss=",
        "replayed reference fold matches migrated trainer: True"),
}
# examples/live_migration_serving.py's paper-faithful ms2m_cutoff at 16/s
LIVE_PAPER_FAITHFUL = ("88.83", "30.58")
LOSS = re.compile(r"loss[ =](\S+)")


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(paths) -> None:
    """The port's examples (``examples/torch_*.py``) on the card, each a
    path of its own (lines ``[examples]``):

    * run whole through ``main(["--device", "cuda"])``: the quickstart
      (30 AdamW steps of the smoke smollm_360m, float32 flash at D 20; a
      prefill and 8 greedy decode steps at D 20; MS2M-individual of the
      paper consumer at 6 msg/s), the serving engine (the smoke paper
      consumer's 2-slot engine as the migrated worker, 120 ms a message)
      and the StatefulSet trainer (the smoke smollm_360m trained on batch
      ids, ``ms2m_statefulset``, then the reference fold into a fresh
      trainer on the card, which must give the migrated trainer's bits);
      every verdict True, every printed loss finite, and the virtual times
      and counts equal to the JAX examples' (``EXAMPLE_LINES``);
    * from the live example: ``measure_replay_speedup`` on the card
      (sequential decode against ``replay_chunked``'s ``lm_append``; the
      card's speedup printed), then ``batched_pair``: ``ms2m_cutoff`` at
      16 msg/s paper-faithful (the cutoff fires; 88.83 s / 30.58 s, as in
      the JAX example) and with batched replay at the card's speedup
      (verified; its times follow the speedup, so they are printed only).

    Held on the CPU by the tests only (``tests/test_torch_examples*.py``):
    the live example's four strategies at 10 msg/s, whose
    ``ms2m_individual`` run is the ``default`` migrate path's run (the
    same arguments and row), and the rolling StatefulSet example, whose
    ``HashConsumer`` replicas do no device work."""
    from repro_torch.kernels import build

    runs = (("ex-quickstart", "torch_quickstart",
             ("decode_attention", "flash_attention", "fingerprint_lanes"),
             "tf32x3"),
            ("ex-engine", "torch_serving_engine_migration",
             ("decode_attention", "fingerprint_lanes"), None),
            ("ex-trainer", "torch_statefulset_trainer_migration",
             ("flash_attention", "fingerprint_lanes"), "tf32x3"))
    for label, name, needs, route in runs:
        mod = load_example(name)
        launches, (_, text), wall = run_path(
            label, lambda: _captured(mod.main, ["--device", "cuda"]), needs,
            route, tag="examples")
        paths[label] = launches
        for line in EXAMPLE_LINES[label]:
            check(line in text, f"{label}: no line holds {line!r}")
        losses = [float(x) for x in LOSS.findall(text)]
        check(all(math.isfinite(x) for x in losses),
              f"{label}: a loss is not finite ({losses})")
    live = load_example("torch_live_migration_serving")
    make, cfg = live.make_torch_worker_factory(max_seq=2048, device="cuda")
    launches, speedup, _ = run_path(
        "ex-live-speedup", lambda: live.replay_speedup(make, cfg),
        ("decode_attention",), tag="examples")
    paths["ex-live-speedup"] = launches
    print(f"[examples] the card's chunk-parallel replay speedup: {speedup}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
        launches, pair, _ = run_path(
            "ex-live-cutoff16", lambda: live.batched_pair(make, speedup, root),
            ("decode_attention", "fingerprint_lanes"), tag="examples")
    paths["ex-live-cutoff16"] = launches
    paper, batched = pair["paper-faithful"], pair["batched"]
    got = (f"{paper.migration_time:.2f}", f"{paper.downtime:.2f}")
    check(got == LIVE_PAPER_FAITHFUL and paper.report.cutoff_fired,
          f"paper-faithful ms2m_cutoff at 16/s: {got}, cutoff_fired="
          f"{paper.report.cutoff_fired}; the JAX example gives "
          f"{LIVE_PAPER_FAITHFUL} with the cutoff fired")
    check(paper.verified and batched.verified,
          f"ms2m_cutoff at 16/s: verified {paper.verified} (paper-faithful),"
          f" {batched.verified} (batched)")
    print(f"[examples] batched replay at the card's speedup {speedup:.3f}: "
          f"migration={batched.migration_time!r} s downtime="
          f"{batched.downtime!r} s cutoff_fired={batched.report.cutoff_fired}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {fn.__name__} took {time.perf_counter() - t0:.1f} s")
        return out

    card_phase()
    global HOST_GATES, HOST_RUNS
    HOST_GATES = host_gates()
    timed(build_phase)
    rows = timed(kernel_phase)
    paths = {}
    timed(model_phase)
    timed(train_model_phase)
    rg = timed(rg_model_phase)
    timed(remat_phase, paths, rg)
    del rg
    timed(xl_model_phase)
    timed(moe_model_phase)
    # the dense and frontend checks' CPU sides, beside the next phases
    HOST_RUNS = host_runs()
    print(f"[model] the main thread's torch threads: "
          f"{torch.get_num_threads()}")
    fold = ("decode_attention", "fingerprint_lanes")
    for argv, label, needs in (
            ([], "default", fold),
            (["--precopy"], "precopy", fold),
            (["--precopy", "--compression", "int8"], "precopy-int8",
             fold + CODEC),
            (["--workload", "serving", "--rate", SERVING_RATE, "--precopy",
              "--compression", "int8"], "serving-int8",
             ("decode_attention", "xor_fp_lanes", "int8_fp_lanes"))):
        paths[label] = path_phase(argv, label, needs)
    timed(examples_phase, paths)
    timed(trainer_migration_paths, paths)
    timed(dense_model_phase)
    timed(frontend_model_phase)
    for phase in (train_paths, train_family_paths, sharded_1x1_phase,
                  rg_serve_paths, xl_paths,
                  dense_serve_paths,
                  moe_serve_paths, whisper_serve_paths, qvl_serve_path):
        timed(phase, paths)
    for name, row in rows.items():
        row["launches"] = sum(p[name] for p in paths.values())
        row["launches_by_path"] = {label: p[name]
                                   for label, p in paths.items()}
    print(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          "(the kernels' build included)")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys},
                                   "by_shape": row.get("by_shape")}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
