#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
     and prints the build time and ptxas's register report;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes and at a ragged shape, with times (CUDA
     graphs of back-to-back calls, timed with CUDA events) beside the
     least time the card could take and one PyTorch library call where
     one computes the same function;
  4. model: the paper consumer's decode steps on the card against the
     same steps on the CPU (the plain path);
  5. path: ``repro_torch.launch.migrate.main`` with its defaults (the
     paper consumer at full width, max_seq 2048) and again with
     ``--precopy``; each must verify its migrated state and launch both
     kernels.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside this file, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published H100 SXM peaks (data sheet): HBM bytes/s and float32 outside the
# tensor cores, which also stands for 32-bit integer multiply-add here.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)      # float32, split-KV sum order
DECODE_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 output rounding


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


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
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
    return card


def build_phase() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.3f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")


def decode_inputs(gen, B, S, H, Hkv, D, dtype, ring: bool):
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
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


def kernel_phase():
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # -- decode attention -------------------------------------------------
    cases = [  # (label, B, S, H, Hkv, D, dtype, ring, tol)
        ("main", 1, 2048, 8, 4, 32, torch.float32, False, DECODE_TOL),
        ("ragged", 3, 1000, 12, 3, 48, torch.float32, True, DECODE_TOL),
        ("ragged-bf16", 2, 777, 8, 2, 64, torch.bfloat16, True,
         DECODE_TOL_BF16),
    ]
    main_err = None
    for label, B, S, H, Hkv, D, dtype, ring, tol in cases:
        q, k, v, qp, kp = decode_inputs(gen, B, S, H, Hkv, D, dtype, ring)
        got = da.decode_attention(q, k, v, qp, kp)
        again = da.decode_attention(q, k, v, qp, kp)
        want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[kernels] decode_attention {label} B={B} S={S} H={H} "
              f"Hkv={Hkv} D={D} {str(dtype)[6:]}: max_abs_err={err:.3e}")
        check(bool(torch.isfinite(got).all()), f"decode {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"decode {label}: kernel disagrees with the plain version "
              f"({err:.3e}, tolerance {tol})")
        check(torch.equal(got, again),
              f"decode {label}: two launches differ")
        if label == "main":
            main_err = err
            main_inputs = (q, k, v, qp, kp)
    q, k, v, qp, kp = main_inputs
    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    ms = graph_ms(lambda: da.decode_attention(q, k, v, qp, kp))
    plain_ms = graph_ms(lambda: ref.decode_attention(q, k, v, q_pos=qp,
                                                     k_pos=kp))
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = ((kp >= 0) & (kp <= qp[:, None]))[:, None, None, :]
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=True).transpose(1, 2)
    check(torch.allclose(lib, ref.decode_attention(q, k, v, q_pos=qp,
                                                   k_pos=kp), **DECODE_TOL),
          "SDPA yardstick disagrees with the plain decode version")
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True))
    n_valid = int(((kp >= 0) & (kp <= qp[:, None])).sum())  # rows read
    nbytes = (q.nbytes * 2 + 2 * n_valid * Hkv * D * k.element_size()
              + qp.nbytes + kp.nbytes)
    b_ms, b_by = bound(nbytes, 4 * B * H * (n_valid // B) * D)
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms)
    print(f"[kernels] decode_attention main: {ms * 1e3:.2f} us kernel, "
          f"{plain_ms * 1e3:.2f} us plain, {library_ms * 1e3:.2f} us SDPA, "
          f"bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes)")

    # -- chunk fingerprint lanes -------------------------------------------
    main_words = None
    for label, C, R in (("main", 1, 8192), ("ragged", 3, 77)):
        words = torch.randint(-2 ** 31, 2 ** 31, (C, R, 128),
                              generator=gen, device="cuda",
                              dtype=torch.int64).to(torch.int32)
        got = fp.fingerprint_lanes(words)
        want = fp.fingerprint_lanes_ref(words)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"[kernels] fingerprint_lanes {label} [{C},{R},128]: "
              f"bit-identical={same}")
        check(same, f"fingerprint {label}: kernel differs from plain version")
        if label == "main":
            main_words = words
    # a real float32 leaf through the registry's path, both devices
    leaf = torch.randn((4, 1, 2048, 4, 32), generator=gen, device="cuda")
    on_card = ops.chunk_fingerprint(leaf, 4 * 1024 * 1024)
    on_host = ops.chunk_fingerprint(leaf.cpu(), 4 * 1024 * 1024)
    check(torch.equal(on_card.cpu(), on_host),
          "chunk_fingerprint: card and host differ")
    words = main_words
    ms = graph_ms(lambda: fp.fingerprint_lanes(words))
    plain_ms = graph_ms(lambda: fp.fingerprint_lanes_ref(words))
    C, R, L = words.shape
    b_ms, b_by = bound(words.nbytes + C * L * 4, 2 * C * R * L)
    rows["fingerprint_lanes"] = dict(
        name="fingerprint_lanes", route="cuda",
        source="src/repro_torch/csrc/fingerprint.cu",
        replaces="src/repro/kernels/fingerprint.py:87",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(f"[kernels] fingerprint_lanes main: {ms * 1e3:.2f} us kernel, "
          f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
          f"({b_by})")
    print("[kernels] " + json.dumps(sorted(rows)))
    return rows


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


def path_phase(argv, label):
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.launch import migrate

    da.LAUNCHES = 0
    fp.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = migrate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da.LAUNCHES,
                "fingerprint_lanes": fp.LAUNCHES}
    # one launch per layer per decode step (source, replay and reference)
    steps = da.LAUNCHES // configs.get_config("paper_consumer").num_layers
    print(f"[path] {label}: rc={rc} wall={wall:.3f} s launches={launches} "
          f"decode_steps={steps} wall_per_step_ms="
          f"{wall / max(steps, 1) * 1e3:.3f}")
    check(rc == 0, f"{label}: migrate exited {rc} (verified must be True)")
    for name, n in launches.items():
        check(n > 0, f"{label}: kernel {name} never launched")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    card_phase()
    build_phase()
    rows = kernel_phase()
    model_phase()
    launches = path_phase([], "default")
    path_phase(["--precopy"], "precopy")
    for name, row in rows.items():
        row["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
