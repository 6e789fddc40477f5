#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
     and prints the build time and ptxas's register report;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes and at ragged shapes, with times (CUDA
     graphs of back-to-back calls, timed with CUDA events) beside the
     least time the card could take and one PyTorch library call where
     one computes the same function.  The fused codec kernels are held
     bit for bit at the fold's shape (a real float32 KV leaf against its
     parent), the serving engine's slot-aligned chunk grid, a ragged
     odd-row shape and the quantizer's edge values, and their
     ``FusedLeafEncoding`` blobs against the host codecs'; the decode
     kernel also on a row with no valid slot;
  4. model: the paper consumer's decode steps on the card against the
     same steps on the CPU (the plain path);
  5. path: ``repro_torch.launch.migrate.main`` with its defaults (the
     paper consumer at full width, max_seq 2048), with ``--precopy``,
     with ``--precopy --compression int8`` and with ``--workload serving
     --precopy --compression int8`` (the serving engine on the card);
     each must verify its migrated state (and exactly-once delivery for
     serving) and launch the kernels of its path.

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
    rows.update(codec_kernels())
    decode_empty_row(gen)
    print("[kernels] " + json.dumps(sorted(rows)))
    return rows


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
    slot-aligned chunk grid, a ragged odd-row shape and the edge values."""
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

    out = []
    for label, leaf, par, cb in (("fold", fold_leaf, parent, CHUNK_BYTES),
                                 ("serving", s_leaf, s_parent, s_chunk)):
        praw = leaf_raw(par)
        cw, pw = ops._codec_words(leaf, praw, cb)
        out.append((label, cw, pw, cb, leaf, praw))
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


def codec_kernels():
    """The fused fingerprint+XOR and fingerprint+int8 kernels, bit for bit
    against their plain versions, and the codec blobs of a CUDA leaf."""
    import numpy as np

    from repro_torch.checkpoint.codecs import (FusedLeafEncoding, get_codec,
                                               leaf_raw)
    from repro_torch.kernels import codec as ck

    inputs = codec_inputs()
    kernels = (("xor_fp_lanes", ck.xor_fp_lanes, ck.xor_fp_ref),
               ("int8_fp_lanes", ck.int8_fp_lanes, ck.int8_fp_ref))
    rows = {}
    for label, cw, pw, cb, leaf, praw in inputs:
        for name, fn, plain in kernels:
            got, again, want = fn(cw, pw), fn(cw, pw), plain(cw, pw)
            torch.cuda.synchronize()
            same = all(_same_bits(g, w) for g, w in zip(got, want))
            print(f"[kernels] {name} {label} {list(cw.shape)}: "
                  f"bit-identical={same}")
            check(same, f"{name} {label}: kernel differs from plain version")
            check(all(_same_bits(g, a) for g, a in zip(got, again)),
                  f"{name} {label}: two launches differ")
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
        if label == "serving":
            for name, fn, plain in kernels:
                print(f"[kernels] {name} serving: "
                      f"{graph_ms(lambda: fn(cw, pw)) * 1e3:.2f} us kernel, "
                      f"{graph_ms(lambda: plain(cw, pw)) * 1e3:.2f} us plain")
        if label != "fold":
            continue
        C, R, L = cw.shape
        words = C * R * L
        lane_bytes = C * L * 4
        # each input read once and each output written once (q as int8);
        # per word: a multiply and an add for the fingerprint, then the
        # XOR, or subtract, abs, max, divide, round and two clamps
        work = {
            "xor_fp_lanes": (3 * words * 4 + lane_bytes, 3 * words),
            "int8_fp_lanes": (2 * words * 4 + words + (words // 256) * 4
                              + lane_bytes, 9 * words),
        }
        for name, fn, plain in kernels:
            ms = graph_ms(lambda: fn(cw, pw))
            plain_ms = graph_ms(lambda: plain(cw, pw))
            nbytes, ops_n = work[name]
            b_ms, b_by = bound(nbytes, ops_n)
            rows[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/codec.cu",
                replaces=("src/repro/kernels/codec.py:101"
                          if name == "xor_fp_lanes"
                          else "src/repro/kernels/codec.py:175"),
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
            print(f"[kernels] {name} fold: {ms * 1e3:.2f} us kernel, "
                  f"{plain_ms * 1e3:.2f} us plain, bound {b_ms * 1e3:.3f} us "
                  f"({b_by}, {nbytes} bytes)")
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


KERNELS = ("decode_attention", "fingerprint_lanes", "xor_fp_lanes",
           "int8_fp_lanes")


def path_phase(argv, label, needs):
    """One ``launch/migrate`` run: every counter set to 0 just before it
    and read just after; each kernel in ``needs`` must have launched."""
    from repro_torch import configs
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.launch import migrate

    da.LAUNCHES = 0
    fp.LAUNCHES = 0
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    rc = migrate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da.LAUNCHES,
                "fingerprint_lanes": fp.LAUNCHES, **ck.LAUNCHES}
    # one launch per layer per decode step (source, replay and reference)
    steps = da.LAUNCHES // configs.get_config("paper_consumer").num_layers
    print(f"[path] {label}: rc={rc} wall={wall:.3f} s launches={launches} "
          f"decode_steps={steps} wall_per_step_ms="
          f"{wall / max(steps, 1) * 1e3:.3f}")
    check(rc == 0, f"{label}: migrate exited {rc} (its state must verify)")
    for name in needs:
        check(launches[name] > 0, f"{label}: kernel {name} never launched")
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
    fold = ("decode_attention", "fingerprint_lanes")
    paths = {
        "default": path_phase([], "default", fold),
        "precopy": path_phase(["--precopy"], "precopy", fold),
        "precopy-int8": path_phase(["--precopy", "--compression", "int8"],
                                   "precopy-int8", KERNELS),
        "serving-int8": path_phase(
            ["--workload", "serving", "--rate", SERVING_RATE, "--precopy",
             "--compression", "int8"], "serving-int8",
            ("decode_attention", "xor_fp_lanes", "int8_fp_lanes")),
    }
    for name, row in rows.items():
        row["launches"] = sum(p[name] for p in paths.values())
        row["launches_by_path"] = {label: p[name]
                                   for label, p in paths.items()}
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
