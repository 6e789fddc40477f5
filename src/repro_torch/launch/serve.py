"""Serving CLI: batched prefill + decode with KV-cache management — the
worker type that MS2M migrates.

Port of ``repro.launch.serve``, with the reference's flags, defaults and
printed lines, plus ``--device`` (``cuda`` by default: the prompt goes
through the flash-attention kernel, and the RG-LRU kernel for
recurrentgemma_2b, and every decode step through the decode-attention
kernel; ``cpu`` runs their plain versions).  For xlstm_350m the prefill
and the decode steps thread the recurrent state through the mLSTM and
sLSTM recurrences on either device, as the reference does: its kernels
take fresh-state sequences only (training).  The MoE FFN of
granite_moe_1b_a400m and llama4_maverick_400b_a17b is sorts, gathers and
batched einsums on either device (the reference has no kernel for it);
llama4's full config (397.7 B params) fits no card, so run its
``--smoke`` config.  The frontend stubs are drawn as the reference draws
them, from the prompt's generator right after the tokens: whisper_large_v3's
audio frames [B, encoder_seq, d_model] (its encoder, and every decoder
layer's cross-attention over the encoder's output in the prefill and in
each decode step, run through the flash kernel on the card) and
qwen2_vl_72b's image patches [B, num_patches, d_model], written from token
1 of the prompt with M-RoPE ids t = h = w.  qwen2_vl_72b's 72.7 B params
fit no card, so run its ``--smoke`` config (4 patches); the reference's
CLI also fails for its full config at the default ``--prompt-len 32``,
since 256 patches do not fit 32 tokens, and so does this one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --smoke --requests 16 --decode-steps 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_350m
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite_moe_1b_a400m
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4_maverick_400b_a17b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_large_v3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_72b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import step as steplib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8, help="batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and its cache (cuda "
                         "runs the CUDA kernels; cpu their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    params = T.init_lm(cfg, seed=0, device=dev)
    B = args.requests

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, args.prompt_len)).astype(
            np.int32)).to(dev)}
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.from_numpy(rng.normal(
            0, 0.02, (B, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)).to(dev)
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            0, 0.02, (B, cfg.num_patches, cfg.d_model)).astype(
                np.float32)).to(dev)

    prefill = steplib.build_prefill_step(cfg)
    decode = steplib.build_decode_step(cfg)

    cache = T.init_cache(cfg, B, args.max_seq, device=dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {args.prompt_len} tokens x {B} requests: "
          f"{t_prefill*1e3:.0f}ms")

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    pos = torch.full((B, 1), args.prompt_len, dtype=torch.int32, device=dev)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.decode_steps):
        logits, cache = decode(params, cache, tok, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        pos = pos + 1
        generated.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks_s = B * args.decode_steps / dt
    print(f"[serve] decoded {args.decode_steps} steps x {B} requests: "
          f"{dt*1e3:.0f}ms ({toks_s:.0f} tok/s)")
    out = torch.cat(generated, dim=1)
    print(f"[serve] sample continuation (request 0): "
          f"{out[0].cpu().numpy()[:16]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
