"""Peaks of the card and the operations and bytes that the metrics count.

Published peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of
HBM bandwidth, all at the full 700 W power limit.  Counts come from the
configuration's sizes alone, whatever code computes them.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
PEAK_F32_OPS_S = 67e12


def active_matmul_params(run: dict) -> int:
    """Weights a token multiplies with on its way through the model: the
    attention projections, the MLP or the router and its top-k experts in
    every layer, and the output head over the published vocabulary."""
    d, hd = run["d_model"], run["head_dim"]
    H, Hkv, ff = run["num_heads"], run["num_kv_heads"], run["d_ff"]
    attn = d * H * hd * 2 + d * Hkv * hd * 2
    if run["family"] == "moe":
        ffn = d * run["num_experts"] + run["num_experts_per_tok"] * 3 * d * ff
    else:
        ffn = 3 * d * ff
    return run["num_layers"] * (attn + ffn) + d * run["vocab_size"]


def attention_flops(run: dict, context: int) -> int:
    """Score and value products of one token over ``context`` keys, all
    layers (2 flops a multiply-add, two products)."""
    return run["num_layers"] * 4 * run["num_heads"] * run["head_dim"] * context


def serve_token_flops(run: dict, position: int) -> int:
    """One token generated at ``position`` (0-based)."""
    return 2 * active_matmul_params(run) + attention_flops(run, position + 1)


def train_batch_flops(run: dict, batch: int, seq: int) -> int:
    """Forward and backward of one batch: 6 flops a weight a token, and
    three times the causal attention's forward products."""
    tokens = batch * seq
    causal_pairs = seq * (seq + 1) // 2
    attn = 3 * run["num_layers"] * 4 * run["num_heads"] * run["head_dim"] \
        * causal_pairs * batch
    return 6 * active_matmul_params(run) * tokens + attn


def bound_s(nbytes: float, ops: float, peak_ops_s: float) -> float:
    """The least time the card could take: bytes over its bandwidth or
    operations over its peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_S, ops / peak_ops_s)


def decode_attention_bound_s(run: dict, lanes_valid: int, lanes: int,
                             slots: int, elem: int = 2) -> float:
    """One decode-attention launch (one layer): q in and out written for
    every lane, each lane's valid cached K and V rows read once, and the
    slot positions of every lane read (the kernel's mask)."""
    H, Hkv, D = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    nbytes = (2 * lanes * H * D * elem + 2 * lanes_valid * Hkv * D * elem
              + lanes * slots * 4 + lanes * 4)
    ops = 4 * H * D * lanes_valid
    return bound_s(nbytes, ops, PEAK_BF16_OPS_S)


def flash_forward_bound_s(run: dict, batch: int, seq: int,
                          elem: int = 2) -> float:
    """One causal flash forward launch (one layer of a train step): q, k,
    v read once and the output written once, against 4·D operations per
    kept (query, key) pair on the bf16 tensor cores."""
    H, Hkv, D = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    nbytes = batch * seq * D * elem * (2 * H + 2 * Hkv)
    ops = 4 * D * H * batch * seq * (seq + 1) // 2
    return bound_s(nbytes, ops, PEAK_BF16_OPS_S)


def window_mfu(rec) -> "float | None":
    """The window's model FLOPs over the bf16 peak, in %: served tokens
    at their positions, or trained batches, as the configuration's model
    counts them (this module's counts where the record names none)."""
    run = rec.run
    counts = rec.model
    serve = counts.serve_token_flops if counts else serve_token_flops
    train = counts.train_batch_flops if counts else train_batch_flops
    if rec.tokens_per_batch:
        t = rec.traffic
        total = len(rec.trained) * train(run, t["batch"], t["seq"])
    else:
        total = 0
        for r, toks in rec.served.items():
            # served token i comes from the step at position prompt + i - 1
            p = rec.prompt_len[r] - 1
            total += sum(serve(run, p + i)
                         for i, (t, _) in enumerate(toks)
                         if 0.0 <= t <= rec.window_s)
    if not total:
        return None
    return 100.0 * total / (rec.window_s * PEAK_BF16_OPS_S)


def idle_share(rec) -> "float | None":
    """1 less the device's busy time over the traced stretch, in %."""
    tr = rec.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
