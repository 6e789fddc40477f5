"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-* family] — MoE.

48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192, vocab=202048,
MoE 128 experts top-1 with a shared expert, MoE interleaved every other
layer (dense SwiGLU on the rest) — the published Maverick layout, which
also reconciles the 400B-total / 17B-active budget:
  total  ~= 2*1.03B embed + 3.0B attn + 24*(128+1)*126M moe + 24*126M dense
         ~= 397B;     active ~= 14-17B (top-1 + shared + dense + attn).
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    pattern=((BK.ATTN_GLOBAL, BK.MLP), (BK.ATTN_GLOBAL, BK.MOE)),
    num_experts=128,
    num_experts_per_tok=1,
    shared_expert=True,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    tie_embeddings=False,
    attn_sharding="seq",  # 40 heads don't divide the 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=16, num_experts=4,
        num_experts_per_tok=1, dtype="float32",
    )
