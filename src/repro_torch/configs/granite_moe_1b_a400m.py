"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE.

24L, d_model=1024, 16 heads (GQA kv=8), d_ff=512 per expert, vocab=49155,
32 experts top-8, every layer MoE, tied embeddings.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    pattern=((BK.ATTN_GLOBAL, BK.MOE),),
    num_experts=32,
    num_experts_per_tok=8,
    capacity_factor=1.25,
    tie_embeddings=True,
    attn_sharding="heads",  # 16 heads / 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=32, vocab_size=512, head_dim=16, num_experts=4,
        num_experts_per_tok=2, dtype="float32",
    )
