"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small.

32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152, tied.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    tie_embeddings=True,
    attn_sharding="seq",  # 15 heads don't divide the 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=20, dtype="float32",
    )
