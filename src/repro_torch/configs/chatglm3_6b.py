"""ChatGLM3-6B [arXiv:2406.12793] — dense, 2D (partial) RoPE, GQA kv=2.

28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024.
RoPE applied to half the head dim (GLM's 2D rope), untied embeddings.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    rope_kind="partial",
    rope_fraction=0.5,
    tie_embeddings=False,
    attn_sharding="heads",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
    )
