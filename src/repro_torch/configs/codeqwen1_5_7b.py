"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — dense, qwen1.5 arch.

32L, d_model=4096, 32 heads (MHA: kv=32), d_ff=13440, vocab=92416.
RoPE theta 1e6 (64k context), untied embeddings, SwiGLU.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    head_dim=128,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    attn_sharding="heads",  # 32 heads / 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
    )
