"""Qwen2-VL-72B [arXiv:2409.12191] — VLM backbone with M-RoPE.

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
M-RoPE sections (16,24,24) over temporal/height/width position ids.
The vision tower is a STUB: ``input_specs()`` provides precomputed patch
embeddings [B, 256, d_model] merged into the token stream, plus [3,B,S]
position ids (t==h==w for text tokens).
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="image_patches",
    num_patches=256,
    tie_embeddings=False,
    attn_sharding="heads",  # 64 heads / 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, num_patches=4,
        mrope_sections=(8, 12, 12), dtype="float32",
    )
