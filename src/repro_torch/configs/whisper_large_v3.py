"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder, audio.

32 encoder + 32 decoder layers, d_model=1280, 20 heads (MHA), d_ff=5120
(plain GELU MLP, non-gated), vocab=51866.  The conv mel frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings [B, 1500, d_model].
Sinusoidal encoder positions, learned decoder positions, tied unembedding.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    rope_kind="none",
    mlp_gated=False,
    mlp_act="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=32,
    encoder_seq=1500,
    frontend="audio_frames",
    tie_embeddings=True,
    attn_sharding="seq",  # 20 heads don't divide the 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, head_dim=16,
        encoder_seq=24, dtype="float32",
    )
