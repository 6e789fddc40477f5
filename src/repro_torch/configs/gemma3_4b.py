"""Gemma3-4B [hf:google/gemma-3-4b-pt family] — dense, 5:1 local:global.

34L, d_model=2560, 8 heads (GQA kv=4), head_dim=256, d_ff=10240,
vocab=262144, sliding window 1024, QK-norm, dual rope thetas
(1M global / 10k local), 128k context.

Pattern note: 34 layers with a strict 6-layer (5L+1G) period don't divide;
we use a 17-layer period (5L,G,5L,G,5L) x 2 groups = 30 local + 4 global,
preserving the ~5:1 ratio while keeping the scan-group compilation model.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

_P17 = ((BK.ATTN_LOCAL, BK.MLP),) * 5 + ((BK.ATTN_GLOBAL, BK.MLP),) \
    + ((BK.ATTN_LOCAL, BK.MLP),) * 5 + ((BK.ATTN_GLOBAL, BK.MLP),) \
    + ((BK.ATTN_LOCAL, BK.MLP),) * 5

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262_144,
    head_dim=256,
    pattern=_P17,
    window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    use_qk_norm=True,
    logits_softcap=30.0,
    tie_embeddings=True,
    attn_sharding="seq",  # 8 heads don't divide the 16-way model axis
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=17, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, window=8, dtype="float32",
    )
