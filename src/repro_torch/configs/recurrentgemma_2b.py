"""RecurrentGemma-2B [arXiv:2402.19427] — griffin hybrid: RG-LRU + local attn.

26L, d_model=2560, 10 heads (MQA kv=1), head_dim=256, d_ff=7680,
vocab=256000, local window 2048, recurrence width 2560.

Pattern note: griffin's strict (R,R,A) period doesn't divide 26; we use a
13-layer period (R,R,A)x4 + R = 9R+4A per group, x2 groups = 18 recurrent +
8 local-attention layers (~2.25:1, matching the paper's 2:1 design intent).

O(1) decode state => runs the long_500k shape (subquadratic=True).
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

_P13 = (((BK.RGLRU, BK.MLP),) * 2 + ((BK.ATTN_LOCAL, BK.MLP),)) * 4 \
    + ((BK.RGLRU, BK.MLP),)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    pattern=_P13,
    window=2048,
    rglru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
    attn_sharding="seq",  # 10 heads don't divide the 16-way model axis
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=13, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=16, window=8, rglru_width=64,
        dtype="float32",
    )
