"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks (xLSTM[7:1]).

24L, d_model=1024, 4 heads, vocab=50304, no separate FFN (d_ff=0; mLSTM
blocks carry a factor-2 pre-up-projection internally).  Pattern: 7 mLSTM +
1 sLSTM per group x 3 groups.

O(1) decode state => runs the long_500k shape (subquadratic=True).
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    pattern=((BK.MLSTM, BK.NONE),) * 7 + ((BK.SLSTM, BK.NONE),),
    tie_embeddings=True,
    attn_sharding="seq",
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=512, head_dim=16, dtype="float32",
    )
