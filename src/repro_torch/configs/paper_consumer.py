"""The paper's evaluation workload: the *consumer microservice*.

The paper's consumer is a Spring Boot service whose in-memory state is the
fold of RabbitMQ messages.  Our consumer is its model analogue: a small LM
serving replica whose migratable state is the KV/recurrent cache built by
processing a stream of requests (messages).  Small enough that the
migration benchmarks run the *real* model on CPU (no simulation of the
compute), so µ_target in the cutoff formula is measured, not assumed.
"""
import dataclasses

from repro_torch.models.config import BlockKind as BK, ModelConfig

CONFIG = ModelConfig(
    name="paper-consumer",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=2048,
    head_dim=32,
    pattern=((BK.ATTN_GLOBAL, BK.MLP),),
    tie_embeddings=True,
    attn_sharding="heads",
    dtype="float32",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(CONFIG, num_layers=2, d_model=64, d_ff=128,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               vocab_size=512)
