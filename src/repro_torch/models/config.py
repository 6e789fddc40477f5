"""Unified model configuration covering all ten assigned architectures.

One dataclass, one decoder implementation: every architecture is expressed as
a repeating *layer pattern* (a tuple of (mixer, ffn) block kinds) that the
decoder scans over.  E.g. gemma3 is 5x(local attention, mlp) + 1x(global
attention, mlp); recurrentgemma is 2x(RG-LRU, mlp) + 1x(local attention, mlp);
llama4 alternates dense and MoE FFNs; xlstm is 7x mLSTM + 1x sLSTM.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import torch


class BlockKind(str, enum.Enum):
    # sequence mixers
    ATTN_GLOBAL = "attn_global"
    ATTN_LOCAL = "attn_local"
    RGLRU = "rglru"
    MLSTM = "mlstm"
    SLSTM = "slstm"
    # ffns
    MLP = "mlp"
    MOE = "moe"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # repeating block pattern: tuple of (mixer_kind, ffn_kind)
    pattern: Tuple[Tuple[BlockKind, BlockKind], ...] = (
        (BlockKind.ATTN_GLOBAL, BlockKind.MLP),
    )
    window: int = 4_096  # local-attention window
    # rope
    rope_kind: str = "default"  # default | partial (chatglm 2d) | mrope | none
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0  # gemma3 uses a different theta locally
    rope_fraction: float = 1.0  # chatglm applies rope to half the head dim
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w splits (pairs)
    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    router_aux_coef: float = 0.01
    # "local": per-batch-row routing (sort/gather/scatter stay data-shard
    #   local; the dispatch crosses shards only through the expert einsum).
    # "global": single global token pool (baseline; its sharded sort/scatter
    #   lower to full-token-buffer collectives — see EXPERIMENTS.md §Perf).
    moe_routing: str = "local"
    # "model": expert parallelism (weights sharded over the model axis);
    # "replicated": experts replicated (right call for small MoEs like
    #   granite, where EP dispatch is inherently ICI-bound).
    expert_sharding: str = "model"
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1_500  # whisper: 30 s of audio -> 1500 frames
    # modality frontend stubs
    frontend: str = "none"  # none | audio_frames | image_patches
    num_patches: int = 0  # vlm: patch embeddings per request
    # recurrent dims
    rglru_width: int = 0  # 0 -> d_model
    conv1d_width: int = 4  # griffin temporal conv
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logits_softcap: float = 0.0  # gemma-style soft capping
    attn_sharding: str = "heads"  # heads | seq (activation strategy)
    use_qk_norm: bool = False  # gemma3-style
    mlp_gated: bool = True  # SwiGLU (False -> plain gelu MLP, whisper-style)
    mlp_act: str = "silu"  # silu | gelu
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""  # "" -> compute dtype; "int8" -> quantized KV
    # decode-time q-head placement: replicating heads keeps single-token
    # attention local to the seq-sharded cache (flash-decode); sharding
    # them forces a per-layer cache all-gather (§Perf C1).
    decode_heads_replicated: bool = False
    # long-context applicability: True iff decode state is O(window) not O(seq)
    subquadratic: bool = False

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by pattern "
            f"of {self.group_size}"
        )
        return self.num_layers // self.group_size

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 so `vocab -> model(16)` shards."""
        return math.ceil(self.vocab_size / 2048) * 2048

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # ---- analytic parameter counts (for MODEL_FLOPS = 6*N*D roofline) ----
    def param_count(self, active: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        qdim = self.num_heads * hd
        kvdim = self.num_kv_heads * hd
        n = 0
        counted_layers = 0
        for mixer, ffn in self.pattern:
            if mixer in (BlockKind.ATTN_GLOBAL, BlockKind.ATTN_LOCAL):
                n += d * qdim + 2 * d * kvdim + qdim * d
            elif mixer == BlockKind.RGLRU:
                w = self.rglru_width or d
                # in/out proj (x and gate branches) + conv + gates + recurrent
                n += 2 * d * w + w * d + self.conv1d_width * w + 2 * w * (w // max(1, self.num_heads)) + 2 * w
            elif mixer == BlockKind.MLSTM:
                # up-proj + gate, qkv at inner dim m=2d, i/f gates, down-proj
                m = 2 * d
                n += 2 * d * m + 3 * m * m + m * 2 * self.num_heads + m * d
            elif mixer == BlockKind.SLSTM:
                hb = d // max(1, self.num_heads)
                # 4 input projections + 4 block-diagonal recurrences + out
                n += 4 * d * d + 4 * d * hb + d * d
            if ffn == BlockKind.MLP:
                n += 3 * d * self.d_ff
            elif ffn == BlockKind.MOE:
                per_expert = 3 * d * self.d_ff
                if active:
                    k = self.num_experts_per_tok + (1 if self.shared_expert else 0)
                    n += k * per_expert + d * self.num_experts
                else:
                    n += self.num_experts * per_expert + d * self.num_experts
                    if self.shared_expert:
                        n += per_expert
            n += 2 * d  # the two rmsnorm scales
            counted_layers += 1
        n = n * (self.num_layers // counted_layers)
        n += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.is_encoder_decoder:
            # encoder self-attn + mlp + cross-attn params in decoder
            enc = self.num_encoder_layers * (d * qdim + 2 * d * kvdim + qdim * d + 2 * d * self.d_ff + 2 * d)
            cross = self.num_layers * (d * qdim + 2 * d * kvdim + qdim * d + d)
            n += enc + cross
        return int(n)

    def model_flops(self, tokens: int, active: bool = True) -> float:
        """MODEL_FLOPS = 6 * N(_active) * D  (D = tokens processed)."""
        return 6.0 * self.param_count(active=active) * tokens

    def runnable(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k" and not self.subquadratic:
            return False
        return True
