"""Architecture registry of the port.

Same interface as ``repro.configs``.  Ported: ``paper_consumer`` (the
paper's evaluation microservice, the model the migration path runs),
``smollm_360m`` (the training and serving CLIs' default),
``codeqwen1_5_7b``, ``gemma3_4b`` and ``chatglm3_6b`` (the dense family:
MHA, 5:1 local:global with QK-norm and a logits softcap, and partial
RoPE over 2 kv heads; served), ``granite_moe_1b_a400m`` and
``llama4_maverick_400b_a17b`` (MoE FFNs: 32 experts top-8 in every layer;
128 experts top-1 with a shared expert, interleaved with dense layers;
granite served at full width, llama4 at its smoke size),
``recurrentgemma_2b`` (the RG-LRU + local-attention hybrid, served),
``xlstm_350m`` (mLSTM + sLSTM blocks, trained and served),
``whisper_large_v3`` (the encoder-decoder: a bidirectional encoder over
stub audio frames, cross-attention in every decoder layer; served at full
width and depth) and ``qwen2_vl_72b`` (M-RoPE over [3,B,S] ids and the
stub image-patch frontend; its 72.7 B params fit no card, so it is served
at full width cut in depth).  Every architecture of ``ARCHS`` is ported.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "codeqwen1_5_7b",
    "gemma3_4b",
    "chatglm3_6b",
    "smollm_360m",
    "whisper_large_v3",
    "llama4_maverick_400b_a17b",
    "granite_moe_1b_a400m",
    "recurrentgemma_2b",
    "qwen2_vl_72b",
    "xlstm_350m",
    "paper_consumer",  # the paper's own evaluation microservice model
]
PORTED = ("paper_consumer", "smollm_360m", "codeqwen1_5_7b", "gemma3_4b",
          "chatglm3_6b", "granite_moe_1b_a400m", "llama4_maverick_400b_a17b",
          "recurrentgemma_2b", "xlstm_350m", "whisper_large_v3",
          "qwen2_vl_72b")

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = _ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs(include_paper: bool = False) -> List[str]:
    archs = [a for a in ARCHS if a != "paper_consumer"]
    return ARCHS if include_paper else archs
