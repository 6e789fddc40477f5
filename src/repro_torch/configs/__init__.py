"""Architecture registry of the port.

Same interface as ``repro.configs``.  Only ``paper_consumer`` (the paper's
evaluation microservice, the model the migration path runs) is ported;
every other architecture name raises until its model family is ported.
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
PORTED = ("paper_consumer",)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name in ARCHS and name not in PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet to repro_torch "
            f"(ported: {PORTED})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs(include_paper: bool = False) -> List[str]:
    archs = [a for a in ARCHS if a != "paper_consumer"]
    return ARCHS if include_paper else archs
