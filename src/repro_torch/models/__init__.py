from repro_torch.models.config import ModelConfig, BlockKind, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.models import common, attention, mlp  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    init_lm,
    lm_decode_step,
    lm_append,
    init_cache,
)
