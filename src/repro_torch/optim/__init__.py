from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_gradients,
    decompress_gradients,
    ef_init,
)
