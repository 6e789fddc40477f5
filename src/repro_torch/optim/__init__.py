from repro_torch.optim.compression import (  # noqa: F401
    compress_gradients,
    decompress_gradients,
    ef_init,
)
