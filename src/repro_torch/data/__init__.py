from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticTokenDataset,
    make_train_iterator,
)
