from repro_torch.train.step import (  # noqa: F401
    TrainStepConfig,
    build_train_step,
    build_decode_step,
    build_prefill_step,
)
