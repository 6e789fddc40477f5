from repro_torch.serving.engine import ServingEngine, Request  # noqa: F401
from repro_torch.serving.handoff import (  # noqa: F401
    CompletionLedger,
    HashServingWorker,
    ServingHandoff,
    ServingResult,
    ServingWorker,
    run_serving_experiment,
    serving_reference_fold,
    slot_aligned_chunk_bytes,
)
