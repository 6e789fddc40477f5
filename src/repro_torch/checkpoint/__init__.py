from repro_torch.checkpoint.registry import (  # noqa: F401
    ChunkStore,
    Registry,
    PushReport,
)
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
from repro_torch.checkpoint.codecs import (  # noqa: F401
    COMPRESSION_CHOICES,
    DeltaCodec,
    get_codec,
    resolve_compression,
    validate_compression,
)
from repro_torch.checkpoint.fingerprint import leaf_fingerprints  # noqa: F401
