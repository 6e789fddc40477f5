"""PyTorch/CUDA port of the MS2M reproduction (``repro``).

The layout mirrors ``repro`` module for module.  The model path runs on an
NVIDIA Hopper card through hand-written CUDA kernels
(``repro_torch/csrc``); every kernel has a plain PyTorch version that runs
when its input tensor lies on the CPU (the test suite's path).

Importing the package fixes the numerics the migration premise needs
(replay must be bit-exact against the straight fold): deterministic
algorithms, a fixed cuBLAS workspace and no TF32.  These are set here,
before any CUDA context exists.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch finds no CUDA card; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
