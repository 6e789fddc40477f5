"""Numpy <-> torch bridging, and the reference's params in the port.

``params_from_jax`` turns the tree of ``repro``'s ``T.init_lm(...)``,
handed over as numpy arrays, into the port's params (plain dicts of
tensors), so both packages compute the same function in the parity
tests.  The reference's ``ParamLeaf`` wrappers (anything with ``value``
and ``axes`` attributes) are unwrapped; this module imports nothing of
``repro`` or JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def to_tensor(a, device) -> torch.Tensor:
    """A fresh tensor on ``device`` holding ``a`` (numpy array or scalar,
    or tensor).  bfloat16 numpy arrays (``ml_dtypes``) cross as their bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree, device="cuda"):
    """Reference params (numpy leaves, possibly wrapped in ``ParamLeaf``)
    -> the port's params dict on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if hasattr(node, "value") and hasattr(node, "axes"):
            node = node.value
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return to_tensor(node, dev)

    return convert(np_tree)
