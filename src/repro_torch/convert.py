"""Numpy <-> torch bridging, and the reference's state in the port.

``tree_from_jax`` turns a tree of the reference's numpy leaves into the
port's tree of tensors: ``repro``'s ``T.init_lm(...)`` params into the
port's params (plain dicts of tensors), its AdamW state
(``adamw_init``/``adamw_update``) into the port's optimizer state, and
its serving caches (KV rings, RG-LRU ``h`` and ``conv``, the xLSTM
states' tuples, bfloat16 leaves included) into the port's, so both
packages compute, train and serve from the same point in the parity
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


def tree_from_jax(np_tree, device="cuda"):
    """A reference tree (numpy leaves, possibly wrapped in ``ParamLeaf``;
    dicts, tuples and lists) -> the same tree of tensors on ``device``:
    params, a serving cache, or the AdamW state ``{"count", "mu": {leaf:
    {"m", "v"}}}`` (``count`` an int32 scalar)."""
    dev = resolve_device(device)

    def convert(node):
        if hasattr(node, "value") and hasattr(node, "axes"):
            node = node.value
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(convert(v) for v in node)
        return to_tensor(node, dev)

    return convert(np_tree)

