"""Nested-container helpers with ``jax.tree`` ordering.

State and parameter trees are nested dicts, lists and tuples of tensors,
numpy arrays and scalars.  Registry leaf indices must line up with the
reference, whose ``jax.tree.flatten`` visits dict keys in *sorted* order
(``torch.utils._pytree`` keeps insertion order), so the port flattens
with these helpers.  ``None`` is an empty subtree, as in JAX.

A treedef is plain JSON-able data (``"*"`` for a leaf, ``None``, or a
``{"dict"|"list"|"tuple": ...}`` node), so checkpoint manifests carry no
pickled framework objects.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

LEAF = "*"


def flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves in sorted-key order, JSON-able treedef)."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


# module-level recursions: a nested function that calls itself sits in a
# reference cycle with its closure, which would keep the leaves (a train
# step's gradients) alive until the garbage collector runs
def _walk(node, leaves: List[Any]):
    if node is None:
        return None
    if isinstance(node, dict):
        return {"dict": {k: _walk(node[k], leaves) for k in sorted(node)}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_walk(x, leaves) for x in node]}
    leaves.append(node)
    return LEAF


def unflatten(treedef, leaves):
    """Inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def _build(node, it):
    if node is None:
        return None
    if node == LEAF:
        return next(it)
    (kind, body), = node.items()
    if kind == "dict":
        return {k: _build(v, it) for k, v in body.items()}
    items = [_build(v, it) for v in body]
    return items if kind == "list" else tuple(items)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree):
    leaves_, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves_])
