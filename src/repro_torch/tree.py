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

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {"dict": {k: walk(node[k]) for k in sorted(node)}}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {kind: [walk(x) for x in node]}
        leaves.append(node)
        return LEAF

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == LEAF:
            return next(it)
        (kind, body), = node.items()
        if kind == "dict":
            return {k: build(v) for k, v in body.items()}
        items = [build(v) for v in body]
        return items if kind == "list" else tuple(items)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree):
    leaves_, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves_])
