"""Logical-axis -> mesh-axis rules with best-effort divisibility fallback.

Port of ``repro.sharding.rules``.  A rule maps a logical axis name to a
mesh axis name (or a tuple of mesh axes, or None).  ``logical_to_spec``
resolves a tensor's logical axes into a ``PartitionSpec`` and *drops* any
assignment whose mesh-axis size does not divide the dimension size (the
"best-effort resolver").  This lets one rules table serve every
architecture: e.g. ``heads -> model`` applies to codeqwen (32 heads / 16)
but is dropped for gemma3 (8 heads), whose config instead selects the
``seq`` attention-sharding strategy.  Dropped assignments are *recorded*
(``AxisRules.dropped``) so the dry-run can report where the sharding is
lossy.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names``
and ``shape``) or an ``AbstractMesh`` of names and sizes, which needs no
process group: specs for the 16x16 and 2x16x16 production meshes are
derived without 256 ranks.  ``placements`` turns a spec into DTensor
placements on a ``DeviceMesh``.  There is no global mesh state:
``with_sharding_constraint_logical`` reads the mesh of the DTensor it is
given and leaves a plain tensor as it is (the reference's no-op without
a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over them, major first).  Compares equal
    to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes, with no devices or process group."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass
class AxisRules:
    """An ordered logical-axis -> mesh-axes mapping."""

    rules: Mapping[str, MeshAxes]

    def __post_init__(self):
        self.dropped = []  # (logical_name, dim_size, mesh_axes) triples

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.rules.get(name, None)

    def overriding(self, **overrides: MeshAxes) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return AxisRules(merged)


# The production mesh axes are ("pod", "data", "model") (multi-pod) or
# ("data", "model") (single pod).  "pod" composes with "data" for batch /
# FSDP sharding; specs below name both and the resolver drops axes that are
# absent from the mesh, so the same rules serve both meshes.
DEFAULT_RULES = AxisRules(
    {
        # --- activations ---
        "batch": ("pod", "data"),
        "seq": None,  # overridden to ("model",) by the `seq` attention strategy
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": None,
        "act_qout": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "kv_seq": "model",  # decode-time KV cache: flash-decode seq sharding
        "act_experts": "model",
        # --- params (FSDP over data; TP over model) ---
        "embed": ("pod", "data"),
        "mlp": "model",
        "qout": "model",  # fused q/k/v/o head*head_dim projections
        "kv_out": "model",
        "heads": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "rec_width": "model",  # RG-LRU / xLSTM channel dims
        "layers": None,  # stacked-layer axis: never sharded
        "conv": None,
        "stats": None,
    }
)


def _mesh_axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)
    return size


def _present(mesh, axes: MeshAxes) -> MeshAxes:
    """Filter out mesh axes that are not part of this mesh (e.g. 'pod')."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    names = mesh_axes(mesh)
    kept = tuple(a for a in axes if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    mesh,
    rules: AxisRules = DEFAULT_RULES,
    dims: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec, best-effort.

    ``dims`` (optional) enables the divisibility check; without it, rules are
    applied verbatim.  A mesh axis may be consumed by at most one dimension;
    later dims lose conflicts (first-come-first-served, like t5x).
    """
    used: set = set()
    spec = []
    for i, name in enumerate(logical_axes):
        axes = _present(mesh, rules.get(name))
        if axes is None:
            spec.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple if a not in used)
        if not ax_tuple:
            spec.append(None)
            continue
        if dims is not None:
            size = 1
            for a in ax_tuple:
                size *= _mesh_axis_size(mesh, a)
            if size == 0 or dims[i] % size != 0:
                rules.dropped.append((name, dims[i], ax_tuple))
                spec.append(None)
                continue
        used.update(ax_tuple)
        spec.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
    return P(*spec)


def batch_axes(mesh, batch: int) -> MeshAxes:
    """The mesh axes the default rules split a batch of ``batch`` rows
    over (None where they do not divide it); nothing is recorded."""
    return logical_to_spec(("batch",), mesh, AxisRules(DEFAULT_RULES.rules),
                           dims=(batch,))[0]


def placements(spec: Sequence, mesh, shape: Optional[Sequence[int]] = None):
    """A spec -> DTensor placements on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
    ``Replicate()``.  A dim split over several mesh axes (``("pod",
    "data")``) is split by DTensor in mesh-dim order, so the tuple must name
    them in that order.  With ``shape``, every kept shard must divide its
    dim evenly (the resolver's divisibility drop guarantees it).  A mesh
    axis of size 1 splits nothing: its placement is ``Replicate()`` (some
    torch versions refuse to view a dim "split" over it)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    sizes = mesh_axes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        assert order == sorted(order), (
            f"dim {d} splits over {axes}, not in the mesh's order {names}")
        if shape is not None:
            n = 1
            for a in axes:
                n *= sizes[a]
            assert shape[d] % n == 0, (spec, tuple(shape), d, axes)
        for m in order:
            if sizes[names[m]] > 1:
                out[m] = Shard(d)
    return tuple(out)


def on_local_shards(fn, mesh, args, specs, out_specs):
    """``fn`` on every rank's local shards of ``args`` (each redistributed
    to its spec, a plain tensor taken as replicated; a None spec passes an
    argument through), its outputs wrapped as DTensors of ``out_specs``
    (nested tuples; None for a None output).  Differentiable: the shards
    come from ``to_local`` and go back through ``from_local``; the
    gradient of an argument replicated over a mesh dim that splits
    another argument (a gate's weights beside batch-split activations) is
    a partial sum there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    rep = [Replicate()] * mesh.ndim
    given = [(a, placements(spec, mesh, a.shape)) for a, spec
             in zip(args, specs) if a is not None and spec is not None]
    split = {m for _, pl in given for m, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    local = []
    for a, spec in zip(args, specs):
        if a is None or spec is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        pl = placements(spec, mesh, a.shape)
        grad_pl = [Partial() if m in split and isinstance(p, Replicate)
                   else p for m, p in enumerate(pl)]
        local.append(a.redistribute(mesh, pl).to_local(
            grad_placements=grad_pl))
    out = fn(*local)

    def wrap(o, spec):
        if spec is None or o is None:
            return None
        if isinstance(o, tuple):
            return tuple(wrap(x, sp) for x, sp in zip(o, spec))
        return DTensor.from_local(o, mesh, placements(spec, mesh),
                                  run_check=False)

    return wrap(out, out_specs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def shard_logical(mesh, logical_axes, rules=DEFAULT_RULES,
                  dims=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, mesh, rules,
                                               dims))


def with_sharding_constraint_logical(x, logical_axes, rules=DEFAULT_RULES):
    """Redistribute a DTensor to the placements its logical axes resolve to
    on its own mesh; a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x  # no mesh (single-device paths): no-op
    mesh = x.device_mesh
    spec = logical_to_spec(logical_axes, mesh, rules, dims=x.shape)
    target = placements(spec, mesh, x.shape)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def _axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, axes_tree, *others):
    """``fn(axes, *leaves)`` over a tree whose leaves are logical-axes
    tuples, with parallel trees ``others`` walked up to its structure (the
    reference's ``jax.tree.map(..., is_leaf=_axes_leaf)``)."""
    if _axes_leaf(axes_tree):
        return fn(axes_tree, *others)
    if isinstance(axes_tree, dict):  # in sorted-key order, as jax.tree
        return {k: map_axes(fn, axes_tree[k], *(o[k] for o in others))
                for k in sorted(axes_tree)}
    items = [map_axes(fn, v, *(o[i] for o in others))
             for i, v in enumerate(axes_tree)]
    return items if isinstance(axes_tree, list) else tuple(items)


def tree_shardings(mesh, tree_logical, tree_shapes=None, rules=DEFAULT_RULES):
    """Map a tree of logical-axis tuples (+ optional tensors or shapes) to
    NamedShardings."""
    if tree_shapes is None:
        return map_axes(lambda ax: shard_logical(mesh, ax, rules),
                        tree_logical)
    return map_axes(
        lambda ax, shp: shard_logical(mesh, ax, rules,
                                      dims=tuple(getattr(shp, "shape", shp))),
        tree_logical, tree_shapes)
