"""Logical-axis sharding rules (MaxText-style).

Port of ``repro.sharding``.  Model code annotates tensors with *logical*
axis names; a rules table maps logical names -> mesh axis (or None =
replicated).  This keeps model code mesh-agnostic: the same model runs
unsharded, on a 1 x 1 host mesh, or lowers for a 16x16 or 2x16x16 mesh by
swapping the rules.  A resolved spec becomes DTensor placements on a
``torch.distributed`` ``DeviceMesh`` (``placements``).
"""
from repro_torch.sharding.rules import (  # noqa: F401
    AbstractMesh,
    AxisRules,
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    logical_to_spec,
    map_axes,
    on_local_shards,
    placements,
    shard_logical,
    tree_shardings,
    with_sharding_constraint_logical,
)
