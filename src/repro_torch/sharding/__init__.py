"""Sharding: the logical-axis rules and their trees of specs
(:mod:`~repro_torch.sharding.rules`, :mod:`~repro_torch.sharding.partition`),
leaves placed on a mesh with the collectives between their shards
(:mod:`~repro_torch.sharding.placed`), and spreading one edge-detection
call over an image mesh: batch groups and a spatial grid with halo exchange
(:mod:`~repro_torch.sharding.halo`)."""
from repro_torch.sharding.partition import (  # noqa: F401
    image_spec,
    layout_logical_axes,
    replicated,
    shardings_for_tree,
    specs_for_tree,
)
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    IMAGE_RULES,
    LM_RULES,
    NamedSharding,
    PartitionSpec,
    activation_shard,
    current_mesh,
    get_rules,
    logical_to_spec,
    mesh_context,
    sharding_for,
)
from repro_torch.sharding.halo import (  # noqa: F401
    ShardConfig,
    exchange_radius,
    extend_axis,
    halo_exchange,
    mesh_from_config,
    shard_geometry,
    sharded_edge,
)
