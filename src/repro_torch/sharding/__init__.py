"""Spreading one edge-detection call over an image mesh: batch groups and a
spatial grid with halo exchange (:mod:`repro_torch.sharding.halo`)."""
from repro_torch.sharding.halo import (  # noqa: F401
    ShardConfig,
    exchange_radius,
    extend_axis,
    halo_exchange,
    mesh_from_config,
    shard_geometry,
    sharded_edge,
)
