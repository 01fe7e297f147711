"""Multi-device execution on a single-process device mesh
(``hyperres/parallel``): :mod:`.mesh` (the mesh, sharding helpers and
collectives) and :mod:`.ops` (the sharded operations)."""

from .mesh import make_mesh, shard_batch
from .ops import (
    sharded_histogram_percentile,
    data_parallel_ridge_fit,
    sharded_tile_map,
    halo_exchange_rows,
    sharded_srf_synthesize,
    sharded_orthowarp, sharded_orthowarp_two_pass,
    sharded_streamed_orthowarp,
    sharded_orthowarp_srf_2d,
)

__all__ = [
    "make_mesh", "shard_batch",
    "sharded_histogram_percentile", "data_parallel_ridge_fit",
    "sharded_tile_map", "halo_exchange_rows", "sharded_srf_synthesize",
    "sharded_orthowarp", "sharded_orthowarp_two_pass",
    "sharded_streamed_orthowarp", "sharded_orthowarp_srf_2d",
]
