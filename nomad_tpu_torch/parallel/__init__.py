"""The node-sharded dispatch (the port's part of the JAX package's
``parallel/``): the cluster matrix's node axis split over an ordered list
of devices shaped ``('batch', 'node')``, and the batch assembly helpers
of ``score_batch``."""

from .sharding import (
    Mesh,
    ShardedArrays,
    TOPK_K,
    build_batch_inputs,
    make_mesh,
    make_sharded_row_scatter,
    node_shard_count,
    shard_matrix_arrays,
    sharded_fused_place_batch,
    sharded_place_batch,
    sharded_schedule_step,
    stack_requests,
)

__all__ = [
    "Mesh",
    "ShardedArrays",
    "TOPK_K",
    "build_batch_inputs",
    "make_mesh",
    "make_sharded_row_scatter",
    "node_shard_count",
    "shard_matrix_arrays",
    "sharded_fused_place_batch",
    "sharded_place_batch",
    "sharded_schedule_step",
    "stack_requests",
]
