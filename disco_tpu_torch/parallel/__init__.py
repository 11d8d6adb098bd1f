"""Multi-GPU: meshes over ``torch.distributed`` ranks and the node-, frame-
and batch-sharded TANGO pipelines (counterpart of ``disco_tpu/parallel``).
"""
from disco_tpu_torch.parallel.mesh import (
    gather_result,
    make_mesh,
    make_mesh_2d,
    mesh_from_config,
    node_sharding,
    ring_all_gather,
    shard_of,
    tango_batch_sharded,
    tango_frame_sharded,
    tango_sharded,
)
from disco_tpu_torch.parallel.multihost import distributed_init, hybrid_mesh, single_rank_world

__all__ = [
    "ring_all_gather",
    "make_mesh",
    "make_mesh_2d",
    "mesh_from_config",
    "node_sharding",
    "tango_sharded",
    "tango_frame_sharded",
    "tango_batch_sharded",
    "distributed_init",
    "hybrid_mesh",
    "single_rank_world",
    "shard_of",
    "gather_result",
]
