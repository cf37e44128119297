"""Distributed layer: shard placement and exchanges, the sharded loops,
speculative epochs and multi-process ingest.

Counterpart of yabpe_tpu/dist/__init__.py; the JAX package's
``state_partition_specs`` (shard_map PartitionSpecs) has no counterpart:
here the layout is ``dist/sharded.py::Shard2DState``'s lists of shards
and slabs.
"""

from yabpe_tpu_torch.dist.mesh import (
    make_2d_mesh,
    make_data_mesh,
    multihost_initialize,
    multiprocess_initialize,
)
from yabpe_tpu_torch.dist.sharded import run_sharded_merge_loop

__all__ = [
    "make_data_mesh",
    "make_2d_mesh",
    "multihost_initialize",
    "multiprocess_initialize",
    "run_sharded_merge_loop",
]
