"""Multi-device execution on ``torch.distributed``: one process per device.

Port of ``pointcloud_stitching_tpu/parallel/``: the camera-sharded stitch
(``make_sharded_stitch``, ``make_shardmap_stitch``), the ring
nearest-neighbour search and the Z-slab sharded TSDF, on a 1-D
``DeviceMesh`` of ranks (``make_mesh``) with the explicit collectives of
``parallel/collectives.py``. Importing the package creates no process
group and touches no device; ``init_multihost`` (or ``torchrun``'s
environment) does that.
"""
from .mesh import make_mesh, make_sharded_stitch, replicate
from .multihost import init_multihost
from .ring_nn import ring_nearest_neighbors
from .shard_stitch import make_shardmap_stitch
from .tsdf_shard import (make_sharded_integrate, make_sharded_raycast,
                         shard_volume)

__all__ = ["init_multihost", "make_mesh", "make_sharded_integrate",
           "make_sharded_raycast", "make_sharded_stitch",
           "make_shardmap_stitch", "replicate", "ring_nearest_neighbors",
           "shard_volume"]
