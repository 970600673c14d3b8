"""Multi-device execution: the camera axis over a mesh of ranks.

Port of ``pointcloud_stitching_tpu/parallel/mesh.py``. The reference's
process-per-camera distribution (one pcs-camera-server per capture host,
a thread per camera in the client) becomes one process per device, the
ranks of a ``torch.distributed`` process group laid out as a 1-D
``DeviceMesh`` (the counterpart of a 1-D ``jax.sharding.Mesh``). Each rank
deprojects and downsamples its own cameras:

  * per-camera deproject + voxel: rank-local (no communication);
  * ring-pairwise ICP: each rank's boundary ICP cloud goes one step round
    the ring;
  * fusion + global voxel grid: an all-gather of the (downsampled)
    per-camera clouds; raw frames never cross ranks.

PyTorch has no GSPMD partitioner, so ``make_sharded_stitch`` keeps the
reference's name and whole ``stitch_step`` signature and runs the explicit
collectives of ``shard_stitch.py`` on the same local code; every rank
launches its own kernels (the reference's coercion to the XLA kernels,
needed only because Pallas calls have no partitioning rule, has no
counterpart).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.config import StitchConfig
from .collectives import broadcast, check_axis, tree_map
from .shard_stitch import cameras_per_rank, sharded_stitch_step


def make_mesh(n_devices: Optional[int] = None, axis: str = "cam"
              ) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks of the
    process group (all of them by default). Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_multihost (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if n_devices is not None and world < n_devices:
        raise ValueError(f"need {n_devices} ranks, the process group has "
                         f"{world}")
    n = world if n_devices is None else n_devices
    # the device type whose tensors the group's backend moves: gloo
    # moves host memory (collectives.py stages CUDA tensors through it)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(axis,))


def make_sharded_stitch(cfg: StitchConfig, mesh: DeviceMesh,
                        axis: str = "cam"):
    """``stitch_step`` with the camera axis over ``mesh``.

    num_cameras must be a multiple of the mesh size. Every per-camera
    argument holds this rank's rows (rank r: cameras r·ncl ... (r+1)·ncl-1
    of ncl = num_cameras // D): intr, extrinsics, depths, colors,
    color_intr, color_ext; ``cam_mask`` is the whole [num_cameras] mask
    and ``out_leaf`` a scalar. cfg is honoured as ``stitch_step`` honours
    it (the per-camera pass only when cam_voxel_enabled; without it the
    raw clouds are gathered). The output cloud, the refined extrinsics of
    every camera and the metrics are replicated: every rank ends the step
    with the same fused cloud.
    """
    check_axis(mesh, axis)
    cameras_per_rank(cfg, mesh)

    def call(intr, extrinsics, depths, colors=None, cam_mask=None,
             color_intr=None, color_ext=None, out_leaf=None):
        return sharded_stitch_step(cfg, mesh, intr, extrinsics, depths,
                                   colors, cam_mask, color_intr, color_ext,
                                   out_leaf)

    return call


def replicate(mesh: DeviceMesh, x):
    """Rank 0's tensors of the tree ``x`` on every rank (each rank passes
    tensors of the same shapes and dtypes)."""
    # one broadcast per tensor: its bytes to each other rank
    return tree_map(lambda t: broadcast(t, mesh), x)
