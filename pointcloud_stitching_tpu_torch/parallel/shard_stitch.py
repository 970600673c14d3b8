"""The camera-sharded stitch: every rank runs the kernels on its own cameras.

Port of ``pointcloud_stitching_tpu/parallel/shard_stitch.py``. Each rank
of a 1-D mesh holds ``num_cameras // D`` cameras (rank r: cameras r·ncl
... (r+1)·ncl-1, the P(axis) placement) and runs the single-device step's
local code on them, with explicit collectives where the data crosses
ranks:

  * deproject / ICP-cloud prep / ICP voxel pass (K2): rank-local;
  * ring drift correction: each rank's first camera needs the LAST camera
    cloud of the previous rank (and its normals for point-to-plane) — one
    ring shift; every rank runs its pairs' ICP (K3 each iteration);
  * the (tiny) per-pair corrections, extrinsics and ICP metrics are
    all-gathered, so every rank composes the same ring correction;
  * per-rank world clouds are voxel-bounded (K2) and all-gathered (only
    ~cam_capacity points per camera cross, never raw frames); the final
    fused voxel pass (K1) is replicated.

Requires cfg.cam_voxel_enabled (it bounds the gathered bytes) and
num_cameras divisible by the mesh size. Outputs are whole and bit for bit
the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.stitcher import (StitchMetrics, StitchOutput,
                               _compose_ring_corrections, _fused_output,
                               _pair_icp, _prepare, _world_clouds,
                               _world_normals)
from ..ops.se3 import mm, se3_apply
from ..ops.voxel import voxel_downsample
from ..utils.config import StitchConfig
from ..utils.types import Intrinsics, PointCloud
from .collectives import all_gather, all_reduce, check_axis, ring_shift


def cameras_per_rank(cfg: StitchConfig, mesh) -> int:
    d = mesh.size()
    if cfg.num_cameras % d != 0:
        raise ValueError(f"num_cameras={cfg.num_cameras} not divisible by "
                         f"mesh size {d}")
    return cfg.num_cameras // d


def _check_rows(ncl: int, cfg: StitchConfig, intr: Intrinsics, extrinsics,
                depths, colors, cam_mask, color_intr, color_ext) -> None:
    rows = {"depths": depths, "extrinsics": extrinsics, "intr.fx": intr.fx,
            "colors": colors, "color_ext": color_ext,
            "color_intr.fx": None if color_intr is None else color_intr.fx}
    for name, t in rows.items():
        if t is not None and (t.dim() == 0 or t.shape[0] != ncl):
            raise ValueError(
                f"{name} holds {tuple(t.shape)[:1]} camera rows; this rank "
                f"holds {ncl} of the {cfg.num_cameras} cameras")
    if cam_mask is not None and tuple(cam_mask.shape) != (cfg.num_cameras,):
        raise ValueError(f"cam_mask must be the whole [{cfg.num_cameras}] "
                         f"mask, got {tuple(cam_mask.shape)}")


def _sharded_drift_correction(cfg: StitchConfig, mesh, icp_clouds: PointCloud,
                              ext_l: torch.Tensor):
    """Ring ICP over this rank's pairs (pair i aligns local camera i to its
    predecessor, the previous rank's last camera for i = 0), then the
    gathered composition. Returns (refined_full [ncam,4,4], err, inl,
    loop_err), identical on every rank."""
    my, ncl = mesh.get_local_rank(), ext_l.shape[0]
    ncam = cfg.num_cameras
    world = se3_apply(ext_l, icp_clouds.xyz)
    # ring shift of the last camera's ICP cloud: icp_capacity x 13 B
    prev_xyz = ring_shift(world[ncl - 1], mesh, 1)
    prev_mask = ring_shift(icp_clouds.mask[ncl - 1], mesh, 1)
    dst_xyz = torch.cat([prev_xyz[None], world[:-1]], dim=0)
    dst_mask = torch.cat([prev_mask[None], icp_clouds.mask[:-1]], dim=0)
    closure = cfg.icp_ring_closure and ncam >= 3
    if not closure and my == 0:
        # chain mode: global camera 0 has no predecessor — mask its pair
        # out (kabsch returns identity for zero total weight). With closure
        # the wrap-around pair the shift delivers IS the measurement.
        dst_mask[0] = False
    dst_n = None
    if cfg.icp_variant == "point_to_plane" and icp_clouds.rgb is not None:
        n_world = _world_normals(icp_clouds.rgb, ext_l)
        # ring shift of the last camera's normals: icp_capacity x 12 B
        prev_n = ring_shift(n_world[ncl - 1], mesh, 1)
        dst_n = torch.cat([prev_n[None], n_world[:-1]], dim=0)
    res = _pair_icp(cfg, PointCloud(xyz=world, mask=icp_clouds.mask),
                    PointCloud(xyz=dst_xyz, mask=dst_mask), dst_n)
    # one all_gather of every camera's delta, extrinsics, error and
    # inliers (the int32 count rides as its bits): ncam x 34 x 4 B
    local = torch.cat([res.T.reshape(ncl, 16), ext_l.reshape(ncl, 16),
                       res.mean_error[:, None],
                       res.num_inliers[:, None].view(torch.float32)], dim=1)
    g = all_gather(local, mesh).reshape(ncam, 34)
    deltas = g[:, :16].reshape(ncam, 4, 4)
    corrections, loop_err = _compose_ring_corrections(
        deltas, closure, gate=cfg.icp_closure_gate,
        gate_rot=cfg.icp_closure_gate_rot)
    refined_full = mm(corrections, g[:, 16:32].reshape(ncam, 4, 4))
    inl = g[:, 33].contiguous().view(torch.int32)
    return refined_full, g[1:, 32], inl[1:], loop_err


def sharded_stitch_step(cfg: StitchConfig, mesh, intr: Intrinsics,
                        extrinsics: torch.Tensor, depths: torch.Tensor,
                        colors: Optional[torch.Tensor] = None,
                        cam_mask: Optional[torch.Tensor] = None,
                        color_intr: Optional[Intrinsics] = None,
                        color_ext: Optional[torch.Tensor] = None,
                        out_leaf=None) -> StitchOutput:
    """``stitch_step`` with the camera axis over ``mesh``: every
    per-camera argument holds this rank's rows, ``cam_mask`` is the whole
    [num_cameras] mask. Returns the whole output on every rank."""
    ncl = cameras_per_rank(cfg, mesh)
    _check_rows(ncl, cfg, intr, extrinsics, depths, colors, cam_mask,
                color_intr, color_ext)
    my, ncam = mesh.get_local_rank(), cfg.num_cameras
    dev = extrinsics.device
    if cam_mask is not None:
        cam_mask = cam_mask[my * ncl:(my + 1) * ncl]
    raw, sub = _prepare(cfg, intr, depths, colors, cam_mask, color_intr,
                        color_ext)
    # all_reduce of the valid-point count: 8 B
    points_in = all_reduce(raw.mask.sum(), "sum", mesh)

    err = torch.zeros((max(ncam - 1, 1),), device=dev)
    inl = torch.zeros((max(ncam - 1, 1),), dtype=torch.int32, device=dev)
    loop_err = torch.zeros((), device=dev)
    if cfg.icp_enabled and ncam > 1:
        icp_clouds = voxel_downsample(sub, cfg.icp_voxel_leaf,
                                      capacity=cfg.icp_capacity,
                                      impl=cfg.kernel_impl)
        refined_full, err, inl, loop_err = _sharded_drift_correction(
            cfg, mesh, icp_clouds, extrinsics)
        refined_l = refined_full[my * ncl:(my + 1) * ncl]
    else:
        # frozen extrinsics: all_gather of ncam x 64 B
        refined_full = all_gather(extrinsics, mesh).reshape(ncam, 4, 4)
        refined_l = extrinsics

    world = _world_clouds(cfg, raw, refined_l)
    # all_gather of the voxel-bounded world clouds: ncam x cam_capacity x
    # (12 + 1 (+ 12 with rgb)) B (the raw clouds without the camera pass)
    gathered = PointCloud(
        xyz=all_gather(world.xyz, mesh).flatten(0, 1),
        mask=all_gather(world.mask, mesh).flatten(0, 1),
        rgb=(None if world.rgb is None
             else all_gather(world.rgb, mesh).flatten(0, 1)))
    out = _fused_output(cfg, gathered, out_leaf)
    metrics = StitchMetrics(points_in=points_in, points_out=out.count(),
                            icp_mean_error=err, icp_inliers=inl,
                            loop_error=loop_err)
    return StitchOutput(cloud=out, extrinsics=refined_full, metrics=metrics)


def make_shardmap_stitch(cfg: StitchConfig, mesh, axis: str = "cam"):
    """Build a sharded stitch step: (intr, extrinsics, depths) ->
    StitchOutput, each argument this rank's camera rows (intr batched,
    extrinsics [ncl, 4, 4], depths [ncl, H, W]). Forces the per-camera
    voxel pass on. Outputs are replicated."""
    check_axis(mesh, axis)
    cameras_per_rank(cfg, mesh)
    if not cfg.cam_voxel_enabled:
        cfg = dataclasses.replace(cfg, cam_voxel_enabled=True)

    def step(intr: Intrinsics, extrinsics: torch.Tensor,
             depths: torch.Tensor) -> StitchOutput:
        return sharded_stitch_step(cfg, mesh, intr, extrinsics, depths)

    return step
