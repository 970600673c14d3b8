"""The multi-camera stitching pipeline.

Port of ``pointcloud_stitching_tpu/models/stitcher.py``. The camera axis is
a batch dimension, and one step does

  batched deproject → grid-stride ICP subsample (+ grid normals) → batched
  ICP voxel pass (K2) → ring point-to-plane ICP (K3 every iteration) →
  ring-correction composition → SE(3) into world → fuse → optional crop →
  one global voxel pass (K1)

on the device, eagerly (the JAX package jits the whole step). Colour rides
the cloud's rgb channel: depth-aligned (``deproject_with_color``) or
texture-mapped from a colour stream with its own calibration
(``map_color``); the coloured global pass sums 10 channels through K1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.filters import crop_box
from ..ops.fuse import fuse_batched
from ..ops.icp import icp_batched, icp_point_to_plane_batched
from ..ops.normals import grid_normals
from ..ops.se3 import mm, se3_apply, se3_blend, se3_identity, se3_power
from ..ops.deproject import deproject, deproject_with_color, map_color
from ..ops.voxel import decimate_depth, voxel_downsample
from ..utils.config import StitchConfig
from ..utils.platform import platform_device, set_full_fp32_matmul
from ..utils.types import Intrinsics, PointCloud, scalar


class StitchMetrics(NamedTuple):
    points_in: torch.Tensor        # valid raw points this frame
    points_out: torch.Tensor       # voxels in the fused output
    icp_mean_error: torch.Tensor   # [ncam-1] per-pair mean sq residual
    icp_inliers: torch.Tensor      # [ncam-1]
    # |r - I|_F^2 of the ring-closure residual; 0 without closure
    loop_error: torch.Tensor | float = 0.0


class StitchOutput(NamedTuple):
    cloud: PointCloud              # fused, downsampled world-frame cloud
    extrinsics: torch.Tensor       # [ncam, 4, 4] refined extrinsics
    metrics: StitchMetrics
    # the frame's raw device inputs, attached by the streaming client (None
    # from direct pipeline calls): depth-domain consumers (TSDF integrate,
    # tracking) run on the exact frame the stitch saw
    depth: Optional[torch.Tensor] = None      # [ncam, H, W] raw units
    color: Optional[torch.Tensor] = None      # [ncam, H, W, 3] rgb
    cam_mask: Optional[torch.Tensor] = None   # [ncam] bool


def autofit_out_leaf(points_out: torch.Tensor, leaf, *, capacity: int,
                     floor: float, ceil: float, grow: float = 1.25,
                     headroom: float = 0.85) -> torch.Tensor:
    """Per-frame output-leaf controller for a fixed-capacity voxel grid:
    grow the leaf by ``grow`` after a saturated frame, shrink it toward
    ``floor`` when a finer grid would fit with ``headroom`` (cubic guard),
    clip to [floor, ceil]. Runs on the device; no host sync."""
    pts = points_out.to(torch.float32)
    cap = float(capacity)
    leaf = scalar(leaf, pts)
    nxt = torch.where(pts >= cap, leaf * grow,
                      torch.where(pts * grow ** 3 < headroom * cap,
                                  leaf / grow, leaf))
    return torch.clamp(nxt, floor, ceil)


def _compose_ring_corrections(deltas: torch.Tensor, closure: bool,
                              gate=float("inf"), gate_rot=float("inf")):
    """Chain-compose per-pair ICP corrections, optionally closing the ring.

    deltas: [ncam, 4, 4], deltas[i] aligns camera i to camera i-1 (mod
    ncam); deltas[0] is the ring-closing pair. corrections[k] = deltas[1]
    @ ... @ deltas[k] (camera 0 anchors), as left-to-right prefix products.
    With closure, the loop residual r = corrections[-1] @ deltas[0] is
    spread along the chain as r^(-k/ncam) — unless its translation exceeds
    ``gate`` meters or its rotation ``gate_rot`` radians (a false closure).
    Returns (corrections [ncam, 4, 4], loop_error = |r - I|_F^2).
    """
    eye = torch.eye(4, dtype=torch.float32, device=deltas.device)
    prefix = [eye]
    for k in range(1, deltas.shape[0]):
        prefix.append(mm(prefix[-1], deltas[k]))
    prefix = torch.stack(prefix)
    if not closure:
        return prefix, torch.zeros((), device=deltas.device)
    ncam = deltas.shape[0]
    residual = mm(prefix[-1], deltas[0])
    loop_err = ((residual - eye) ** 2).sum()
    cos_theta = (torch.diagonal(residual[:3, :3]).sum() - 1.0) * 0.5
    g_rot = scalar(gate_rot, deltas)
    # gate_rot >= pi admits any rotation (-2 is below any cos_theta)
    rot_thresh = torch.where(g_rot >= torch.pi, -2.0, torch.cos(g_rot))
    ok = (((residual[:3, 3] ** 2).sum() <= scalar(gate, deltas) ** 2)
          & (cos_theta >= rot_thresh))
    alphas = (-torch.arange(ncam, dtype=torch.float32, device=deltas.device)
              / ncam * ok.to(torch.float32))
    return mm(se3_power(residual, alphas), prefix), loop_err


def _world_normals(normals: torch.Tensor,
                   extrinsics: torch.Tensor) -> torch.Tensor:
    """Voxel-averaged sensor-frame normals [ncam, C, 3] -> unit world-frame
    normals (zero where the average is too short to trust)."""
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    n = torch.where(norm > 0.5, normals / torch.clamp(norm, min=1e-12), 0.0)
    return torch.einsum("cij,cnj->cni", extrinsics[:, :3, :3], n)


def _pair_icp(cfg: StitchConfig, src: PointCloud, dst: PointCloud,
              dst_n: Optional[torch.Tensor]):
    """One batched ICP over camera pairs: point-to-plane when the
    destination normals are given, else point-to-point."""
    if dst_n is not None:
        return icp_point_to_plane_batched(
            src, dst, dst_n, iterations=cfg.icp_iterations,
            max_corr_dist=cfg.icp_max_corr_dist, nn_impl=cfg.kernel_impl,
            trim_fraction=cfg.icp_trim_fraction)
    return icp_batched(src, dst, iterations=cfg.icp_iterations,
                       max_corr_dist=cfg.icp_max_corr_dist,
                       nn_impl=cfg.kernel_impl,
                       trim_fraction=cfg.icp_trim_fraction)


def _ring_drift_correction(cfg: StitchConfig, clouds: PointCloud,
                           extrinsics: torch.Tensor):
    """Refine extrinsics by aligning each camera's ICP cloud to its ring
    predecessor (all pairs in one batched ICP). clouds: sensor-frame
    [ncam, C, 3] (+mask; rgb carries normals in point-to-plane mode).
    Returns (refined [ncam,4,4], per-pair errors, inliers, loop error)."""
    ncam = cfg.num_cameras
    closure = cfg.icp_ring_closure and ncam >= 3
    world = PointCloud(xyz=se3_apply(extrinsics, clouds.xyz),
                       mask=clouds.mask)
    if closure:
        # pair i aligns camera i to camera i-1 (mod ncam); pair 0 closes
        src = world
        dst = PointCloud(xyz=torch.roll(world.xyz, 1, dims=0),
                         mask=torch.roll(world.mask, 1, dims=0))
    else:
        src = PointCloud(xyz=world.xyz[1:], mask=world.mask[1:])
        dst = PointCloud(xyz=world.xyz[:-1], mask=world.mask[:-1])

    dst_n = None
    if cfg.icp_variant == "point_to_plane" and clouds.rgb is not None:
        n_world = _world_normals(clouds.rgb, extrinsics)
        dst_n = torch.roll(n_world, 1, dims=0) if closure else n_world[:-1]
    res = _pair_icp(cfg, src, dst, dst_n)
    if closure:
        deltas = res.T
        err, inl = res.mean_error[1:], res.num_inliers[1:]
    else:
        eye = torch.eye(4, dtype=torch.float32, device=res.T.device)[None]
        deltas = torch.cat([eye, res.T], dim=0)
        err, inl = res.mean_error, res.num_inliers
    corrections, loop_err = _compose_ring_corrections(
        deltas, closure, gate=cfg.icp_closure_gate,
        gate_rot=cfg.icp_closure_gate_rot)
    return mm(corrections, extrinsics), err, inl, loop_err


def _world_clouds(cfg: StitchConfig, raw: PointCloud,
                  extrinsics: torch.Tensor) -> PointCloud:
    """Per-camera clouds [ncam, C, 3] in the world frame: the optional
    per-camera voxel pass (K2), then SE(3); with_normals rotates the
    normals in rgb and quantises them to 3x8 bits."""
    clouds = raw
    if cfg.cam_voxel_enabled:
        clouds = voxel_downsample(clouds, cfg.cam_voxel_leaf,
                                  capacity=cfg.cam_capacity,
                                  impl=cfg.kernel_impl)
    world = clouds.replace(xyz=se3_apply(extrinsics, clouds.xyz))
    if cfg.with_normals and clouds.rgb is not None:
        # normals rotate with the refined extrinsics, then quantise to
        # 3x8-bit so the output voxel pass can take the packed branch
        R = extrinsics[..., :3, :3]
        nw = torch.einsum("cij,cnj->cni", R, clouds.rgb)
        world = world.replace(
            rgb=torch.clamp(torch.round((nw + 1.0) * 127.5), 0.0, 255.0))
    return world


def _fused_output(cfg: StitchConfig, world: PointCloud,
                  out_leaf=None) -> PointCloud:
    """Every camera's world cloud fused, cropped, and through the global
    voxel pass (K1)."""
    fused = fuse_batched(world)
    if cfg.crop_lo is not None:
        fused = crop_box(fused, cfg.crop_lo, cfg.crop_hi)
    leaf = cfg.out_voxel_leaf if out_leaf is None else out_leaf
    return voxel_downsample(fused, leaf, capacity=cfg.out_capacity,
                            impl=cfg.kernel_impl)


def _stitch_tail(cfg: StitchConfig, raw: PointCloud, extrinsics: torch.Tensor,
                 points_in: torch.Tensor, sub: PointCloud,
                 out_leaf=None) -> StitchOutput:
    """Shared back half: ring drift correction → world → fuse → voxel."""
    ncam = cfg.num_cameras
    dev = extrinsics.device
    icp_err = torch.zeros((max(ncam - 1, 1),), device=dev)
    icp_inl = torch.zeros((max(ncam - 1, 1),), dtype=torch.int32, device=dev)
    loop_err = torch.zeros((), device=dev)
    if cfg.icp_enabled and ncam > 1:
        icp_clouds = voxel_downsample(sub, cfg.icp_voxel_leaf,
                                      capacity=cfg.icp_capacity,
                                      impl=cfg.kernel_impl)
        extrinsics, icp_err, icp_inl, loop_err = _ring_drift_correction(
            cfg, icp_clouds, extrinsics)
    out = _fused_output(cfg, _world_clouds(cfg, raw, extrinsics), out_leaf)
    metrics = StitchMetrics(points_in=points_in, points_out=out.count(),
                            icp_mean_error=icp_err, icp_inliers=icp_inl,
                            loop_error=loop_err)
    return StitchOutput(cloud=out, extrinsics=extrinsics, metrics=metrics)


def _prepare(cfg: StitchConfig, intr: Intrinsics, depths: torch.Tensor,
             colors: Optional[torch.Tensor] = None,
             cam_mask: Optional[torch.Tensor] = None,
             color_intr: Optional[Intrinsics] = None,
             color_ext: Optional[torch.Tensor] = None):
    """The step's per-camera front half, on any number of cameras (the
    sharded step runs it on a rank's rows): decimation, deprojection (with
    colour), the camera mask, full-resolution normals (with_normals) and
    the ICP cloud's grid-stride subsample (+ grid normals). Returns (raw,
    sub), both [n, P, 3] (+mask, +rgb)."""
    n = depths.shape[0]
    if colors is not None and cfg.with_normals:
        # both ride the rgb channel: the normals would overwrite the colour
        raise ValueError("stitch_step got a colors array but "
                         "cfg.with_normals is set — normals and color "
                         "both ride the rgb channel; drop one")

    depths = decimate_depth(depths, cfg.decimation)
    if cfg.decimation > 1:
        # decimated pixel (u, v) is original pixel (u*s, v*s)
        s0 = float(cfg.decimation)
        intr = intr.replace(fx=intr.fx / s0, fy=intr.fy / s0,
                            ppx=intr.ppx / s0, ppy=intr.ppy / s0,
                            width=cfg.width // cfg.decimation,
                            height=cfg.height // cfg.decimation)
    if colors is not None and color_intr is None:
        if cfg.decimation > 1:
            colors = colors[..., ::cfg.decimation, ::cfg.decimation, :]
        raw = deproject_with_color(depths, colors, intr,
                                   depth_scale=cfg.depth_scale,
                                   z_min=cfg.z_min, z_max=cfg.z_max)
    else:
        raw = deproject(depths, intr, depth_scale=cfg.depth_scale,
                        z_min=cfg.z_min, z_max=cfg.z_max)
    if colors is not None and color_intr is not None:
        # non-aligned colour: points project into the colour camera, so
        # depth decimation needs no colour-side counterpart
        if color_ext is None:
            color_ext = se3_identity(device=depths.device)
        raw = map_color(raw, colors, color_intr, color_ext)
    if cam_mask is not None:
        raw = raw.replace(mask=raw.mask & cam_mask[:, None])

    h = cfg.height // cfg.decimation
    w = cfg.width // cfg.decimation

    if cfg.with_normals:
        # full-resolution grid normals ride the rgb channel (sensor frame;
        # _world_clouds rotates and quantises them)
        nrm_full, _ = grid_normals(raw.xyz.reshape(n, h, w, 3),
                                   raw.mask.reshape(n, h, w))
        raw = raw.replace(rgb=nrm_full.reshape(n, -1, 3))

    # ICP clouds from a grid-stride subsample + a small voxel pass
    s = cfg.icp_stride
    sub_xyz = raw.xyz.reshape(n, h, w, 3)[:, ::s, ::s]
    sub_mask = raw.mask.reshape(n, h, w)[:, ::s, ::s]
    sub_rgb = None
    if cfg.icp_enabled and cfg.icp_variant == "point_to_plane":
        # normals of the strided grid ride the ICP voxel pass in rgb
        nrm, nvalid = grid_normals(sub_xyz, sub_mask)
        sub_mask = sub_mask & nvalid
        sub_rgb = nrm.reshape(n, -1, 3)
    sub = PointCloud(xyz=sub_xyz.reshape(n, -1, 3),
                     mask=sub_mask.reshape(n, -1), rgb=sub_rgb)
    return raw, sub


def stitch_step(cfg: StitchConfig, intr: Intrinsics, extrinsics: torch.Tensor,
                depths: torch.Tensor, colors: Optional[torch.Tensor] = None,
                cam_mask: Optional[torch.Tensor] = None,
                color_intr: Optional[Intrinsics] = None,
                color_ext: Optional[torch.Tensor] = None,
                out_leaf=None) -> StitchOutput:
    """One full stitching step; a pure function of its inputs. The
    positional order is the JAX package's.

    Args:
      cfg: configuration.
      intr: camera-batched Intrinsics on the depths' device.
      extrinsics: [ncam, 4, 4] camera→world transforms.
      depths: [ncam, H, W] uint16 raw depth.
      colors: optional [ncam, H, W, 3] uint8 depth-aligned colour — or,
        with color_intr, [ncam, Hc, Wc, 3] colour at its own resolution.
      cam_mask: optional [ncam] bool — False drops a camera.
      color_intr/color_ext: optional colour-stream Intrinsics and [ncam, 4,
        4] depth→colour extrinsics (identity when None): colour attaches by
        projecting each point into the colour camera (``map_color``).
      out_leaf: optional 0-d tensor overriding cfg.out_voxel_leaf.
    """
    ncam = cfg.num_cameras
    if depths.shape[0] != ncam:
        raise ValueError(f"depths has {depths.shape[0]} cameras, cfg {ncam}")
    raw, sub = _prepare(cfg, intr, depths, colors, cam_mask, color_intr,
                        color_ext)
    return _stitch_tail(cfg, raw, extrinsics, raw.mask.sum(), sub, out_leaf)


def stitch_points_step(cfg: StitchConfig, extrinsics: torch.Tensor,
                       clouds: PointCloud,
                       cam_mask: Optional[torch.Tensor] = None,
                       out_leaf=None) -> StitchOutput:
    """Stitch pre-deprojected per-camera clouds [ncam, P, 3] (+mask), in
    sensor frames (the legacy points payload)."""
    ncam = cfg.num_cameras
    if clouds.xyz.shape[0] != ncam:
        raise ValueError(f"clouds has {clouds.xyz.shape[0]} cameras, "
                         f"cfg {ncam}")
    if cam_mask is not None:
        clouds = clouds.replace(mask=clouds.mask & cam_mask[:, None])
    points_in = clouds.mask.sum()
    s = cfg.icp_stride * cfg.icp_stride  # the depth path's area ratio
    sub = PointCloud(xyz=clouds.xyz[:, ::s], mask=clouds.mask[:, ::s])
    return _stitch_tail(cfg, clouds, extrinsics, points_in, sub, out_leaf)


class StitchingPipeline:
    """Stateful wrapper: holds config, calibration and device.

    Extrinsic update modes after each frame's drift correction:

      * 'anchored' (default): the calibrated extrinsics stay frozen and
        each frame's correction is computed fresh from them;
      * 'track': refined extrinsics become the next frame's base;
      * 'ema': exponential blend toward the refined transforms.
    """

    def __init__(self, cfg: StitchConfig, intr: Intrinsics, extrinsics,
                 update_mode: str = "anchored",
                 ema_alpha: float = 0.05,
                 color_intr: Optional[Intrinsics] = None,
                 color_ext=None, *, device=None):
        """The JAX package's parameters at its positions.
        color_intr/color_ext: per-camera colour-stream calibration for
        non-aligned colour (see stitch_step); required when
        cfg.color_height is set. ``device`` (keyword only) defaults to
        ``utils.platform.platform_device()``: the GPU, or the CPU only
        when ``PCS_PLATFORM=cpu`` asks for it."""
        if update_mode not in ("anchored", "track", "ema"):
            raise ValueError(update_mode)
        if cfg.color_height is not None and color_intr is None:
            raise ValueError("cfg.color_height set but no color_intr given")
        set_full_fp32_matmul()
        self.cfg = cfg
        self.device = (platform_device() if device is None
                       else torch.device(device))
        self.intr = intr.to(self.device)
        self.color_intr = (None if color_intr is None
                           else color_intr.to(self.device))
        self.color_ext = (None if color_ext is None else torch.as_tensor(
            color_ext, dtype=torch.float32).to(self.device))
        self.extrinsics = torch.as_tensor(extrinsics, dtype=torch.float32
                                          ).to(self.device)
        self.update_mode = update_mode
        self.ema_alpha = ema_alpha
        # adaptive output resolution: a device scalar fed back frame to
        # frame, like the extrinsics
        self.out_leaf = None
        if cfg.out_leaf_autofit:
            self.out_leaf = torch.full((), cfg.out_voxel_leaf,
                                       dtype=torch.float32, device=self.device)

    def _update(self, out: StitchOutput) -> None:
        if self.cfg.icp_enabled and self.update_mode == "track":
            self.extrinsics = out.extrinsics
        elif self.cfg.icp_enabled and self.update_mode == "ema":
            self.extrinsics = se3_blend(self.extrinsics, out.extrinsics,
                                        self.ema_alpha)
        if self.out_leaf is not None:
            self.out_leaf = autofit_out_leaf(
                out.metrics.points_out, self.out_leaf,
                capacity=self.cfg.out_capacity,
                floor=self.cfg.out_voxel_leaf, ceil=self.cfg.out_leaf_max)

    def __call__(self, depths, colors=None, cam_mask=None) -> StitchOutput:
        depths = torch.as_tensor(depths).to(self.device)
        if colors is not None:
            colors = torch.as_tensor(colors).to(self.device)
        if cam_mask is not None:
            cam_mask = torch.as_tensor(cam_mask).to(self.device)
        out = stitch_step(self.cfg, self.intr, self.extrinsics, depths,
                          colors, cam_mask, self.color_intr, self.color_ext,
                          self.out_leaf)
        self._update(out)
        return out

    def step_points(self, xyz, point_mask, rgb=None,
                    cam_mask=None) -> StitchOutput:
        """Stitch pre-deprojected clouds (legacy points mode)."""
        rgb_f = None if rgb is None else torch.as_tensor(rgb).to(
            self.device, torch.float32)
        clouds = PointCloud(xyz=torch.as_tensor(xyz).to(self.device),
                            mask=torch.as_tensor(point_mask).to(self.device),
                            rgb=rgb_f)
        if cam_mask is not None:
            cam_mask = torch.as_tensor(cam_mask).to(self.device)
        out = stitch_points_step(self.cfg, self.extrinsics, clouds, cam_mask,
                                 self.out_leaf)
        self._update(out)
        return out
