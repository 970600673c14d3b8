"""Depth image → 3-D point deprojection.

Port of ``pointcloud_stitching_tpu/ops/deproject.py``'s ``deproject``
(librealsense ``rs2_deproject_pixel_to_point``) and its inverse
``project``:

    x = (u - ppx) / fx,  y = (v - ppy) / fy,  [distortion correction],
    X = x * d,  Y = y * d,  Z = d        (d = depth_raw * depth_scale)

A pure elementwise map over the [H, W] grid, batched over cameras. Pixels
with zero (or out-of-range) depth become masked, zeroed points. The
division in ``(u - ppx) / fx`` is kept as the JAX code has it (a reciprocal
multiply would differ in the last ulp).

``project`` forms the pinhole ``x * fx + ppx`` with ``torch.addcmul``: one
fused multiply-add, as XLA contracts it, so projected pixel coordinates are
the JAX package's bit for bit on the CPU (a separate multiply and add
differs in the last bit, which can move ``round(u)`` to the next pixel).

Colour attaches in one of two ways: ``deproject_with_color`` for
depth-aligned colour (a per-pixel lookup) and ``map_color`` /
``deproject_with_color_mapped`` for a colour stream with its own
intrinsics and a depth→colour extrinsic (librealsense's ``map_to``: project
each point into the colour camera, round to the nearest pixel with
``torch.round``, which rounds half to even as ``jnp.round`` does, and
gather). On a CUDA cloud ``map_color`` is one kernel launch
(``kernels/map_color.py``) for every camera.
"""
from __future__ import annotations

import torch

from ..kernels.build import use_kernel
from ..kernels.map_color import map_color_cuda
from ..utils.types import DistortionModel, Intrinsics, PointCloud
from .se3 import se3_apply


def _undistort_brown_conrady_iterative(x, y, coeffs, iters: int = 10):
    """Invert the forward Brown–Conrady model by fixed-point iteration
    (librealsense's RS2_DISTORTION_BROWN_CONRADY deprojection)."""
    k1, k2, p1, p2, k3 = (coeffs[..., i] for i in range(5))
    xo, yo = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        x, y = (xo - dx) * icdist, (yo - dy) * icdist
    return x, y


def _distort_inverse_brown_conrady(x, y, coeffs):
    """Apply the stored inverse polynomial forward (closed form)."""
    k1, k2, p1, p2, k3 = (coeffs[..., i] for i in range(5))
    r2 = x * x + y * y
    f = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    ux = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    uy = y * f + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return ux, uy


def deproject(depth: torch.Tensor, intr: Intrinsics,
              depth_scale: float = 0.001, z_min: float = 0.0,
              z_max: float = float("inf")) -> PointCloud:
    """Deproject a (possibly camera-batched) depth image to 3-D points.

    Args:
      depth: [..., H, W] uint16 raw depth units (or float meters, scale 1).
      intr: Intrinsics on depth's device; batched fields broadcast against
        the leading depth dims.
    Returns:
      PointCloud with xyz [..., H*W, 3] and mask [..., H*W], row-major
      pixel order (v major).
    """
    h, w = depth.shape[-2], depth.shape[-1]
    dev = depth.device
    z = depth.to(torch.float32) * torch.tensor(depth_scale, dtype=torch.float32)
    u = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)

    def expand(p):  # [...] -> [..., 1, 1] for broadcasting over H, W
        return p.to(torch.float32)[..., None, None]

    x = (u - expand(intr.ppx)) / expand(intr.fx)
    y = (v - expand(intr.ppy)) / expand(intr.fy)

    if intr.model in (int(DistortionModel.BROWN_CONRADY),
                      int(DistortionModel.INVERSE_BROWN_CONRADY),
                      int(DistortionModel.MIXED)):
        coeffs = intr.coeffs.to(torch.float32)[..., None, None, :]
    if intr.model == int(DistortionModel.BROWN_CONRADY):
        x, y = _undistort_brown_conrady_iterative(x, y, coeffs)
    elif intr.model == int(DistortionModel.INVERSE_BROWN_CONRADY):
        x, y = _distort_inverse_brown_conrady(x, y, coeffs)
    elif intr.model == int(DistortionModel.MIXED):
        # every correction, selected per camera by its model id
        x_bc, y_bc = _undistort_brown_conrady_iterative(x, y, coeffs)
        x_ibc, y_ibc = _distort_inverse_brown_conrady(x, y, coeffs)
        mid = intr.model_ids.to(torch.int32)[..., None, None]
        is_bc = mid == int(DistortionModel.BROWN_CONRADY)
        is_ibc = mid == int(DistortionModel.INVERSE_BROWN_CONRADY)
        x = torch.where(is_bc, x_bc, torch.where(is_ibc, x_ibc, x))
        y = torch.where(is_bc, y_bc, torch.where(is_ibc, y_ibc, y))

    xyz = torch.stack([x * z, y * z, z], dim=-1)
    zlo = torch.tensor(max(z_min, 0.0), dtype=torch.float32)
    mask = z > zlo
    if z_max != float("inf"):
        mask = mask & (z <= torch.tensor(z_max, dtype=torch.float32))

    batch = depth.shape[:-2]
    xyz = xyz.reshape(*batch, h * w, 3)
    mask = mask.reshape(*batch, h * w)
    xyz = torch.where(mask[..., None], xyz, 0.0)
    return PointCloud(xyz=xyz, mask=mask)


def project_planes(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   intr: Intrinsics):
    """``project`` on coordinate planes (camera-frame x, y, z of one shape):
    returns (u, v, in_front). The intrinsics' fields broadcast against the
    planes as they are (0-d for one camera)."""
    in_front = z > 1e-9
    zs = torch.where(in_front, z, 1.0)
    x = x / zs
    y = y / zs
    if intr.model != int(DistortionModel.NONE):
        coeffs = intr.coeffs.to(torch.float32)
    if intr.model == int(DistortionModel.BROWN_CONRADY):
        x, y = _distort_inverse_brown_conrady(x, y, coeffs)
    elif intr.model == int(DistortionModel.INVERSE_BROWN_CONRADY):
        x, y = _undistort_brown_conrady_iterative(x, y, coeffs)
    elif intr.model == int(DistortionModel.MIXED):
        x_bc, y_bc = _distort_inverse_brown_conrady(x, y, coeffs)
        x_ibc, y_ibc = _undistort_brown_conrady_iterative(x, y, coeffs)
        mid = intr.model_ids.to(torch.int32)
        is_bc = mid == int(DistortionModel.BROWN_CONRADY)
        is_ibc = mid == int(DistortionModel.INVERSE_BROWN_CONRADY)
        x = torch.where(is_bc, x_bc, torch.where(is_ibc, x_ibc, x))
        y = torch.where(is_bc, y_bc, torch.where(is_ibc, y_ibc, y))
    u = torch.addcmul(intr.ppx.to(torch.float32), x, intr.fx.to(torch.float32))
    v = torch.addcmul(intr.ppy.to(torch.float32), y, intr.fy.to(torch.float32))
    return u, v, in_front


def project(xyz: torch.Tensor, intr: Intrinsics):
    """Project camera-frame points [..., N, 3] to pixel coordinates
    (librealsense ``rs2_project_point_to_pixel``): normalise by z, apply the
    forward polynomial for BROWN_CONRADY, invert the stored inverse map by
    fixed-point iteration for INVERSE_BROWN_CONRADY, select per camera for
    MIXED, then the pinhole. Returns (uv [..., N, 2] float32, in_front
    [..., N] bool: z > 1e-9)."""
    def expand(p):  # [...] -> [..., 1] for broadcasting over N
        return None if p is None else p[..., None]

    per_point = intr.replace(
        fx=expand(intr.fx), fy=expand(intr.fy), ppx=expand(intr.ppx),
        ppy=expand(intr.ppy), coeffs=intr.coeffs[..., None, :],
        model_ids=expand(intr.model_ids))
    u, v, in_front = project_planes(xyz[..., 0], xyz[..., 1], xyz[..., 2],
                                    per_point)
    return torch.stack([u, v], dim=-1), in_front


def map_color(pc: PointCloud, color: torch.Tensor, color_intr: Intrinsics,
              depth_to_color: torch.Tensor, impl: str = "auto") -> PointCloud:
    """Attach colour by texture-coordinate mapping with separate colour
    calibration (``rs2::pointcloud::map_to``).

    Per point: transform into the colour camera frame, project with the
    colour intrinsics, sample the colour image at the nearest pixel. Points
    that land outside the colour frame keep their geometry but get zero
    colour.

    Args:
      pc: deprojected cloud in the DEPTH camera frame ([..., N, 3]).
      color: [..., Hc, Wc, 3] uint8 colour image (its own resolution).
      color_intr: the colour stream's Intrinsics (batched like pc).
      depth_to_color: [..., 4, 4] depth→colour extrinsic transform.
      impl: 'auto' maps a CUDA cloud with the ``map_color_kernel`` (one
        launch for every camera, every distortion model) and a CPU cloud
        with the torch composition below; 'cuda' and 'torch' force one.
    """
    if use_kernel(impl, pc.xyz):
        return pc.replace(rgb=map_color_cuda(pc.xyz, pc.mask, color,
                                             color_intr, depth_to_color))
    hc, wc = color.shape[-3], color.shape[-2]
    xyz_c = se3_apply(depth_to_color.to(torch.float32), pc.xyz)
    uv, in_front = project(xyz_c, color_intr)
    ui = torch.round(uv[..., 0]).to(torch.int32)
    vi = torch.round(uv[..., 1]).to(torch.int32)
    in_fov = in_front & (ui >= 0) & (ui < wc) & (vi >= 0) & (vi < hc)
    ui = torch.clamp(ui, 0, wc - 1)
    vi = torch.clamp(vi, 0, hc - 1)
    flat = color.to(torch.float32).reshape(*color.shape[:-3], hc * wc, 3)
    idx = (vi * wc + ui).long()
    rgb = flat.gather(-2, idx[..., None].expand(*idx.shape, 3))
    rgb = torch.where((pc.mask & in_fov)[..., None], rgb, 0.0)
    return pc.replace(rgb=rgb)


def deproject_with_color_mapped(depth: torch.Tensor, color: torch.Tensor,
                                intr: Intrinsics, color_intr: Intrinsics,
                                depth_to_color: torch.Tensor,
                                depth_scale: float = 0.001,
                                z_min: float = 0.0,
                                z_max: float = float("inf")) -> PointCloud:
    """Deproject depth and texture-map colour from a non-aligned colour
    stream (see ``map_color``)."""
    pc = deproject(depth, intr, depth_scale, z_min, z_max)
    return map_color(pc, color, color_intr, depth_to_color)


def deproject_with_color(depth: torch.Tensor, color: torch.Tensor,
                         intr: Intrinsics, depth_scale: float = 0.001,
                         z_min: float = 0.0,
                         z_max: float = float("inf")) -> PointCloud:
    """Deproject depth and attach per-pixel RGB (depth-aligned colour).

    color: [..., H, W, 3] uint8. Masked points get zero colour.
    """
    pc = deproject(depth, intr, depth_scale, z_min, z_max)
    batch = depth.shape[:-2]
    rgb = color.to(torch.float32).reshape(*batch, -1, 3)
    rgb = torch.where(pc.mask[..., None], rgb, 0.0)
    return pc.replace(rgb=rgb)
