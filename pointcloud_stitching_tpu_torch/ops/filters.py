"""Point-cloud filters: passthrough, crop box, frustum, radius and
statistical outlier removal, and the bilateral depth filter.

Port of ``pointcloud_stitching_tpu/ops/filters.py`` (the PCL staples
``PassThrough``, ``CropBox``, ``FrustumCulling``, ``RadiusOutlierRemoval``,
``StatisticalOutlierRemoval`` and ``FastBilateralFilter``). The point
filters never change shapes: they only clear mask bits.

The neighbour filters are exact all-pairs sweeps (``ops/sweep.py``,
``ops/search.py``) with squared distances from direct differences summed
x, y, z in that order, as the JAX package's tiles sum them. A point never
counts itself: the sweeps exclude it by index, not by d2 = 0, so exact
duplicates do count as each other's neighbours.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud, scalar
from .search import knn_search, sum_sq
from .sweep import blockwise_accumulate


def passthrough(pc: PointCloud, axis: int, lo, hi,
                invert: bool = False) -> PointCloud:
    """Keep points with lo <= p[axis] <= hi (pcl::PassThrough: limits
    inclusive; ``invert`` = setNegative). Mask-only."""
    v = pc.xyz[..., axis]
    keep = (v >= scalar(lo, v)) & (v <= scalar(hi, v))
    if invert:
        keep = ~keep
    return pc.replace(mask=pc.mask & keep)


def crop_box(pc: PointCloud, lo, hi, invert: bool = False) -> PointCloud:
    """Keep points inside the axis-aligned box [lo, hi] (pcl::CropBox
    without the box transform). Mask-only."""
    lo = torch.stack([scalar(v, pc.xyz) for v in lo])
    hi = torch.stack([scalar(v, pc.xyz) for v in hi])
    keep = ((pc.xyz >= lo) & (pc.xyz <= hi)).all(dim=-1)
    if invert:
        keep = ~keep
    return pc.replace(mask=pc.mask & keep)


def frustum_cull(pc: PointCloud, intr, extrinsic=None, z_min=0.0,
                 z_max=float("inf"), invert: bool = False) -> PointCloud:
    """Keep points a camera sees (pcl::FrustumCulling role).

    Points move into the camera frame (the inverse of the camera-to-world
    ``extrinsic``, a .cal matrix; None = the cloud is in the camera frame
    already), project through the intrinsics with their distortion
    (``ops.deproject.project``), and survive when the pixel lands inside
    the image and z lies in [z_min, z_max]. The image bounds are pixel
    areas (centres 0..w-1, each half a pixel wide), so a point deprojected
    from a border pixel projects back inside. ``invert`` keeps the
    complement. Mask-only.
    """
    from .deproject import project
    from .se3 import se3_apply, se3_inverse
    xyz = pc.xyz
    if extrinsic is not None:
        ext = torch.as_tensor(extrinsic, dtype=torch.float32,
                              device=xyz.device)
        xyz = se3_apply(se3_inverse(ext), xyz)
    uv, in_front = project(xyz, intr)
    z = xyz[..., 2]
    inside = (in_front & (z >= scalar(z_min, z)) & (z <= scalar(z_max, z))
              & (uv[..., 0] >= -0.5) & (uv[..., 0] <= intr.width - 0.5)
              & (uv[..., 1] >= -0.5) & (uv[..., 1] <= intr.height - 0.5))
    if invert:
        inside = ~inside
    return pc.replace(mask=pc.mask & inside)


def count_neighbors(pc: PointCloud, radius, query_tile: int = 1024,
                    ref_tile: int = 1024) -> torch.Tensor:
    """Per-point count of OTHER valid points within ``radius`` (inclusive),
    int32 [N] (or [B, N] for a batch of clouds, each on its own).

    An exact sweep of every query against every reference; a valid point's
    own match (d2 = 0) is subtracted, so exact duplicates count each other.
    Invalid points count 0 and are never counted.
    """
    if pc.xyz.dim() == 3:
        return torch.stack([
            count_neighbors(PointCloud(xyz=x, mask=m), radius,
                            query_tile=query_tile, ref_tile=ref_tile)
            for x, m in zip(pc.xyz, pc.mask)])
    r2 = scalar(radius, pc.xyz) ** 2

    def step(q, qv, qe, r, rv, re):
        d2 = sum_sq(q[:, None, :] - r[None, :, :])
        return ((d2 <= r2) & rv[None, :]).sum(dim=1, dtype=torch.int32)

    counts = blockwise_accumulate(pc.xyz, pc.mask, [], query_tile, ref_tile,
                                  step)
    return torch.where(pc.mask, counts - 1, 0)


def radius_outlier_removal(pc: PointCloud, radius, min_neighbors,
                           query_tile: int = 1024,
                           ref_tile: int = 1024) -> PointCloud:
    """Drop points with fewer than ``min_neighbors`` OTHER points within
    ``radius`` (pcl::RadiusOutlierRemoval, the point itself excluded).
    Mask-only."""
    counts = count_neighbors(pc, radius, query_tile=query_tile,
                             ref_tile=ref_tile)
    return pc.replace(mask=pc.mask & (counts >= min_neighbors))


def knn_mean_distance(pc: PointCloud, k: int, query_tile: int = 512,
                      ref_tile: int = 1024) -> torch.Tensor:
    """Per-point mean distance to its k nearest OTHER valid points, float32
    [N] (or [B, N]).

    The k nearest come from ``knn_search`` with the point itself excluded
    by index. A point with fewer than k valid co-points averages over the
    ones it has (the +inf slots are dropped from the mean); invalid points
    return 0.
    """
    if pc.xyz.dim() == 3:
        return torch.stack([
            knn_mean_distance(PointCloud(xyz=x, mask=m), k,
                              query_tile=query_tile, ref_tile=ref_tile)
            for x, m in zip(pc.xyz, pc.mask)])
    best, _ = knn_search(pc, pc, k, exclude_self=True,
                         query_tile=query_tile, ref_tile=ref_tile)
    have = torch.isfinite(best)
    dist = torch.where(have, torch.sqrt(torch.clamp(best, min=0.0)), 0.0)
    cnt = torch.clamp(have.sum(dim=1, dtype=torch.int32), min=1)
    md = dist.sum(dim=1) / cnt.to(torch.float32)
    return torch.where(pc.mask, md, 0.0)


def statistical_outlier_removal(pc: PointCloud, k: int = 50,
                                std_ratio: float = 1.0,
                                query_tile: int = 512,
                                ref_tile: int = 1024) -> PointCloud:
    """pcl::StatisticalOutlierRemoval: drop points whose mean distance to
    their k nearest neighbours exceeds the mean + ``std_ratio`` standard
    deviations of that statistic over the cloud's valid points (sample
    variance, n - 1 divisor, as PCL computes it). Mask-only."""
    md = knn_mean_distance(pc, k, query_tile=query_tile, ref_tile=ref_tile)
    m = pc.mask
    cnt = torch.clamp(m.sum(dim=-1, keepdim=True, dtype=torch.int32), min=1)
    mean = torch.where(m, md, 0.0).sum(dim=-1, keepdim=True) / cnt
    var = (torch.where(m, (md - mean) ** 2, 0.0).sum(dim=-1, keepdim=True)
           / torch.clamp(cnt - 1, min=1))
    thresh = mean + scalar(std_ratio, md) * torch.sqrt(var)
    return pc.replace(mask=m & (md <= thresh))


def bilateral_depth(depth: torch.Tensor, sigma_spatial=3.0, sigma_range=0.03,
                    radius: int = 6, depth_scale: float = 0.001
                    ) -> torch.Tensor:
    """Edge-preserving smoothing of an organized depth image (the role of
    ``pcl::FastBilateralFilter``), in the direct form: a (2·radius+1)²
    stack of shifted reads of the image, each weighted by a spatial and a
    range Gaussian.

    Args:
      depth: [..., H, W] uint16 raw units or float (any scale).
      sigma_spatial: Gaussian width in pixels.
      sigma_range: Gaussian width in meters: depth steps of a few
        sigma_range never blend (the edge-preserving part).
      radius: window radius in pixels (make it >= ~2·sigma_spatial).
      depth_scale: meters per raw unit (converts sigma_range only; the
        output stays in the input's raw units).

    Returns [..., H, W] float32 filtered depth in the input's raw units, 0
    where the input pixel was invalid (depth 0).
    """
    z = depth.to(torch.float32)
    valid = z > 0
    inv2s = 0.5 / scalar(sigma_spatial, z) ** 2
    # range sigma in raw units, so the image is never rescaled
    sr = scalar(sigma_range, z) / scalar(depth_scale, z)
    inv2r = 0.5 / sr ** 2

    r = radius
    h, w = z.shape[-2], z.shape[-1]
    zp = torch.nn.functional.pad(z, (r, r, r, r))
    vp = torch.nn.functional.pad(valid, (r, r, r, r))
    num = torch.zeros_like(z)
    den = torch.zeros_like(z)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            zs = zp[..., r + di:r + di + h, r + dj:r + dj + w]
            vs = vp[..., r + di:r + di + h, r + dj:r + dj + w]
            ws = torch.exp(-(di * di + dj * dj) * inv2s
                           - (zs - z) ** 2 * inv2r)
            ws = torch.where(vs, ws, 0.0)
            num = num + ws * zs
            den = den + ws
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(valid, out, 0.0)
