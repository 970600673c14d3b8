"""Point-cloud filters.

Two filters of ``pointcloud_stitching_tpu/ops/filters.py`` are ported so
far: ``crop_box``, the one filter on the stitch step's path, and
``bilateral_depth``, the mesh CLI's depth smoothing.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud, scalar


def crop_box(pc: PointCloud, lo, hi, invert: bool = False) -> PointCloud:
    """Keep points inside the axis-aligned box [lo, hi] (pcl::CropBox
    without the box transform). Mask-only."""
    lo = torch.stack([scalar(v, pc.xyz) for v in lo])
    hi = torch.stack([scalar(v, pc.xyz) for v in hi])
    keep = ((pc.xyz >= lo) & (pc.xyz <= hi)).all(dim=-1)
    if invert:
        keep = ~keep
    return pc.replace(mask=pc.mask & keep)


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
