"""Viewpoint Feature Histogram: one global descriptor per cloud or object.

Port of ``pointcloud_stitching_tpu/ops/vfh.py`` (the role of
``pcl::VFHEstimation``, Rusu et al., IROS 2010). Layout (the contract of
the JAX package, fixed by its numpy oracle):

  [0:45)    alpha of every (centroid -> point) pair
  [45:90)   phi
  [90:135)  theta
  [135:180) point distance from the centroid, normalised by the largest
  [180:308) cos of the angle between each normal and the centroid's
            viewpoint direction, 128 bins

Every pair uses ``ops.fpfh.pair_angles``; each block sums to 100. One pass
over the cloud, O(N); the histograms add their 0/1 weights by bin index.
"""
from __future__ import annotations

import math

import torch

from ..utils.types import PointCloud, scalar
from .fpfh import pair_angles, to_bin
from .search import sum_sq

VFH_ANGLE_BINS = 45
VFH_VP_BINS = 128
VFH_DIM = 4 * VFH_ANGLE_BINS + VFH_VP_BINS     # 308


def _hist(x, lo, hi, wgt, bins):
    # the JAX package's bins / (hi - lo): a float64 ratio rounded once
    scale = scalar(bins / (hi - lo), x)
    h = torch.zeros((bins,), dtype=torch.float32, device=x.device)
    h = h.scatter_add(0, to_bin(x, lo, scale, bins).long(), wgt)
    s = h.sum()
    return torch.where(s > 0, 100.0 * h / torch.clamp(s, min=1e-12), 0.0)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def vfh(pc: PointCloud, normals: torch.Tensor,
        normals_valid: torch.Tensor | None = None,
        viewpoint=(0.0, 0.0, 0.0)):
    """308-dim global descriptor of a cloud (pcl::VFHEstimation role).

    Args:
      pc: cloud [N, 3] + mask, typically one extracted cluster.
      normals: [N, 3] unit normals; ``normals_valid`` optional validity.
      viewpoint: sensor position; the viewpoint component measures normals
        against the direction from the centroid to it.

    Returns (desc [308] float32, each block summing to 100 when any point
    contributes, and valid: False when fewer than 2 valid points).
    """
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    xyz = pc.xyz
    w = valid.to(torch.float32)
    tot = w.sum()
    c = (xyz * w[:, None]).sum(dim=0) / torch.clamp(tot, min=1.0)
    nc = _unit((normals * w[:, None]).sum(dim=0))

    dp = xyz - c                                          # centroid -> point
    dd = sum_sq(dp)
    d = torch.sqrt(torch.clamp(dd, min=1e-24))
    alpha, phi, theta, ok = pair_angles(nc, normals, dp, d)
    wgt = (valid & ok & ~(dd <= 1e-12)).to(torch.float32)

    dmax = torch.where(valid, d, 0.0).max()
    dn = d / torch.clamp(dmax, min=1e-12)
    vp = _unit(torch.stack([scalar(v, xyz) for v in viewpoint]) - c)
    cos_vp = (normals * vp).sum(dim=-1)

    desc = torch.cat([
        _hist(alpha, -1.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(phi, -1.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(theta, -math.pi, math.pi, wgt, VFH_ANGLE_BINS),
        _hist(dn, 0.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(cos_vp, -1.0, 1.0, w, VFH_VP_BINS),
    ])
    ok_out = tot >= 2.0
    return torch.where(ok_out, desc, 0.0), ok_out
