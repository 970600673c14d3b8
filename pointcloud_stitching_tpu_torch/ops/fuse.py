"""Multi-cloud fusion (concatenation) on padded buffers.

Port of ``fuse``, ``fuse_batched`` and ``compact`` from
``pointcloud_stitching_tpu/ops/fuse.py``: with fixed-capacity clouds,
fusion is a reshape or a concatenation and the masks do the bookkeeping.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud


def fuse(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate clouds along the point axis."""
    xyz = torch.cat([c.xyz for c in clouds], dim=-2)
    mask = torch.cat([c.mask for c in clouds], dim=-1)
    rgbs = [c.rgb for c in clouds]
    rgb = None
    if all(r is not None for r in rgbs):
        rgb = torch.cat(rgbs, dim=-2)
    return PointCloud(xyz=xyz, mask=mask, rgb=rgb)


def fuse_batched(pc: PointCloud) -> PointCloud:
    """Flatten a camera-batched cloud [..., ncam, N, 3] → [..., ncam*N, 3]."""
    *lead, ncam, n, _ = pc.xyz.shape
    xyz = pc.xyz.reshape(*lead, ncam * n, 3)
    mask = pc.mask.reshape(*lead, ncam * n)
    rgb = pc.rgb.reshape(*lead, ncam * n, 3) if pc.rgb is not None else None
    return PointCloud(xyz=xyz, mask=mask, rgb=rgb)


def compact(pc: PointCloud) -> PointCloud:
    """Sort valid points to the front (stable). Shape-preserving.

    Useful before slicing a fused cloud down to a smaller capacity, and for
    host-side export where the valid prefix is what gets written."""
    key = (~pc.mask).to(torch.int32)
    _, perm = torch.sort(key, dim=-1, stable=True)
    idx3 = perm[..., None].expand(*perm.shape, 3)
    rgb = None if pc.rgb is None else pc.rgb.gather(-2, idx3)
    return PointCloud(xyz=pc.xyz.gather(-2, idx3),
                      mask=pc.mask.gather(-1, perm), rgb=rgb)
