"""Point-cloud filters.

Only ``crop_box`` of ``pointcloud_stitching_tpu/ops/filters.py`` is ported
so far: it is the one filter on the stitch step's path.
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
