"""Triangle meshing of organized clouds.

Port of ``pointcloud_stitching_tpu/ops/mesh.py`` (the role of
``pcl::OrganizedFastMesh``): a depth frame is an organized grid, so every
2x2 pixel quad gives up to two triangles and the mesh is one elementwise
validity test over the grid:

    v ── v+1        triangle A: (v, v+w, v+1)
    │  ╱  │         triangle B: (v+1, v+w, v+w+1)
    v+w ─ v+w+1

A triangle survives when its three vertices are valid and no edge is
longer than ``max_edge`` (the depth-discontinuity cut). The output has a
fixed shape: 2(H-1)(W-1) triangle slots and a validity mask.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.types import scalar


def organized_mesh(xyz_grid: torch.Tensor, mask_grid: torch.Tensor,
                   max_edge=0.05):
    """Mesh an organized cloud. Returns (triangles [M, 3] int32 indices into
    the flattened [H*W] grid, valid [M] bool), M = 2(H-1)(W-1).

    Args:
      xyz_grid: [H, W, 3] sensor- or world-frame points.
      mask_grid: [H, W] validity.
      max_edge: longest triangle edge in meters (Python float or 0-d
        tensor); longer edges span depth discontinuities and are cut.
    """
    h, w = mask_grid.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=mask_grid.device).reshape(h, w)
    v00 = idx[:-1, :-1].reshape(-1)
    v01 = idx[:-1, 1:].reshape(-1)
    v10 = idx[1:, :-1].reshape(-1)
    v11 = idx[1:, 1:].reshape(-1)
    tri = torch.cat([torch.stack([v00, v10, v01], dim=-1),   # upper-left
                     torch.stack([v01, v10, v11], dim=-1)])  # lower-right

    ti = tri.long()
    p = xyz_grid.reshape(-1, 3)[ti]                          # [M, 3, 3]
    ok = mask_grid.reshape(-1)[ti].all(dim=-1)
    e = p - torch.roll(p, 1, dims=1)                         # the 3 edges
    elen2 = (e * e).sum(dim=-1)                              # [M, 3]
    me2 = scalar(max_edge, xyz_grid) ** 2
    return tri, ok & (elen2 <= me2).all(dim=-1)


def mesh_cloud_arrays(xyz_grid, mask_grid, max_edge=0.05):
    """(vertices [H*W, 3] np, faces [K, 3] np) with the invalid triangles
    removed; vertices keep grid order so faces index them directly."""
    tri, ok = organized_mesh(xyz_grid, mask_grid, max_edge)
    return (xyz_grid.reshape(-1, 3).detach().cpu().numpy(),
            tri[ok].cpu().numpy().astype(np.int32))
