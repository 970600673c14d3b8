"""Surface normals from organized depth grids.

Port of ``pointcloud_stitching_tpu/ops/normals.py``: ``grid_normals`` is the
cross product of the vertical and horizontal forward differences, in the
same ``cross(dv, du)`` order and with the same edge mask (the roll wraps at
the last row and column, so those pixels have no valid normal);
``decode_normals`` reads the 3x8-bit normals a ``with_normals`` pipeline
writes into the cloud's rgb channel.
"""
from __future__ import annotations

import torch


def grid_normals(xyz_grid: torch.Tensor, mask_grid: torch.Tensor,
                 flip_towards_origin: bool = True):
    """Per-pixel normals of an organized cloud.

    Args:
      xyz_grid: [..., H, W, 3] sensor-frame points (invalid slots zeroed).
      mask_grid: [..., H, W] validity.
    Returns:
      (normals [..., H, W, 3] unit vectors, valid [..., H, W]); a normal is
      valid when the pixel and both forward neighbours are valid. Normals
      face the sensor origin when flip_towards_origin is set.
    """
    right = torch.roll(xyz_grid, -1, dims=-2)   # u+1
    down = torch.roll(xyz_grid, -1, dims=-3)    # v+1
    m_right = torch.roll(mask_grid, -1, dims=-1)
    m_down = torch.roll(mask_grid, -1, dims=-2)

    du = right - xyz_grid
    dv = down - xyz_grid
    n = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    valid = mask_grid & m_right & m_down & (norm[..., 0] > 1e-12)
    h, w = mask_grid.shape[-2], mask_grid.shape[-1]
    dev = mask_grid.device
    edge = ((torch.arange(h, device=dev) < h - 1)[:, None]
            & (torch.arange(w, device=dev) < w - 1)[None, :])
    valid = valid & edge
    n = n / torch.clamp(norm, min=1e-12)
    if flip_towards_origin:
        # orient toward the sensor at the origin: n·p should be negative
        flip = (n * xyz_grid).sum(dim=-1, keepdim=True) > 0
        n = torch.where(flip, -n, n)
    n = torch.where(valid[..., None], n, 0.0)
    return n, valid


def decode_normals(cloud, min_norm: float = 0.3):
    """Unit world normals from a ``with_normals`` pipeline output.

    The stitcher encodes normals as q = (n + 1) * 127.5 in the rgb channel
    and the output voxel pass averages them. Decoding inverts the map and
    renormalises; a short average (|n| < min_norm: the voxel's members
    disagreed or carried no normal) decodes to zero with valid=False.

    Returns (normals [..., N, 3], valid [..., N]).
    """
    if cloud.rgb is None:
        raise ValueError("cloud has no encoded normals (rgb is None); "
                         "run the pipeline with cfg.with_normals=True")
    n = cloud.rgb * (1.0 / 127.5) - 1.0
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = cloud.mask & (norm[..., 0] >= min_norm)
    n = torch.where(ok[..., None], n / torch.clamp(norm, min=1e-12), 0.0)
    return n, ok
