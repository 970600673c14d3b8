"""Intrinsic Shape Signatures keypoints on fixed-shape clouds.

Port of ``pointcloud_stitching_tpu/ops/keypoints.py`` (the role of
``pcl::ISSKeypoint3D``, Zhong, ICCV-W 2009): keep the points whose
neighbourhood has three well-separated scatter eigenvalues, thinned to
local saliency maxima. Three all-pairs sweeps (``ops/sweep.py``):

  1. neighbour counts within ``salient_radius`` -> density weights
     w_i = 1 / count_i;
  2. weighted scatter matrices about the query point (no mean
     subtraction), then a batched ``eigvalsh`` (on CUDA one host sync per
     16,384 points, its status check): l1 >= l2 >= l3; eligible where
     l2/l1 < gamma_21 and l3/l2 < gamma_32; saliency = l3;
  3. non-maximum suppression: a point survives iff no in-radius neighbour
     is strictly more salient.

Returns a mask (feed ``pc.replace(mask=pc.mask & kp)`` to fpfh/match).
"""
from __future__ import annotations

import torch

from ..utils.linalg import eigvalsh
from ..utils.types import PointCloud, scalar
from .search import sum_sq
from .sweep import blockwise_accumulate, outer_sum


def iss_keypoints(pc: PointCloud, salient_radius, non_max_radius=None,
                  gamma_21=0.975, gamma_32=0.975, min_neighbors=5,
                  query_tile: int = 256, ref_tile: int = 512):
    """ISS keypoints (pcl::ISSKeypoint3D role).

    Args:
      pc: cloud [N, 3] + mask.
      salient_radius: scatter-matrix neighbourhood (metres; PCL guidance
        ~6x the cloud resolution).
      non_max_radius: suppression radius (default salient_radius).
      gamma_21, gamma_32: eigenvalue-ratio thresholds (PCL defaults 0.975).
      min_neighbors: eligibility floor on OTHER in-radius points.

    Returns (keypoints [N] bool, saliency [N] float32 = smallest scatter
    eigenvalue, 0 where ineligible).
    """
    xyz, mask = pc.xyz, pc.mask
    r2 = scalar(salient_radius, xyz) ** 2
    nm2 = r2 if non_max_radius is None else \
        scalar(non_max_radius, xyz) ** 2
    rt = min(ref_tile, xyz.shape[0])

    def count_step(q, qv, qe, r, rv, re):
        inside = ((sum_sq(q[:, None, :] - r[None, :, :]) <= r2)
                  & qv[:, None] & rv[None, :])
        return inside.sum(dim=1).to(torch.float32)

    cnt = blockwise_accumulate(xyz, mask, [], query_tile, ref_tile,
                               count_step)                  # incl. self
    wgt = 1.0 / torch.clamp(cnt, min=1.0)

    def scatter_step(q, qv, qe, r, rv, re):
        d = r[None, :, :] - q[:, None, :]                   # [q, M, 3]
        d2 = sum_sq(d)
        inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]
        w = torch.where(inside, re[0][None, :], 0.0)
        # einsum("qr,qri,qrj->qij") as batched products (w d)^T d
        scat = outer_sum(w[..., None] * d, d, rt)
        return scat, w.sum(dim=1), inside.sum(dim=1).to(torch.float32)

    scat, wsum, k = blockwise_accumulate(xyz, mask, [wgt], query_tile,
                                         ref_tile, scatter_step)
    scat = scat / torch.clamp(wsum, min=1e-12)[:, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=xyz.device)
    vals = torch.clamp(eigvalsh(scat + 1e-12 * eye), min=0.0)
    l3, l2, l1 = vals[:, 0], vals[:, 1], vals[:, 2]        # ascending

    eligible = (mask & (k >= min_neighbors)
                & (l2 < scalar(gamma_21, l1) * l1)
                & (l3 < scalar(gamma_32, l2) * l2) & (l3 > 0))
    saliency = torch.where(eligible, l3, 0.0)

    def nms_step(q, qv, qe, r, rv, re):
        inside = ((sum_sq(q[:, None, :] - r[None, :, :]) <= nm2)
                  & qv[:, None] & rv[None, :])
        beaten = inside & (re[0][None, :] > qe[0][:, None])
        return beaten.sum(dim=1, dtype=torch.int32)

    n_beaten = blockwise_accumulate(xyz, eligible, [saliency], query_tile,
                                    ref_tile, nms_step)
    return eligible & (n_beaten == 0), saliency
