"""Moving-least-squares smoothing, normals and curvature of unorganized
clouds.

Port of ``pointcloud_stitching_tpu/ops/mls.py`` (the role of PCL's
``MovingLeastSquares`` and ``NormalEstimation``). A local plane fit needs
only the kernel-weighted moments of each point's radius neighbourhood,

    sum(w), sum(w d), sum(w d d^T)      d = p - q,

and moments accumulate, so no neighbour list is built: one all-pairs sweep
(``ops/sweep.py``) adds every reference's weighted contribution per query.
The moments are centred on the query on purpose: moments about the origin
of a scene tens of metres out cancel catastrophically in float32 when the
covariance is formed, and displacements are radius-sized, so every square
keeps its full relative precision. A batched 3x3 ``eigh`` then gives each
point's plane (the eigenvector of the smallest eigenvalue).

``eigh`` and ``eigvalsh`` (``utils/linalg.py``) check their status on the
host: on CUDA these functions sync once per 16,384 points. Cost is exact
O(N^2): voxel-downsample first at registration scale.
"""
from __future__ import annotations

import torch

from ..utils.linalg import eigh, eigvalsh
from ..utils.types import PointCloud, scalar
from .search import sum_sq
from .sweep import blockwise_accumulate, outer_sum


def _radius_moments(xyz, mask, radius, sg, query_tile, ref_tile):
    """Kernel-weighted neighbourhood moments per point.

    Returns (sum_w [N], sum_w (p - q) [N, 3], sum_w (p - q)(p - q)^T
    [N, 3, 3], count [N] int32) over valid points p within ``radius`` of
    each query q (self included), Gaussian weights exp(-d2 / sg).
    """
    r2 = scalar(radius, xyz) ** 2
    sg = torch.clamp(scalar(sg, xyz), min=1e-12)
    rt = min(ref_tile, xyz.shape[0])

    def step(q, qv, qe, r, rv, re):
        d = q[:, None, :] - r[None, :, :]                    # [q, M, 3]
        d2 = sum_sq(d)                                       # [q, M]
        inside = (d2 <= r2) & rv[None, :]
        w = torch.where(inside, torch.exp(-d2 / sg), 0.0)
        # the JAX package's einsum("qr,qri,qrj->qij") as batched products
        # (w d)^T d: no [q, M, 3, 3] intermediate
        wd = w[..., None] * d
        swddt = outer_sum(wd, d, rt)
        return (w.sum(dim=1), -wd.sum(dim=1), swddt,
                inside.sum(dim=1, dtype=torch.int32))

    return blockwise_accumulate(xyz, mask, [], query_tile, ref_tile, step)


def _covariance(sw, swd, swddt):
    """(mean displacement [N, 3], covariance [N, 3, 3]) from centred
    moments: the shifted-moment form subtracts small like-sized values."""
    denom = torch.clamp(sw, min=1e-12)[:, None]
    md = swd / denom
    cov = swddt / denom[..., None] - md[:, :, None] * md[:, None, :]
    return md, cov


def _eye_eps(like: torch.Tensor) -> torch.Tensor:
    # guards eigh against the all-zero covariance of unsupported points
    return 1e-12 * torch.eye(3, dtype=torch.float32, device=like.device)


def _local_planes(xyz, sw, swd, swddt):
    """Per-point weighted centroid and plane normal."""
    md, cov = _covariance(sw, swd, swddt)
    _, vecs = eigh(cov + _eye_eps(cov))
    return xyz + md, vecs[..., 0]          # smallest-eigenvalue direction


def _supported(mask, cnt, min_neighbors):
    # the point itself is in its neighbourhood: "other" neighbours are
    # cnt - 1
    return mask & (cnt - 1 >= min_neighbors)


def _gauss(radius, sqr_gauss, like):
    return scalar(radius, like) ** 2 if sqr_gauss is None else sqr_gauss


def estimate_normals(pc: PointCloud, radius, viewpoint=(0.0, 0.0, 0.0),
                     sqr_gauss=None, min_neighbors=3,
                     query_tile: int = 512, ref_tile: int = 1024):
    """Surface normals for unorganized clouds (pcl::NormalEstimation role).

    Each point's normal is the smallest eigenvector of its radius
    neighbourhood's weighted covariance, oriented toward ``viewpoint``.

    Returns (normals [N, 3] unit vectors, valid [N]: False where fewer
    than ``min_neighbors`` other points support the fit; normals are zero
    there).
    """
    xyz, mask = pc.xyz, pc.mask
    sw, swd, swddt, cnt = _radius_moments(
        xyz, mask, radius, _gauss(radius, sqr_gauss, xyz), query_tile,
        ref_tile)
    _, nrm = _local_planes(xyz, sw, swd, swddt)
    vp = torch.stack([scalar(v, xyz) for v in viewpoint])
    flip = (nrm * (vp[None, :] - xyz)).sum(dim=-1) < 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    ok = _supported(mask, cnt, min_neighbors)
    return torch.where(ok[:, None], nrm, 0.0), ok


def estimate_curvature(pc: PointCloud, radius, sqr_gauss=None,
                       min_neighbors=3, query_tile: int = 512,
                       ref_tile: int = 1024):
    """Surface variation per point, PCL's NormalEstimation "curvature":
    lambda_0 / (lambda_0 + lambda_1 + lambda_2) of the (kernel-weighted)
    radius-neighbourhood covariance; 0 on planes, toward 1/3 at corners.

    Returns (curvature [N] float32, valid [N]); zeros where fewer than
    ``min_neighbors`` other points support the estimate.
    """
    xyz, mask = pc.xyz, pc.mask
    sw, swd, swddt, cnt = _radius_moments(
        xyz, mask, radius, _gauss(radius, sqr_gauss, xyz), query_tile,
        ref_tile)
    _, cov = _covariance(sw, swd, swddt)
    vals = torch.clamp(eigvalsh(cov + _eye_eps(cov)), min=0.0)
    curv = vals[..., 0] / torch.clamp(vals.sum(dim=-1), min=1e-12)
    ok = _supported(mask, cnt, min_neighbors)
    return torch.where(ok, curv, 0.0), ok


def mls_smooth(pc: PointCloud, radius, sqr_gauss=None, min_neighbors=3,
               query_tile: int = 512, ref_tile: int = 1024) -> PointCloud:
    """Project each point onto its kernel-weighted local plane (PCL's
    plane-projection MLS).

    ``pc`` is [N, 3] or camera-batched [B, N, 3]; mask and rgb pass through.
    Points with fewer than ``min_neighbors`` other neighbours keep their
    coordinates. ``sqr_gauss`` defaults to radius^2.
    """
    if pc.xyz.dim() == 3:
        sm = torch.stack([
            mls_smooth(PointCloud(xyz=x, mask=m), radius, sqr_gauss,
                       min_neighbors, query_tile, ref_tile).xyz
            for x, m in zip(pc.xyz, pc.mask)])
        return pc.replace(xyz=sm)
    xyz, mask = pc.xyz, pc.mask
    sw, swd, swddt, cnt = _radius_moments(
        xyz, mask, radius, _gauss(radius, sqr_gauss, xyz), query_tile,
        ref_tile)
    mu, nrm = _local_planes(xyz, sw, swd, swddt)
    off = ((xyz - mu) * nrm).sum(dim=-1, keepdim=True)
    projected = xyz - off * nrm
    ok = _supported(mask, cnt, min_neighbors)
    return pc.replace(xyz=torch.where(ok[:, None], projected, xyz))
