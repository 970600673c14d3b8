"""Sample-consensus plane segmentation on fixed-shape clouds.

Port of ``pointcloud_stitching_tpu/ops/sac.py`` (``pcl::SACSegmentation``
with ``SACMODEL_PLANE``, then ``pcl::ExtractIndices``). Every hypothesis is
drawn up front (an [M, 3] index sample), all of them are scored against
every point in [M, chunk] tiles, the first one with the most inliers wins,
and a fixed number of least-squares refits polish it (the inliers'
centroid and the smallest eigenvector of their 3x3 scatter; PCL's
``setOptimizeCoefficients(true)``).

The draws come from the caller's ``torch.Generator`` (the JAX package takes
a key), so ``segment_plane`` draws and ``_segment_plane_from_indices`` does
the rest; a parity test feeds the latter the JAX package's own indices.

Every product here is elementwise (the point-plane distance is
``n_x x + n_y y + n_z z + d``), and the hypotheses and the refit are
computed in float64 and rounded, so TF32 matmuls cannot move a point
across the threshold and the card's planes equal the CPU's. On CUDA a
call syncs once per refit (``eigh`` reads its status) and nowhere else.
"""
from __future__ import annotations

import torch

from ..utils.linalg import eigh
from ..utils.types import PointCloud, scalar
from .search import dot3


def _plane_dist(xyz: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """Signed distance n . p + d of points [..., 3] to planes [..., 4]
    (broadcast)."""
    return dot3(xyz, model[..., :3]) + model[..., 3]


def _plane_from_triples(p0, p1, p2):
    """Unit planes [M, 4] (n, d) through three points; zero when collinear
    (|n| <= 1e-9). Returns (models, ok). Built in float64 and rounded: a
    CUDA kernel contracts the cross product into fused multiply-adds where
    the CPU does not, and in float32 the devices' planes would differ in
    their last bits."""
    p0, p1, p2 = (p.to(torch.float64) for p in (p0, p1, p2))
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = norm[..., 0] > 1e-9
    n = torch.where(ok[..., None], n / torch.clamp(norm, min=1e-12), 0.0)
    d = -(n * p0).sum(dim=-1)
    return torch.cat([n, d[..., None]], dim=-1).to(torch.float32), ok


def _count_inliers(models, xyz, mask, threshold, chunk: int):
    """Inlier counts [M] int32 of each plane, evaluated in [M, chunk]
    tiles (the [M, N] distance matrix never exists whole)."""
    counts = torch.zeros(models.shape[0], dtype=torch.int32,
                         device=xyz.device)
    for i in range(0, xyz.shape[0], chunk):
        dist = _plane_dist(xyz[None, i:i + chunk], models[:, None, :]).abs()
        hit = (dist <= threshold) & mask[None, i:i + chunk]
        counts += hit.sum(dim=1, dtype=torch.int32)
    return counts


def _refit(model, xyz, mask, threshold):
    """One total-least-squares refit on the model's inliers; the normal
    keeps the incoming orientation."""
    w = ((_plane_dist(xyz, model).abs() <= threshold) & mask).to(
        torch.float64)
    x64 = xyz.to(torch.float64)
    tot = torch.clamp(w.sum(), min=3.0)
    c = (x64 * w[:, None]).sum(dim=0) / tot
    dxyz = (x64 - c) * w[:, None]
    cov = (dxyz[:, :, None] * dxyz[:, None, :]).sum(dim=0)
    # eigh and the offset in float64 too: the devices then agree to float32
    _, vecs = eigh(cov[None])
    nrm = vecs[0, :, 0]
    nrm = torch.where((nrm * model[:3].to(torch.float64)).sum() < 0, -nrm,
                      nrm)
    return torch.cat([nrm, -(nrm * c).sum()[None]]).to(torch.float32)


def _segment_plane_from_indices(pc: PointCloud, idx: torch.Tensor,
                                threshold, refine_iters: int = 2,
                                chunk: int = 16384):
    """``segment_plane`` given its hypotheses' point indices ``idx``
    [M, 3]: (model [4], inliers [N] bool, count int32)."""
    xyz, mask = pc.xyz, pc.mask
    thr = scalar(threshold, xyz)
    tri = xyz[idx.to(xyz.device)]                          # [M, 3, 3]
    models, ok = _plane_from_triples(tri[:, 0], tri[:, 1], tri[:, 2])
    counts = _count_inliers(models, xyz, mask, thr, chunk)
    counts = torch.where(ok, counts, 0)
    # first max wins; a 1-element index (a 0-d one would read it on the host)
    model = models[torch.argmax(counts)[None]][0]
    for _ in range(refine_iters):
        model = _refit(model, xyz, mask, thr)
    inliers = (_plane_dist(xyz, model).abs() <= thr) & mask
    count = inliers.sum(dtype=torch.int32)
    # a plane needs >= 3 supporting points; with fewer the refit's eigh
    # would make one up: return the zero model and no inliers instead
    good = count >= 3
    return (torch.where(good, model, 0.0), inliers & good,
            torch.where(good, count, 0))


def segment_plane(pc: PointCloud, threshold, generator: torch.Generator,
                  num_hypotheses: int = 1024, refine_iters: int = 2,
                  chunk: int = 16384):
    """Find the dominant plane: (model [4], inlier_mask [N], count).

    Args:
      pc: cloud [N, 3] + mask. A cloud that cannot support a plane (< 3
        inliers) gives the zero model and count 0.
      threshold: inlier point-to-plane distance (meters).
      generator: the ``torch.Generator`` the hypotheses are drawn from
        (deterministic given its state and the cloud); the draw runs on
        the generator's device.
      num_hypotheses: minimal-sample planes drawn and scored together;
        1024 finds a plane of >= 20% of the points with > 99.9%.
      refine_iters: least-squares refits of the winner.

    The model is (nx, ny, nz, d) with |n| = 1 and n . p + d = 0 on the
    plane (PCL's ModelCoefficients).
    """
    p = pc.mask.to(torch.float32)
    # an empty cloud draws uniformly (and then scores nothing): multinomial
    # refuses an all-zero distribution, and a host test would sync
    p = torch.where(p.sum() > 0, p, 1.0)
    idx = torch.multinomial(p.to(generator.device), 3 * num_hypotheses,
                            replacement=True, generator=generator)
    return _segment_plane_from_indices(
        pc, idx.view(num_hypotheses, 3), threshold,
        refine_iters=refine_iters, chunk=chunk)


def extract_plane(pc: PointCloud, model: torch.Tensor, threshold,
                  negative: bool = True) -> PointCloud:
    """pcl::ExtractIndices for a plane model, mask-only: ``negative=True``
    removes the plane's inliers, False keeps only them."""
    on_plane = _plane_dist(pc.xyz, model).abs() <= scalar(threshold, pc.xyz)
    return pc.replace(mask=pc.mask & (~on_plane if negative else on_plane))


def project_plane(pc: PointCloud, model: torch.Tensor) -> PointCloud:
    """Project every valid point onto a plane model (pcl::ProjectInliers):
    p' = p - (n . p + d) n with the model normalised first. Mask and row
    order are kept."""
    norm = torch.clamp(torch.linalg.vector_norm(model[:3]), min=1e-12)
    unit = torch.cat([model[:3] / norm, (model[3] / norm)[None]])
    dist = _plane_dist(pc.xyz, unit)
    xyz = pc.xyz - dist[..., None] * unit[:3]
    return pc.replace(xyz=torch.where(pc.mask[..., None], xyz, pc.xyz))
