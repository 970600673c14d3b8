"""Euclidean cluster extraction, region growing and per-cluster boxes.

Port of ``pointcloud_stitching_tpu/ops/cluster.py`` (the roles of
``pcl::EuclideanClusterExtraction``, ``pcl::RegionGrowing``,
``getMinMax3D``/``compute3DCentroid`` and
``pcl::MomentOfInertiaEstimation::getOBB``).

``euclidean_clusters`` quantises the cloud at leaf = ``tolerance``, finds
the unique voxels with one stable sort of an int32 linearised key, links
each voxel to its 26 neighbours with 13 symmetric ``searchsorted`` probes,
and labels connected components by min-label propagation with pointer
jumping. ``euclidean_clusters_exact`` and ``region_growing`` propagate over
the exact radius graph instead, one all-pairs sweep (``ops/sweep.py``) per
round. Clusters then rank by size, largest first.

The JAX package runs the propagation in a ``lax.while_loop``; here it is a
host loop that reads its "changed" flag (one host sync) every
``CHECK_EVERY`` rounds. Rounds past the fixpoint change nothing and the
loop never runs past the ``rounds`` cap, so the labels are the JAX
package's. Ranking breaks size ties by the lower root index, as
``lax.top_k`` does, through one int64 key ``(size << 32) | (n - 1 - root)``
(``torch.topk`` promises no order among equal values). Float segment sums
run in float64 (CUDA's ``index_add_`` order is not fixed) and are rounded
to float32 after.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.linalg import eigh
from ..utils.types import PointCloud, scalar
from .search import dot3, sum_sq
from .sweep import blockwise_accumulate
from .voxel import _SENTINEL, voxel_indices

# propagation rounds between two reads of the "changed" flag
CHECK_EVERY = 4


def _propagate_to_fixpoint(step, labels: torch.Tensor, rounds: int):
    """Apply ``step`` until a round changes nothing or ``rounds`` rounds
    have run (the JAX package's while_loop), reading the flag (one host
    sync) every CHECK_EVERY rounds."""
    done = 0
    while done < rounds:
        for _ in range(min(CHECK_EVERY, rounds - done)):
            prev, labels = labels, step(labels)
            done += 1
        if not bool((labels != prev).any()):
            break
    return labels


def _segment_sum_i32(vals: torch.Tensor, seg: torch.Tensor, n: int):
    return torch.zeros(n, dtype=torch.int32, device=vals.device).index_add_(
        0, seg.long(), vals.to(torch.int32))


def _segment_sum64(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """Float segment sums over [N, c] rows in float64."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, seg.long(), vals.to(torch.float64))


def _segment_sum_f(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """Float segment sums, added in float64, rounded to float32."""
    return _segment_sum64(vals, seg, n).to(torch.float32)


def _segment_extreme(vals: torch.Tensor, seg: torch.Tensor, n: int,
                     reduce: str, fill: float):
    """Per-segment amin/amax of [N, c] rows, ``fill`` where empty."""
    out = torch.full((n,) + vals.shape[1:], fill, dtype=vals.dtype,
                     device=vals.device)
    idx = seg.long()[:, None].expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, reduce, include_self=True)


def _rank_from_sizes(sizes_at_root, lab_pt, active, min_size,
                     max_clusters: int):
    """Root-slot sizes -> size-filtered, largest-first labels 0..k-1 (-1
    elsewhere), the number kept and their sizes [k]. Equal sizes rank the
    lower root first."""
    n = sizes_at_root.shape[0]
    k = max_clusters
    dev = sizes_at_root.device
    rev = n - 1 - torch.arange(n, dtype=torch.int64, device=dev)
    key = (sizes_at_root.to(torch.int64) << 32) | rev
    top = torch.topk(key, k, sorted=True).values
    top_sizes = (top >> 32).to(torch.int32)
    top_roots = n - 1 - (top & 0xFFFFFFFF)
    if torch.is_tensor(min_size):
        floor = torch.clamp(min_size.to(device=dev, dtype=torch.int32), min=1)
    else:   # filled in on the device: a host copy would sync
        floor = torch.full((), max(int(min_size), 1), dtype=torch.int32,
                           device=dev)
    keep = top_sizes >= floor
    num = keep.sum(dtype=torch.int32)
    rank = torch.where(keep, torch.arange(k, dtype=torch.int32, device=dev),
                       -1)
    rank_of_root = torch.full((n,), -1, dtype=torch.int32,
                              device=dev).scatter_(0, top_roots, rank)
    out_labels = torch.where(active, rank_of_root[lab_pt.long()], -1)
    return out_labels, num, torch.where(keep, top_sizes, 0)


def euclidean_clusters(pc: PointCloud, tolerance, min_size: int = 1,
                       max_clusters: int = 16, rounds: int | None = None):
    """Cluster a cloud by Euclidean proximity (voxel connectivity).

    Points within ``tolerance`` always connect; points in touching voxels
    at up to 2·sqrt(3)·tolerance may connect too (the price of the
    data-parallel form; ``euclidean_clusters_exact`` keeps PCL's exact
    contract).

    Returns (labels [N] int32: cluster id 0..max_clusters-1 largest first,
    -1 for invalid and small-cluster points; num_clusters int32, the
    clusters of at least ``min_size`` points, capped at max_clusters;
    sizes [max_clusters] int32). ``rounds`` caps the propagation (default
    64).

    The int32 linearised key needs nx·ny·nz < 2^31 cells at leaf =
    ``tolerance``; past it keys would alias and weld distant points, so
    the call fails safe instead: every label -1, num_clusters 0.
    """
    xyz, mask = pc.xyz, pc.mask
    n = xyz.shape[0]
    dev = xyz.device
    ijk = voxel_indices(xyz, mask, tolerance)
    valid = ijk[:, 0] != _SENTINEL
    ext = torch.where(valid[:, None], ijk, -1).amax(dim=0) + 1
    ny = torch.clamp(ext[1], min=1)
    nz = torch.clamp(ext[2], min=1)
    cells_ok = ((ext.to(torch.float32).prod() < float(2 ** 31))
                & (ext >= 0).all())
    valid = valid & cells_ok
    key = torch.where(valid, (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2],
                      _SENTINEL)

    # unique voxels by one stable sort; each point's voxel slot
    order = torch.argsort(key, stable=True)
    skey = key[order]
    svalid = skey != _SENTINEL
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    flags = (skey != prev) & svalid
    vox_sorted = torch.cumsum(flags, dim=0, dtype=torch.int32) - 1
    vox_sorted = torch.where(svalid, vox_sorted, n - 1)
    vox_of_point = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(
        0, order, vox_sorted)
    # sorted unique keys in slots 0..V-1, the sentinel after them
    ukeys = torch.full((n,), _SENTINEL, dtype=torch.int32,
                       device=dev).scatter_reduce_(
        0, vox_sorted.long(), torch.where(svalid, skey, _SENTINEL), "amin",
        include_self=True)
    uvalid = ukeys != _SENTINEL

    # 13 symmetric offsets probe all 26 neighbours
    uz = torch.where(uvalid, ukeys, 0)
    uiz, ut = uz % nz, uz // nz
    uiy, uix = ut % ny, ut // ny
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
    nb_idx, nb_ok = [], []
    for dx, dy, dz in offs:
        nix, niy, niz = uix + dx, uiy + dy, uiz + dz
        inside = ((nix >= 0) & (nix < ext[0]) & (niy >= 0) & (niy < ny)
                  & (niz >= 0) & (niz < nz) & uvalid)
        nkey = (nix * ny + niy) * nz + niz
        j = torch.clamp(torch.searchsorted(ukeys, nkey), max=n - 1)
        nb_idx.append(j)
        nb_ok.append(inside & (ukeys[j] == nkey))
    nb_idx = torch.stack(nb_idx)                 # [13, N] int64
    nb_ok = torch.stack(nb_ok)
    push_idx = torch.where(nb_ok, nb_idx, n - 1).reshape(-1)

    def propagate(l):
        nb = torch.where(nb_ok, l[nb_idx], n - 1)
        pulled = torch.minimum(l, nb.amin(dim=0))       # pull from neighbours
        # push the other way (edges are symmetric): a scatter-min
        l2 = pulled.scatter_reduce(
            0, push_idx, torch.where(nb_ok, pulled[None, :], n - 1).reshape(
                -1), "amin", include_self=True)
        l2 = l2[l2.long()]                               # pointer jumping
        return l2[l2.long()]

    labels0 = torch.where(uvalid, torch.arange(n, dtype=torch.int32,
                                               device=dev), n - 1)
    labels = _propagate_to_fixpoint(propagate, propagate(labels0),
                                    64 if rounds is None else rounds)

    # per-point root label -> cluster sizes in points at each root slot
    active = mask & valid
    lab_pt = torch.where(active, labels[vox_of_point.long()], n - 1)
    sizes_at_root = _segment_sum_i32(active, lab_pt, n)
    # roots only: the dump slot n-1 counts only if it is a real root
    is_root = (labels == torch.arange(n, dtype=torch.int32, device=dev)) \
        & uvalid
    sizes_at_root = torch.where(is_root, sizes_at_root, 0)
    return _rank_from_sizes(sizes_at_root, lab_pt, active, min_size,
                            max_clusters)


def _propagate_exact(xyz, mask, r2, cos_thr, normals, rounds: int,
                     query_tile: int, ref_tile: int) -> torch.Tensor:
    """Min-label propagation with pointer jumping over the exact graph:
    edge (i, j) iff |p_i - p_j|^2 <= r2 (and, with ``normals``, |n_i . n_j|
    >= cos_thr). Each round is one all-pairs sweep. Returns per-point root
    labels (n - 1 for invalid points)."""
    n = xyz.shape[0]
    dev = xyz.device
    none = torch.tensor(n - 1, dtype=torch.int32, device=dev)
    extras = [normals] if normals is not None else []

    def pull(l):
        def step(q, qv, qe, r, rv, re):
            inside = (sum_sq(q[:, None, :] - r[None, :, :]) <= r2) \
                & qv[:, None] & rv[None, :]
            if normals is not None:
                cosang = dot3(qe[0][:, None, :], re[0][None, :, :])
                inside = inside & (cosang.abs() >= cos_thr)
            return torch.where(inside, re[-1][None, :], none).amin(dim=1)

        best = blockwise_accumulate(xyz, mask, extras + [l], query_tile,
                                    ref_tile, step)
        return torch.where(mask, torch.minimum(l, best), none)

    def round_(l):
        l2 = pull(l)
        l2 = l2[l2.long()]
        l2 = l2[l2.long()]
        # re-mask after jumping: an invalid point's n-1 would index point
        # n-1's (possibly real) label and fake a change at the fixpoint
        return torch.where(mask, l2, none)

    labels0 = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                             device=dev), none)
    labels = _propagate_to_fixpoint(round_, pull(labels0), rounds)
    return labels


def _rank_tail(labels, mask, min_size, max_clusters: int):
    """Per-point root labels -> (labels 0..k-1 / -1, num, sizes)."""
    n = labels.shape[0]
    lab_pt = torch.where(mask, labels, n - 1)
    sizes_at_root = _segment_sum_i32(mask, lab_pt, n)
    is_root = (labels == torch.arange(n, dtype=torch.int32,
                                      device=labels.device)) & mask
    sizes_at_root = torch.where(is_root, sizes_at_root, 0)
    return _rank_from_sizes(sizes_at_root, lab_pt, mask, min_size,
                            max_clusters)


def euclidean_clusters_exact(pc: PointCloud, tolerance, min_size: int = 1,
                             max_clusters: int = 16,
                             rounds: int | None = None,
                             query_tile: int = 512, ref_tile: int = 1024):
    """Cluster by exact radius connectivity (PCL's contract: points connect
    iff |p_i - p_j| <= tolerance). O(N^2) per round: for analysis-scale
    clouds (voxel skeletons, plane-removed remainders, <= ~16k points).
    Same returns as ``euclidean_clusters``."""
    r2 = scalar(tolerance, pc.xyz) ** 2
    labels = _propagate_exact(pc.xyz, pc.mask, r2, None, None,
                              64 if rounds is None else rounds,
                              query_tile, ref_tile)
    return _rank_tail(labels, pc.mask, min_size, max_clusters)


def region_growing(pc: PointCloud, normals: torch.Tensor, tolerance,
                   angle_threshold, normals_valid: torch.Tensor | None = None,
                   curvature: torch.Tensor | None = None,
                   curvature_threshold=None, min_size: int = 1,
                   max_clusters: int = 16, rounds: int | None = None,
                   query_tile: int = 512, ref_tile: int = 1024):
    """Smoothness-constrained segmentation (pcl::RegionGrowing role): two
    points join a region iff they are within ``tolerance`` and their
    normals agree within ``angle_threshold`` radians (|n_i . n_j|, so
    flipped normals do not split a surface); the regions are the closure
    of that pairwise graph. With ``curvature`` (``ops.estimate_curvature``)
    points above ``curvature_threshold`` are left out (label -1). Same
    returns as ``euclidean_clusters``."""
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    if curvature is not None:
        if curvature_threshold is None:
            raise ValueError("curvature needs curvature_threshold")
        valid = valid & (curvature <= scalar(curvature_threshold,
                                             curvature))
    r2 = scalar(tolerance, pc.xyz) ** 2
    if torch.is_tensor(angle_threshold):
        cos_thr = torch.cos(scalar(angle_threshold, pc.xyz))
    else:   # on the host: CUDA's float32 cos can miss the CPU's by an ulp
        cos_thr = scalar(math.cos(float(np.float32(angle_threshold))),
                         pc.xyz)
    labels = _propagate_exact(pc.xyz, valid, r2, cos_thr, normals,
                              64 if rounds is None else rounds,
                              query_tile, ref_tile)
    return _rank_tail(labels, valid, min_size, max_clusters)


def _cluster_slots(pc: PointCloud, labels: torch.Tensor, k: int):
    """(slot per point, k for points in no cluster; 0/1 weights)."""
    lab = torch.where((labels >= 0) & pc.mask, labels, k)
    return lab, (lab < k).to(torch.float32)


_BIG = 3.4e38


def cluster_stats(pc: PointCloud, labels: torch.Tensor,
                  max_clusters: int = 16):
    """Per-cluster centroid and axis-aligned bounding box (getMinMax3D +
    compute3DCentroid per cluster); labels as ``euclidean_clusters`` gives
    them (-1 ignored).

    Returns (centroids [K, 3], aabb_lo [K, 3], aabb_hi [K, 3], counts [K]
    int32), zero rows for absent clusters.
    """
    k = max_clusters
    lab, w = _cluster_slots(pc, labels, k)
    sums = _segment_sum_f(pc.xyz * w[:, None], lab, k + 1)
    cnt = _segment_sum_f(w, lab, k + 1)
    centroids = sums[:k] / torch.clamp(cnt[:k, None], min=1.0)
    inside = w[:, None] > 0
    lo = _segment_extreme(torch.where(inside, pc.xyz, _BIG), lab, k + 1,
                          "amin", _BIG)[:k]
    hi = _segment_extreme(torch.where(inside, pc.xyz, -_BIG), lab, k + 1,
                          "amax", -_BIG)[:k]
    present = (cnt[:k] > 0)[:, None]
    return (torch.where(present, centroids, 0.0),
            torch.where(present, lo, 0.0), torch.where(present, hi, 0.0),
            cnt[:k].to(torch.int32))


def oriented_bboxes(pc: PointCloud, labels: torch.Tensor,
                    max_clusters: int = 16):
    """Per-cluster oriented bounding boxes from covariance eigenvectors
    (pcl::MomentOfInertiaEstimation::getOBB per cluster), all clusters at
    once: segment sums give every 3x3 second-moment matrix about its
    cluster's mean, one batched ``eigh`` their axes, and segment min/max of
    each point in its own cluster's frame the extents.

    Returns ``(centers [K,3], axes [K,3,3], half [K,3], counts [K])``:
    ``axes[k]`` rows are the box axes (major first, right-handed), a corner
    is ``centers[k] + axes[k].T @ (s * half[k])`` for s in {-1,1}^3. Zero
    rows for absent clusters. An eigenvector's sign is arbitrary: the axes
    agree with another implementation up to sign, the centres and half
    extents do not depend on it. On CUDA the ``eigh`` syncs once.
    """
    k = max_clusters
    dev = pc.xyz.device
    lab, w = _cluster_slots(pc, labels, k)
    cnt = _segment_sum_f(w, lab, k + 1)
    mean = (_segment_sum_f(pc.xyz * w[:, None], lab, k + 1)
            / torch.clamp(cnt[:, None], min=1.0))               # [k+1, 3]
    # moments about each cluster's own mean (at range, moments about the
    # origin would cancel in float32)
    d = (pc.xyz - mean[lab]) * w[:, None]
    d64 = d.to(torch.float64)
    outer = (d64[:, :, None] * d64[:, None, :]).reshape(-1, 9)
    # the scatter and its eigh in float64: a near-round cluster's axes are
    # ill-conditioned, and the devices' float32 solvers would part there
    cov = (_segment_sum64(outer, lab, k + 1)[:k]
           / torch.clamp(cnt[:k, None], min=1.0)).reshape(k, 3, 3)
    _, evecs = eigh(cov)                                         # ascending
    axes = torch.flip(evecs.to(torch.float32), dims=[-1]).transpose(1, 2)
    # right-handed: the minor axis is major x middle
    axes = torch.cat([axes[:, :2], torch.linalg.cross(
        axes[:, 0], axes[:, 1])[:, None]], dim=1)
    pad_axes = torch.cat([axes, torch.eye(3, device=dev)[None]])  # [k+1,3,3]
    q = dot3(pad_axes[lab], d[:, None, :])                 # [N, 3]
    inside = w[:, None] > 0
    lo = _segment_extreme(torch.where(inside, q, _BIG), lab, k + 1, "amin",
                          _BIG)[:k]
    hi = _segment_extreme(torch.where(inside, q, -_BIG), lab, k + 1,
                          "amax", -_BIG)[:k]
    present = cnt[:k] > 0
    half = torch.where(present[:, None], (hi - lo) / 2.0, 0.0)
    mid = (hi + lo) / 2.0
    centers = torch.where(
        present[:, None],
        mean[:k] + dot3(axes.transpose(1, 2), mid[:, None, :]), 0.0)
    axes = torch.where(present[:, None, None], axes, 0.0)
    return centers, axes, half, cnt[:k].to(torch.int32)
