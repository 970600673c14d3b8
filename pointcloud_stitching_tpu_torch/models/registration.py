"""Offline pairwise registration — the calibration workflow.

Port of ``pointcloud_stitching_tpu/models/registration.py`` (the
reference's registration tool, adapted from PCL's manual_registration —
SURVEY.md §3.4): pick >=3 corresponding point pairs between two clouds →
closed-form SVD (Kabsch) solve → optional ICP refinement → write the 4x4
extrinsic as a .cal file the streaming client consumes. ``register_global``
needs no picks: a batched multi-start ICP on voxel skeletons, the winner
polished at full resolution.

``kernel_impl`` ('auto' | 'cuda' | 'torch') routes every kernel of the
path (K1 in the skeleton voxel pass, K3 in the multi-start ICP and the
coarse NN pass, K4 in the pruned refinement, the random draws' threefry2x32
and scan). ``fpfh_starts`` adds hypotheses seeded from FPFH descriptor
matches (``ops.fpfh``). The random draws come from the caller's key
through ``utils.prng``, at the JAX package's places: the same key gives
JAX's starts.
"""
from __future__ import annotations

from itertools import permutations, product
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..io.calio import save_cal
from ..ops.fpfh import fpfh, match_fpfh
from ..ops.icp import ICPResult, icp_batched, icp_converge
from ..ops.kabsch import kabsch
from ..ops.mls import estimate_normals
from ..ops.voxel import voxel_downsample
from ..utils import prng
from ..utils.types import PointCloud, scalar


class RegistrationResult(NamedTuple):
    T: torch.Tensor              # src→dst 4x4
    initial_T: torch.Tensor      # from correspondences only (pre-ICP)
    icp: Optional[ICPResult]     # None if refinement disabled


def register_from_correspondences(src: PointCloud, dst: PointCloud,
                                  src_idx: Sequence[int],
                                  dst_idx: Sequence[int]) -> torch.Tensor:
    """Closed-form rigid solve from picked correspondence pairs.

    Mirrors pcl::registration::TransformationEstimationSVD over the picked
    pairs (>=3 non-collinear pairs required for a unique solution).
    """
    dev = src.xyz.device
    si = torch.as_tensor(np.asarray(src_idx, np.int64), device=dev)
    di = torch.as_tensor(np.asarray(dst_idx, np.int64), device=dev)
    if si.shape != di.shape or si.dim() != 1 or si.shape[0] < 3:
        raise ValueError("need >=3 correspondence pairs")
    w = (src.mask[si] & dst.mask[di]).to(torch.float32)
    return kabsch(src.xyz[si], dst.xyz[di], w)


def register_pair(src: PointCloud, dst: PointCloud,
                  src_idx: Optional[Sequence[int]] = None,
                  dst_idx: Optional[Sequence[int]] = None,
                  refine: bool = True,
                  max_iterations: int = 50,
                  transformation_epsilon: float = 1e-8,
                  max_corr_dist: float = 0.25,
                  query_tile: int = 1024,
                  ref_tile: int = 4096,
                  trim_fraction: float = 0.0,
                  prune: bool = False,
                  kernel_impl: str = "auto") -> RegistrationResult:
    """Full calibration solve: optional picked-pair init + ICP refinement.
    The parameters sit at the JAX package's positions; ``query_tile``/
    ``ref_tile`` are taken and ignored (see ops.icp), and the port's
    ``kernel_impl`` comes after them all."""
    if src_idx is not None:
        init_T = register_from_correspondences(src, dst, src_idx, dst_idx)
    else:
        init_T = torch.eye(4, dtype=torch.float32, device=src.xyz.device)
    icp_res = None
    T = init_T
    if refine:
        icp_res = icp_converge(src, dst, init_T=init_T,
                               max_iterations=max_iterations,
                               transformation_epsilon=transformation_epsilon,
                               max_corr_dist=max_corr_dist,
                               nn_impl=kernel_impl,
                               trim_fraction=trim_fraction, prune=prune)
        T = icp_res.T
    return RegistrationResult(T=T, initial_T=init_T, icp=icp_res)


def _quat_rotations(q: torch.Tensor) -> torch.Tensor:
    """Unit-quaternion batch [M, 4] (wxyz) → rotation matrices [M, 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _pca_axes(xyz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted principal axes [3, 3] (columns, ascending eigenvalue).

    The basis is forced right-handed (det +1): eigh returns eigenvector
    matrices of arbitrary determinant sign, and a left-handed basis would
    turn every proper alignment of _ALIGN24 into a reflection.
    """
    tot = torch.clamp(w.sum(), min=1.0)
    c = (xyz * w[:, None]).sum(dim=0) / tot
    d = (xyz - c) * w[:, None]
    _, v = torch.linalg.eigh(d.T @ d)
    flip = torch.where(torch.linalg.det(v) < 0, -1.0, 1.0)
    return torch.cat([v[:, :1] * flip, v[:, 1:]], dim=1)


def _basis_alignments() -> np.ndarray:
    """The 24 proper rotations mapping one orthonormal basis onto another
    under every axis permutation and sign flip (det +1 only), as
    permutation/sign matrices applied between the two eigenbases."""
    mats = []
    for perm in permutations(range(3)):
        for signs in product((1.0, -1.0), repeat=3):
            m = np.zeros((3, 3), np.float32)
            for i, (p, s) in enumerate(zip(perm, signs)):
                m[i, p] = s
            if np.linalg.det(m) > 0:
                mats.append(m)
    return np.stack(mats)  # [24, 3, 3]


_ALIGN24 = _basis_alignments()


def _fpfh_features(cs: PointCloud, cd: PointCloud, leaf: float,
                   k_corr: int = 8, normal_radius: Optional[float] = None,
                   feature_radius: Optional[float] = None):
    """FPFH descriptors of both skeletons and each source descriptor's
    ``k_corr`` nearest target descriptors: (vs, vd, idx, md2).

    Normals are estimated per cloud with the viewpoint at that cloud's own
    origin: each cloud lives in its own sensor frame during calibration,
    so orientation is consistent across the pair without the relative
    pose."""
    nr = 2.5 * leaf if normal_radius is None else normal_radius
    fr = 5.0 * leaf if feature_radius is None else feature_radius
    ns_, oks = estimate_normals(cs, nr)
    nd_, okd = estimate_normals(cd, nr)
    fs, vs = fpfh(cs, ns_, oks, radius=fr)
    fd, vd = fpfh(cd, nd_, okd, radius=fr)
    idx, md2 = match_fpfh(fs, vs, fd, vd, k=k_corr)      # [N, k_corr]
    return vs, vd, idx, md2


def _fpfh_hypotheses(cs: PointCloud, cd: PointCloud, feats,
                     si: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """Rigid hypotheses [S, 4, 4] from sampled source triples ``si`` [S, 3]
    and the chosen match of each, ``pick`` [S, 3] in [0, k_corr): closed-form
    Kabsch per triple, batched."""
    vs, vd, idx, md2 = feats
    si, pick = si.long(), pick.long()
    di = idx[si, pick].long()                            # [S, 3]
    # match_fpfh pads unmatched slots with index 0 and a ~1e12 sentinel
    # distance: zero-weight those, or Kabsch would fit made-up pairs
    matched = md2[si, pick] < 1e11
    w = (vs[si] & vd[di] & matched).to(torch.float32)
    return kabsch(cs.xyz[si], cd.xyz[di], w)


def _fpfh_start_transforms(cs: PointCloud, cd: PointCloud,
                           key: torch.Tensor, n_starts: int,
                           leaf: float, k_corr: int = 8,
                           normal_radius: Optional[float] = None,
                           feature_radius: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Descriptor-seeded rigid hypotheses [n_starts, 4, 4].

    The correspondence half of ``pcl::SampleConsensusInitialAlignment``:
    ``n_starts`` source triples drawn uniformly from the valid descriptors
    (a categorical over logits 0 / -1e9: with no valid descriptor the draw
    stays uniform over all), each point matched to one of its ``k_corr``
    nearest target descriptors at random, then Kabsch. The hypotheses join
    register_global's scoring pool, so a bad triple simply loses. The
    draws are the JAX package's: ``k1, k2 = split(key)``, the triples a
    ``categorical`` from k1 and the matches a ``randint`` from k2, on the
    clouds' device (``impl`` routes the draws' kernels).
    """
    feats = _fpfh_features(cs, cd, leaf, k_corr, normal_radius,
                           feature_radius)
    k1, k2 = prng.split(prng.key_on(key, cs.xyz.device), impl=impl)
    logits = torch.where(feats[0], 0.0, -1e9)
    si = prng.categorical(k1, logits, shape=(n_starts, 3), impl=impl)
    pick = prng.randint(k2, (n_starts, 3), 0, k_corr, impl=impl)
    return _fpfh_hypotheses(cs, cd, feats, si, pick)


def _centroid(pc: PointCloud, w: torch.Tensor) -> torch.Tensor:
    return (pc.xyz * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)


def register_global(src: PointCloud, dst: PointCloud,
                    key: torch.Tensor,
                    num_starts: int = 64,
                    coarse_leaf: float = 0.05,
                    coarse_capacity: int = 1024,
                    coarse_iterations: int = 15,
                    coarse_corr_dist: Optional[float] = None,
                    coarse_trim: float = 0.1,
                    query_tile: int = 512, ref_tile: int = 1024,
                    refine: bool = True,
                    fpfh_starts: int = 0, fpfh_k_corr: int = 8,
                    kernel_impl: str = "auto",
                    **refine_kw) -> RegistrationResult:
    """Automatic pairwise registration — no picked correspondences.

    Parallel multi-start ICP: the hypotheses are [identity] + [the 24
    proper rotations aligning the two clouds' PCA eigenbases] + random
    rotations (normalised 4-D Gaussians, ``prng.normal`` drawn from
    ``key`` on the clouds' device as JAX draws them), each centred by a
    centroid-matching translation.
    All of them run as one batched ICP on voxel skeletons of
    ``coarse_capacity`` points (the leaf starts at ``coarse_leaf`` and
    coarsens until both clouds fit: a saturated pass would keep
    orientation-dependent crops), with a loose gate (default 4x the fitted
    leaf) and light trimming. The winner — most inliers, mean error as the
    tie-break — seeds a full-resolution ``icp_converge`` (``refine_kw``;
    ``max_corr_dist`` defaults to twice the fitted leaf).

    The parameters sit at the JAX package's positions, with the port's
    ``kernel_impl`` after them all; ``query_tile``/``ref_tile`` are taken
    and ignored (see ops.icp). ``key`` is a ``utils.prng`` key
    (``prng.key(seed)``), split as JAX splits it, so the same key gives
    the JAX package's starts. With ``num_starts <= 25`` no random rotation
    is used (one is drawn all the same, as JAX draws it). Like any
    geometry-only method it can lock onto a symmetry of the scene: check
    ``icp.mean_error`` / ``num_inliers``. Where geometry alone is
    ambiguous, ``fpfh_starts > 0`` appends that many FPFH-correspondence
    hypotheses (``_fpfh_start_transforms``, each point matched among its
    ``fpfh_k_corr`` nearest descriptors) to the same scoring pool.
    """
    leaf = float(coarse_leaf)
    for _ in range(8):  # one host sync per try, as in the JAX package
        cs = voxel_downsample(src, leaf, capacity=coarse_capacity,
                              impl=kernel_impl)
        cd = voxel_downsample(dst, leaf, capacity=coarse_capacity,
                              impl=kernel_impl)
        if max(int(cs.count()), int(cd.count())) < 0.9 * coarse_capacity:
            break
        leaf *= 1.6
    coarse_leaf = leaf

    dev = src.xyz.device
    ws = cs.mask.to(torch.float32)
    wd = cd.mask.to(torch.float32)
    key = prng.key_on(key, dev)
    fkey = None
    if fpfh_starts > 0:
        key, fkey = prng.split(key, impl=kernel_impl)
    q = prng.normal(key, (max(num_starts - 25, 1), 4), impl=kernel_impl)
    vs = _pca_axes(cs.xyz, ws)
    vd = _pca_axes(cd.xyz, wd)
    align = torch.from_numpy(_ALIGN24).to(dev)
    rot_pca = torch.einsum("ij,ajk,lk->ail", vd, align, vs)  # vd A vs^T
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)[None]
    rot = torch.cat([eye3, rot_pca, _quat_rotations(q)])[:num_starts]
    m = rot.shape[0]
    t = _centroid(cd, wd)[None] - torch.einsum("mij,j->mi", rot,
                                               _centroid(cs, ws))
    init_T = torch.eye(4, dtype=torch.float32, device=dev).repeat(m, 1, 1)
    init_T[:, :3, :3] = rot
    init_T[:, :3, 3] = t
    if fpfh_starts > 0:
        init_T = torch.cat([init_T, _fpfh_start_transforms(
            cs, cd, fkey, fpfh_starts, coarse_leaf, fpfh_k_corr,
            impl=kernel_impl)])
        m = init_T.shape[0]

    bs = PointCloud(xyz=cs.xyz.expand(m, -1, -1), mask=cs.mask.expand(m, -1))
    bd = PointCloud(xyz=cd.xyz.expand(m, -1, -1), mask=cd.mask.expand(m, -1))
    corr = (coarse_corr_dist if coarse_corr_dist is not None
            else 4.0 * coarse_leaf)
    res = icp_batched(bs, bd, init_T=init_T, iterations=coarse_iterations,
                      max_corr_dist=corr, nn_impl=kernel_impl,
                      trim_fraction=coarse_trim)
    # most inliers wins; mean error (<= corr^2 by construction) tie-breaks
    score = (res.num_inliers.to(torch.float32)
             - res.mean_error / scalar(corr, res.mean_error) ** 2)
    t0 = res.T[torch.argmax(score)]

    icp_res = None
    T = t0
    if refine:
        refine_kw.setdefault("max_corr_dist", 2.0 * coarse_leaf)
        icp_res = icp_converge(src, dst, init_T=t0, nn_impl=kernel_impl,
                               **refine_kw)
        T = icp_res.T
    return RegistrationResult(T=T, initial_T=t0, icp=icp_res)


def write_cal(path: str, result: RegistrationResult) -> None:
    save_cal(path, result.T.detach().cpu().numpy())
