"""Iterative Closest Point: batched for the stitcher, single-pair for
registration.

Port of ``pointcloud_stitching_tpu/ops/icp.py``. ``icp_batched`` and
``icp_point_to_plane_batched`` serve the stitcher's ring drift correction:
each iteration is one batched NN call over every camera pair (kernel K3,
with the reference prepared once per call), correspondence rejection (max
distance, optional trimming), and a per-pair solve: weighted Kabsch
(point-to-point) or the 6x6 linearised normal equations (point-to-plane).
The 6x6 solve uses ``torch.linalg.solve_ex``: unlike ``solve`` it neither
raises on a singular system nor waits for the device to report one.

``icp`` (fixed iterations) and ``icp_converge`` (PCL-style epsilon
termination) align one pair, as the offline registration tool does. With
``prune=True`` their NN is the key-range-pruned search (K3 coarse pass +
``block_ranges`` + K4), which equals brute force and pays off on large
voxel-sorted clouds. Unlike the JAX package, which ignores ``prune`` off
the TPU, the port honours it on every device; the plain versions run it on
the CPU.

Every entry point takes the reference's parameters at the reference's
positions, so callers written for it run as they are, by position or by
keyword. ``query_tile``/``ref_tile`` (they size the JAX package's XLA
sweep; the port's NN kernels have no such tiles) and ``nn_interpret``
(Pallas's interpreter; the port's CPU path is the plain version) are taken
and ignored.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.nn_pallas import (nearest_neighbors_pruned,
                                 nn_batched_prepared, prepare_ref_batched)
from ..utils.profiling import annotate
from ..utils.types import PointCloud, scalar
from .kabsch import kabsch
from .nn import nearest_neighbors
from .se3 import mm, se3_apply, se3_from_rt, se3_inverse, so3_exp


class ICPResult(NamedTuple):
    T: torch.Tensor           # [B, 4, 4] (batched) or [4, 4] src→dst
    mean_error: torch.Tensor  # [B] or [] mean squared inlier residual
    num_inliers: torch.Tensor  # [B] or [] int32
    iterations: torch.Tensor  # [B] or [] int32


def _make_nn_batched(dst: PointCloud, nn_impl: str):
    """nn(p) -> (idx, d2) against ``dst``; the reference is prepared once."""
    refT = prepare_ref_batched(dst.xyz, dst.mask)
    return lambda p: nn_batched_prepared(p, refT, impl=nn_impl)


def _trim_weights(w: torch.Tensor, d2: torch.Tensor,
                  trim_fraction: float) -> torch.Tensor:
    """Zero the worst ``trim_fraction`` of the accepted correspondences.

    nanquantile with the 'lower' interpolation, as the JAX package: rejected
    entries are NaN and must not take part in the quantile."""
    if trim_fraction <= 0.0:
        return w
    q = torch.nanquantile(torch.where(w > 0, d2, float("nan")),
                          1.0 - trim_fraction, dim=-1, keepdim=True,
                          interpolation="lower")
    q = torch.where(torch.isnan(q), float("inf"), q)  # nothing accepted
    return torch.where(d2 <= q, w, 0.0)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, M, C] rows at idx [B, N] -> [B, N, C]."""
    return a.gather(1, idx.long()[..., None].expand(*idx.shape, a.shape[-1]))


def _init(src: PointCloud, init_T, max_corr_dist):
    b = src.xyz.shape[0]
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=src.xyz.device)
    T = init_T.to(torch.float32).expand(b, 4, 4).clone()
    max_d2 = scalar(max_corr_dist, src.xyz) ** 2
    return b, T, max_d2


def icp_batched(src: PointCloud, dst: PointCloud,
                init_T: torch.Tensor | None = None, iterations: int = 5,
                max_corr_dist=0.1, query_tile: int = 1024,
                ref_tile: int = 4096, nn_impl: str = "auto",
                trim_fraction: float = 0.0,
                nn_interpret: bool = False) -> ICPResult:
    """Point-to-point ICP over B independent cloud pairs at once.

    ``query_tile``, ``ref_tile`` and ``nn_interpret`` sit at the JAX
    function's positions and are ignored (see the module docstring)."""
    b, T, max_d2 = _init(src, init_T, max_corr_dist)
    nn = _make_nn_batched(dst, nn_impl)
    err = torch.full((b,), float("inf"), device=src.xyz.device)
    n_in = torch.zeros((b,), device=src.xyz.device)
    for _ in range(iterations):
        with annotate("pcs.icp.iter"):
            p = se3_apply(T, src.xyz)
            idx, d2 = nn(p)
            w = (src.mask & (d2 <= max_d2)).to(torch.float32)
            w = _trim_weights(w, d2, trim_fraction)
            dT = kabsch(p, _gather_rows(dst.xyz, idx), w)
            n_in = w.sum(dim=-1)
            err = (w * d2).sum(dim=-1) / torch.clamp(n_in, min=1.0)
            T = mm(dT, T)
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((b,), iterations, dtype=torch.int32,
                                           device=T.device))


def _exp_se3(x: torch.Tensor) -> torch.Tensor:
    """Small-motion SE(3) from x = [omega, t] (the point-to-plane update)."""
    return se3_from_rt(so3_exp(x[..., :3]), x[..., 3:])


def icp_point_to_plane_batched(src: PointCloud, dst: PointCloud,
                               dst_normals: torch.Tensor,
                               init_T: torch.Tensor | None = None,
                               iterations: int = 5, max_corr_dist=0.1,
                               query_tile: int = 1024,
                               ref_tile: int = 4096,
                               nn_impl: str = "auto",
                               trim_fraction: float = 0.0,
                               nn_interpret: bool = False) -> ICPResult:
    """Point-to-plane ICP over B cloud pairs (Chen & Medioni).

    Minimises sum w ((R p + t - q) . n_q)^2 per iteration through the
    linearised 6x6 normal equations. dst_normals: [B, M, 3] unit normals;
    correspondences with near-zero normals are dropped. ``query_tile``,
    ``ref_tile`` and ``nn_interpret`` are ignored, as in ``icp_batched``.
    """
    b, T, max_d2 = _init(src, init_T, max_corr_dist)
    nn = _make_nn_batched(dst, nn_impl)
    dev = src.xyz.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    err = torch.full((b,), float("inf"), device=dev)
    n_in = torch.zeros((b,), device=dev)
    for _ in range(iterations):
        with annotate("pcs.icp.iter"):
            p = se3_apply(T, src.xyz)                    # [B, N, 3]
            idx, d2 = nn(p)
            q = _gather_rows(dst.xyz, idx)
            n = _gather_rows(dst_normals, idx)
            n_ok = (n * n).sum(dim=-1) > 0.25            # unit or zeroed
            w = (src.mask & (d2 <= max_d2) & n_ok).to(torch.float32)
            w = _trim_weights(w, d2, trim_fraction)

            r0 = ((p - q) * n).sum(dim=-1)               # [B, N]
            J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)
            wJ = w[..., None] * J
            A = torch.einsum("bni,bnj->bij", wJ, J)
            rhs = -torch.einsum("bni,bn->bi", J, w * r0)
            # Tikhonov floor keeps degenerate frames (all rejected) solvable
            A = A + 1e-8 * eye6
            x = torch.linalg.solve_ex(A, rhs[..., None]).result[..., 0]
            n_in = w.sum(dim=-1)
            # identity if starved
            x = torch.where((n_in > 5.0)[:, None], x, 0.0)
            dT = _exp_se3(x)
            err = (w * r0 * r0).sum(dim=-1) / torch.clamp(n_in, min=1.0)
            T = mm(dT, T)
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((b,), iterations, dtype=torch.int32,
                                           device=dev))


def _icp_step(T, src: PointCloud, dst: PointCloud, max_d2, nn_impl: str,
              trim_fraction: float, prune: bool):
    """One point-to-point iteration of a single pair -> (T', err, n_in)."""
    p = se3_apply(T, src.xyz)
    if prune:
        idx, d2 = nearest_neighbors_pruned(p[None], dst.xyz[None],
                                           dst.mask[None], src.mask[None],
                                           impl=nn_impl)
        idx, d2 = idx[0], d2[0]
    else:
        idx, d2 = nearest_neighbors(p, dst.xyz, dst.mask, impl=nn_impl)
    w = (src.mask & (d2 <= max_d2)).to(torch.float32)
    w = _trim_weights(w, d2, trim_fraction)
    dT = kabsch(p, dst.xyz[idx.long()], w)
    n_in = w.sum()
    err = (w * d2).sum() / torch.clamp(n_in, min=1.0)
    return mm(dT, T), err, n_in


def _init_single(src: PointCloud, init_T, max_corr_dist):
    dev = src.xyz.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    T = init_T.to(device=dev, dtype=torch.float32)
    err = torch.full((), float("inf"), device=dev)
    n_in = torch.zeros((), device=dev)
    return T, scalar(max_corr_dist, src.xyz) ** 2, err, n_in


def _result(T, err, n_in, iterations: int) -> ICPResult:
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((), iterations, dtype=torch.int32,
                                           device=T.device))


def icp(src: PointCloud, dst: PointCloud,
        init_T: torch.Tensor | None = None, iterations: int = 5,
        max_corr_dist=0.1, query_tile: int = 1024, ref_tile: int = 4096,
        nn_impl: str = "auto", trim_fraction: float = 0.0,
        prune: bool = False) -> ICPResult:
    """Fixed-iteration point-to-point ICP of one pair (constant cost).

    src/dst: PointClouds with xyz [N, 3] / [M, 3]. prune=True uses the
    key-range-pruned NN (exact; see kernels.nn_pallas
    .nearest_neighbors_pruned), which pays off on large voxel-sorted
    clouds. ``query_tile``/``ref_tile`` are ignored.
    """
    T, max_d2, err, n_in = _init_single(src, init_T, max_corr_dist)
    for _ in range(iterations):
        T, err, n_in = _icp_step(T, src, dst, max_d2, nn_impl,
                                 trim_fraction, prune)
    return _result(T, err, n_in, iterations)


def icp_converge(src: PointCloud, dst: PointCloud,
                 init_T: torch.Tensor | None = None,
                 max_iterations: int = 50,
                 transformation_epsilon: float = 1e-8,
                 max_corr_dist=0.25, query_tile: int = 1024,
                 ref_tile: int = 4096, nn_impl: str = "auto",
                 trim_fraction: float = 0.0,
                 prune: bool = False) -> ICPResult:
    """ICP with PCL-style termination: stop when the incremental
    transform's squared Frobenius distance from identity drops to
    ``transformation_epsilon`` or after ``max_iterations``.

    The test runs on the host: one host sync per iteration (the JAX
    package's ``while_loop`` has none), which an offline tool can afford.
    On CUDA, Kabsch's ``torch.linalg.svd`` adds two more per iteration
    (it reads its status on the host). ``query_tile``/``ref_tile`` are
    ignored.
    """
    T, max_d2, err, n_in = _init_single(src, init_T, max_corr_dist)
    eye = torch.eye(4, dtype=torch.float32, device=T.device)
    it = 0
    while it < max_iterations:
        T2, err, n_in = _icp_step(T, src, dst, max_d2, nn_impl,
                                  trim_fraction, prune)
        # rigid inverse (transpose + negate) and a full-float32 product
        delta = ((mm(T2, se3_inverse(T)) - eye) ** 2).sum()
        T = T2
        it += 1
        if not bool(delta > transformation_epsilon):  # the host sync
            break
    return _result(T, err, n_in, it)
