"""Batched fixed-iteration ICP for the stitcher's ring drift correction.

Port of ``icp_batched`` and ``icp_point_to_plane_batched`` from
``pointcloud_stitching_tpu/ops/icp.py``. Each iteration is one batched NN
call over every camera pair (kernel K3, with the reference prepared once
per call), correspondence rejection (max distance, optional trimming), and
a per-pair solve: weighted Kabsch (point-to-point) or the 6x6 linearised
normal equations (point-to-plane). The 6x6 solve uses
``torch.linalg.solve_ex``: unlike ``solve`` it neither raises on a singular
system nor waits for the device to report one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.nn_pallas import nn_batched_prepared, prepare_ref_batched
from ..utils.types import PointCloud, scalar
from .kabsch import kabsch
from .se3 import mm, se3_apply, se3_from_rt, so3_exp


class ICPResult(NamedTuple):
    T: torch.Tensor           # [B, 4, 4] refined src→dst transforms
    mean_error: torch.Tensor  # [B] mean squared correspondence residual
    num_inliers: torch.Tensor  # [B] int32
    iterations: torch.Tensor  # [B] int32


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
                max_corr_dist=0.1, nn_impl: str = "auto",
                trim_fraction: float = 0.0) -> ICPResult:
    """Point-to-point ICP over B independent cloud pairs at once."""
    b, T, max_d2 = _init(src, init_T, max_corr_dist)
    nn = _make_nn_batched(dst, nn_impl)
    err = torch.full((b,), float("inf"), device=src.xyz.device)
    n_in = torch.zeros((b,), device=src.xyz.device)
    for _ in range(iterations):
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
                               nn_impl: str = "auto",
                               trim_fraction: float = 0.0) -> ICPResult:
    """Point-to-plane ICP over B cloud pairs (Chen & Medioni).

    Minimises sum w ((R p + t - q) . n_q)^2 per iteration through the
    linearised 6x6 normal equations. dst_normals: [B, M, 3] unit normals;
    correspondences with near-zero normals are dropped.
    """
    b, T, max_d2 = _init(src, init_T, max_corr_dist)
    nn = _make_nn_batched(dst, nn_impl)
    dev = src.xyz.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    err = torch.full((b,), float("inf"), device=dev)
    n_in = torch.zeros((b,), device=dev)
    for _ in range(iterations):
        p = se3_apply(T, src.xyz)                        # [B, N, 3]
        idx, d2 = nn(p)
        q = _gather_rows(dst.xyz, idx)
        n = _gather_rows(dst_normals, idx)
        n_ok = (n * n).sum(dim=-1) > 0.25                # unit or zeroed
        w = (src.mask & (d2 <= max_d2) & n_ok).to(torch.float32)
        w = _trim_weights(w, d2, trim_fraction)

        r0 = ((p - q) * n).sum(dim=-1)                   # [B, N]
        J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)
        wJ = w[..., None] * J
        A = torch.einsum("bni,bnj->bij", wJ, J)
        rhs = -torch.einsum("bni,bn->bi", J, w * r0)
        # Tikhonov floor keeps degenerate frames (all rejected) solvable
        A = A + 1e-8 * eye6
        x = torch.linalg.solve_ex(A, rhs[..., None]).result[..., 0]
        n_in = w.sum(dim=-1)
        x = torch.where((n_in > 5.0)[:, None], x, 0.0)   # identity if starved
        dT = _exp_se3(x)
        err = (w * r0 * r0).sum(dim=-1) / torch.clamp(n_in, min=1.0)
        T = mm(dT, T)
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((b,), iterations, dtype=torch.int32,
                                           device=dev))
