"""Generalized ICP (plane-to-plane).

Port of ``pointcloud_stitching_tpu/ops/gicp.py`` (the role of
``pcl::GeneralizedIterativeClosestPoint``, Segal et al., RSS 2009). Every
point of both clouds carries a disc-shaped surface covariance, and each
correspondence is weighted by the Mahalanobis metric of the combined one,

    M_i = (C_i^dst + R C_i^src R^T)^-1,
    cost = sum_i w_i d_i^T M_i d_i,   d_i = q_i - (R p_i + t).

Each iteration is one NN search (kernel K3, through ``ops.nn``), one
batched 3x3 inverse and one 6x6 Gauss-Newton solve. The inverse and the
solve are the ``_ex`` forms, which neither raise nor wait for the device
to report a singular matrix; the epsilon test is the one host sync per
iteration (``icp_converge``'s rule).

Covariances come from normals: C = eps n n^T + (I - n n^T), PCL's
(eps, 1, 1) regularisation; points without a valid normal get C = I.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud, scalar
from .icp import ICPResult, _exp_se3, _trim_weights
from .nn import nearest_neighbors
from .se3 import mm, se3_apply, se3_inverse


def gicp_covariances(normals: torch.Tensor, valid: torch.Tensor,
                     epsilon=1e-3) -> torch.Tensor:
    """Per-point GICP surface covariances [N, 3, 3] from unit normals:
    eigenvalues (eps, 1, 1), the small one along the normal; invalid
    normals get the isotropic identity."""
    eps = scalar(epsilon, normals)
    nnt = normals[..., :, None] * normals[..., None, :]
    eye = torch.eye(3, dtype=torch.float32, device=normals.device)
    c = eye - (1.0 - eps) * nnt
    return torch.where(valid[..., None, None], c, eye)


def _neg_skew(p: torch.Tensor) -> torch.Tensor:
    """-[p]_x per row: [N, 3] -> [N, 3, 3]."""
    x, y, z = p.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, z, -y], -1),
                        torch.stack([-z, zero, x], -1),
                        torch.stack([y, -x, zero], -1)], dim=-2)


def gicp(src: PointCloud, dst: PointCloud,
         src_normals: torch.Tensor, dst_normals: torch.Tensor,
         src_normals_valid: torch.Tensor | None = None,
         dst_normals_valid: torch.Tensor | None = None,
         init_T: torch.Tensor | None = None,
         max_iterations: int = 50,
         transformation_epsilon: float = 1e-8,
         max_corr_dist=0.25, cov_epsilon=1e-3,
         query_tile: int = 1024, ref_tile: int = 4096,
         nn_impl: str = "auto", trim_fraction: float = 0.0) -> ICPResult:
    """Plane-to-plane ICP with PCL-style epsilon/max-iteration termination.

    Args:
      src, dst: clouds [N, 3] / [M, 3] (+masks).
      src_normals, dst_normals: unit normals (``estimate_normals``);
        ``*_normals_valid`` optional: invalid-normal points use an
        isotropic covariance instead of dropping out.
      cov_epsilon: the normal-direction eigenvalue (PCL's gicp_epsilon_;
        1.0 = isotropic = point-to-point).
      query_tile, ref_tile: taken and ignored (see ``ops.nn``).

    One Gauss-Newton step per correspondence set. Returns ICPResult;
    ``mean_error`` is the mean Mahalanobis residual d^T M d over inliers.
    """
    dev = src.xyz.device
    sv = src.mask if src_normals_valid is None else \
        src.mask & src_normals_valid
    dv = dst.mask if dst_normals_valid is None else \
        dst.mask & dst_normals_valid
    c_src = gicp_covariances(src_normals, sv, cov_epsilon)   # [N, 3, 3]
    c_dst = gicp_covariances(dst_normals, dv, cov_epsilon)   # [M, 3, 3]
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init_T is None
         else init_T.to(device=dev, dtype=torch.float32))
    max_d2 = scalar(max_corr_dist, src.xyz) ** 2
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    err = torch.full((), float("inf"), device=dev)
    n_in = torch.zeros((), device=dev)
    it = 0
    while it < max_iterations:
        p = se3_apply(T, src.xyz)
        idx, d2 = nearest_neighbors(p, dst.xyz, dst.mask, impl=nn_impl)
        idx = idx.long()
        q = dst.xyz[idx]
        w = (src.mask & (d2 <= max_d2)).to(torch.float32)
        w = _trim_weights(w, d2, trim_fraction)

        R = T[:3, :3]
        csum = mm(mm(R, c_src), R.T) + c_dst[idx] + 1e-6 * eye3
        m = torch.linalg.inv_ex(csum).inverse
        d = q - p
        J = torch.cat([_neg_skew(p), eye3.expand(p.shape[0], 3, 3)], -1)
        mJ = mm(m * w[:, None, None], J)                     # [N, 3, 6]
        A = torch.einsum("nki,nkj->ij", J, mJ) + 1e-8 * eye6
        b = torch.einsum("nki,nk->i", mJ, d)
        x = torch.linalg.solve_ex(A, b[:, None]).result[:, 0]
        n_in = w.sum()
        x = torch.where(n_in > 5.0, x, 0.0)
        T2 = mm(_exp_se3(x), T)
        md = mm(m, d[:, :, None])[:, :, 0]
        err = (w * (d * md).sum(dim=-1)).sum() / torch.clamp(n_in, min=1.0)
        delta = ((mm(T2, se3_inverse(T)) - eye4) ** 2).sum()
        T = T2
        it += 1
        if not bool(delta > transformation_epsilon):  # the host sync
            break
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((), it, dtype=torch.int32,
                                           device=dev))
