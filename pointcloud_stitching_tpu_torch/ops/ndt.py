"""Normal Distributions Transform registration.

Port of ``pointcloud_stitching_tpu/ops/ndt.py`` (the role of
``pcl::NormalDistributionsTransform``; Biber & Strasser 2003, Magnusson's
3-D form). The target becomes a grid of Gaussians, one mean and
covariance per occupied cell, and a pose is scored by how probable the
moved source points are under their cells' Gaussians.

  map build (``ndt_build``): one stable argsort of the cell keys, then
    segment sums over the sorted slots (kernel K2, ``segment_sum_sorted``:
    the slot ids are nondecreasing, and K2 adds in a fixed order where an
    atomic ``index_add_`` would not); covariances from centred residuals
    (a second pass), regularised by a batched ``eigh`` (small eigenvalues
    floored at ``eigen_floor`` x the largest) and inverted.
  scoring: moved points -> cell keys -> ``searchsorted`` into the sorted
    key table -> (mu, inv_cov) -> Magnusson's robustified exponential.
  optimisation (``ndt_align``): the gradient and the 6x6 Hessian of the
    scalar score at the increment 0 come from ``torch.func.grad`` and
    ``torch.func.hessian``. Cell assignment is piecewise constant in the
    pose, so the lookup is taken on detached points (the JAX package's
    ``stop_gradient``). Each Newton step scores a fan of step scales in one
    batched evaluation and keeps the best.

The epsilon test syncs with the host once per iteration; ``eigh`` in the
build syncs once per 16,384 slots (its status check).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.segment_reduce import segment_sum_sorted
from ..utils.linalg import eigh
from ..utils.types import PointCloud, scalar
from .icp import ICPResult, _exp_se3
from .se3 import mm, se3_apply

_SENT = torch.iinfo(torch.int32).max
_STEP_SCALES = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
_GRADIENT_SCALES = (0.3, 0.1, 0.03)


class NDTMap(NamedTuple):
    """A grid of Gaussians: sorted cell-key table + per-cell statistics."""
    keys: torch.Tensor      # [C] sorted linearized cell keys (sentinel-padded)
    mu: torch.Tensor        # [C, 3] cell means
    inv_cov: torch.Tensor   # [C, 3, 3] regularised inverse covariances
    valid: torch.Tensor     # [C] cell has >= min_points
    base: torch.Tensor      # [3] int32 grid origin (floor(min/cell))
    dims: torch.Tensor      # [3] int32 grid extents (for key arithmetic)
    cell: torch.Tensor      # scalar cell size (meters)


def _cell_keys(xyz, mask, cell, base, dims):
    """Linearized int32 cell keys (sentinel where invalid/out of grid)."""
    f = torch.floor(xyz * (1.0 / cell)).to(torch.int32) - base
    inb = mask & ((f >= 0) & (f < dims)).all(dim=-1)
    key = (f[..., 0] * dims[1] + f[..., 1]) * dims[2] + f[..., 2]
    return torch.where(inb, key, _SENT), inb


def ndt_build(dst: PointCloud, cell_size, min_points: int = 6,
              eigen_floor=0.05, impl: str = "auto") -> NDTMap:
    """Build the NDT map (grid of Gaussians) from a target cloud.

    Cells with fewer than ``min_points`` members are invalid. Covariance
    eigenvalues below ``eigen_floor`` x the largest are floored (the JAX
    package's default 0.05 rather than PCL's 0.01: razor-thin cells shrink
    the convergence basin on smooth surfaces). A grid of 2^31 cells or
    more makes the whole map invalid.
    """
    xyz, mask = dst.xyz, dst.mask
    n = xyz.shape[0]
    dev = xyz.device
    cell = scalar(cell_size, xyz)
    f = torch.floor(xyz * (1.0 / cell)).to(torch.int32)
    base = torch.where(mask[:, None], f, _SENT).amin(dim=0)
    base = torch.where(base == _SENT, 0, base)          # all-invalid cloud
    mx = torch.where(mask[:, None], f, torch.iinfo(torch.int32).min
                     ).amax(dim=0)
    dims = torch.clamp(mx - base + 1, min=1)
    cells_ok = dims.to(torch.float32).prod() < float(2 ** 31)
    key, _ = _cell_keys(xyz, mask, cell, base, dims)
    key = torch.where(cells_ok, key, _SENT)

    order = torch.argsort(key, stable=True)
    skey = key[order]
    sxyz = xyz[order]
    svalid = skey != _SENT
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    flags = (skey != prev) & svalid
    slot = torch.cumsum(flags.to(torch.int32), dim=0, dtype=torch.int32) - 1
    # invalid rows sort last: the dump slot n - 1 keeps the ids
    # nondecreasing, and their zero weight adds nothing to it
    slot = torch.where(svalid, slot, n - 1)

    w = svalid.to(torch.float32)
    s1 = segment_sum_sorted(torch.cat([w[:, None], sxyz * w[:, None]], 1),
                            slot, n, impl=impl)
    cnt = s1[:, 0]
    denom = torch.clamp(cnt, min=1.0)
    mu = s1[:, 1:] / denom[:, None]
    # covariance from CENTRED residuals (second pass), not E[pp^T] - mu
    # mu^T, whose float32 subtraction cancels far from the origin
    d = (sxyz - mu[slot.long()]) * w[:, None]
    sdd = segment_sum_sorted((d[:, :, None] * d[:, None, :]).reshape(n, 9),
                             slot, n, impl=impl)
    cov = sdd.reshape(n, 3, 3) / denom[:, None, None]

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    vals, vecs = eigh(cov + 1e-12 * eye)
    vals = torch.maximum(vals, scalar(eigen_floor, vals)
                         * torch.clamp(vals[:, 2:], min=1e-12))
    inv_vals = 1.0 / torch.clamp(vals, min=1e-12)
    inv_cov = mm(vecs * inv_vals[:, None, :], vecs.transpose(1, 2))
    cell_valid = cnt >= float(min_points)

    ukeys = torch.full((n,), _SENT, dtype=torch.int32, device=dev)
    ukeys = ukeys.scatter_reduce(0, slot.long(),
                                 torch.where(svalid, skey, _SENT), "amin")
    return NDTMap(keys=ukeys, mu=mu, inv_cov=inv_cov,
                  valid=cell_valid & (ukeys != _SENT),
                  base=base, dims=dims, cell=cell)


def _ndt_consts(outlier_ratio, cell):
    """Magnusson's robust-mixture exponential constants d1, d2."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (cell ** 3)
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    d2 = -2.0 * torch.log((-torch.log(c1 * torch.exp(
        torch.scalar_tensor(-0.5, device=cell.device)) + c2) - d3) / d1)
    return d1, d2


def _lookup(p, mask, m: NDTMap):
    """Cell of every point of ``p`` [..., N, 3]: (table row j, hit)."""
    key, inb = _cell_keys(p, mask, m.cell, m.base, m.dims)
    j = torch.clamp(torch.searchsorted(m.keys, key.reshape(-1)),
                    max=m.keys.shape[0] - 1).reshape(key.shape)
    return j, inb & (m.keys[j] == key) & m.valid[j]


def _terms(p, j, hit, m: NDTMap, d1, d2):
    """Per-point score terms and Mahalanobis q at points ``p``."""
    dmu = p - m.mu[j]
    q = (dmu[..., :, None] * m.inv_cov[j] * dmu[..., None, :]).sum((-2, -1))
    q = torch.clamp(q, min=0.0)
    return torch.where(hit, -d1 * torch.exp(-0.5 * d2 * q), 0.0), q


def ndt_align(src: PointCloud, ndt_map: NDTMap,
              init_T: torch.Tensor | None = None,
              max_iterations: int = 35,
              transformation_epsilon: float = 1e-8,
              outlier_ratio=0.55, step_scales=None) -> ICPResult:
    """Register a cloud against an NDT map (scan-to-map localization).

    Damped Newton on the robustified score with autodiff derivatives; each
    step evaluates a fan of step scales (and three normalised gradient
    steps and zero) and keeps the best. The capture basin is about one
    cell. Returns ICPResult: ``mean_error`` is the mean Mahalanobis q over
    scoring points, ``num_inliers`` the points in a valid cell.
    """
    xyz, mask = src.xyz, src.mask
    dev = xyz.device
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init_T is None
         else init_T.to(device=dev, dtype=torch.float32))
    d1, d2 = _ndt_consts(scalar(outlier_ratio, xyz), ndt_map.cell)
    scales = [scalar(s, xyz) for s in (
        _STEP_SCALES if step_scales is None else step_scales)]
    scales = torch.stack(scales)
    gscales = torch.stack([scalar(s, xyz) for s in _GRADIENT_SCALES])
    z = torch.zeros((6,), dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    err = torch.full((), float("inf"), device=dev)
    n_in = torch.zeros((), device=dev)
    it = 0
    while it < max_iterations:
        # the lookup at the increment 0: constant under differentiation
        j, hit = _lookup(se3_apply(T, xyz), mask, ndt_map)

        def score(x, T=T, j=j, hit=hit):
            p = se3_apply(mm(_exp_se3(x), T), xyz)
            return _terms(p, j, hit, ndt_map, d1, d2)[0].sum()

        g = torch.func.grad(score)(z)
        H = torch.func.hessian(score)(z)
        # damp toward negative definite (we maximise), relative to H's
        # scale: the robustified score is tiny, an absolute floor would
        # swamp H
        lam = 1e-2 * (torch.linalg.matrix_norm(H) / 6.0 + 1e-12)
        dx = torch.linalg.solve_ex(H - lam * eye6, -g[:, None]).result[:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        gstep = g * (ndt_map.cell / (torch.linalg.vector_norm(g) + 1e-12))
        cand = torch.cat([scales[:, None] * dx[None, :],
                          gscales[:, None] * gstep[None, :],
                          z[None, :]])                         # [C, 6]
        p = se3_apply(mm(_exp_se3(cand), T), xyz)              # [C, N, 3]
        jc, hc = _lookup(p, mask, ndt_map)
        cs = _terms(p, jc, hc, ndt_map, d1, d2)[0].sum(dim=-1)
        best = torch.argmax(cs)
        bx = cand[best]
        _, q = _terms(p[best], jc[best], hc[best], ndt_map, d1, d2)
        n_hit = hc[best].sum()
        err = torch.where(hc[best], q, 0.0).sum() / torch.clamp(n_hit, min=1)
        n_in = n_hit.to(torch.float32)
        T = mm(_exp_se3(bx), T)
        delta = (bx * bx).sum()
        it += 1
        if not bool(delta > transformation_epsilon):  # the host sync
            break
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.to(torch.int32),
                     iterations=torch.full((), it, dtype=torch.int32,
                                           device=dev))


def ndt(src: PointCloud, dst: PointCloud, cell_size,
        init_T: torch.Tensor | None = None, max_iterations: int = 35,
        transformation_epsilon: float = 1e-8, min_points: int = 6,
        outlier_ratio=0.55, impl: str = "auto") -> ICPResult:
    """One-shot NDT: build the map from ``dst`` and align ``src`` to it
    (pcl::NDT's align()); for repeated localization against one scene build
    the map once with ``ndt_build`` and call ``ndt_align`` per frame.
    ``impl`` routes the map build's segment sums (K2)."""
    m = ndt_build(dst, cell_size, min_points=min_points, impl=impl)
    return ndt_align(src, m, init_T=init_T, max_iterations=max_iterations,
                     transformation_epsilon=transformation_epsilon,
                     outlier_ratio=outlier_ratio)
