"""Fast Point Feature Histograms on fixed-shape clouds.

Port of ``pointcloud_stitching_tpu/ops/fpfh.py`` (the role of
``pcl::FPFHEstimation``, Rusu et al., ICRA 2009). Both passes are all-pairs
sweeps (``ops/sweep.py``):

  pass 1 (SPFH): every in-radius pair's Darboux-frame angles for a chunk
    of queries against every reference, binned into three 11-bin
    histograms. The JAX package reduces ``[qt, rt, 11]`` one-hots (a TPU
    idiom); here the 0/1 weights are added into ``[chunk, 33]`` by bin index
    with ``scatter_add_``, which is exact in any order (integer counts).
  pass 2 (weighting): FPFH_i = SPFH_i + (1/k_i) sum_j (1/d2_ij) SPFH_j, a
    masked ``[chunk, M]`` weight matrix times the ``[M, 33]`` SPFH rows.

Descriptor layout: bins [0:11] alpha, [11:22] phi, [22:33] theta; the
source endpoint of a pair is the one whose normal makes the smaller angle
with the connecting line; each 11-bin block sums to 100 (PCL's convention).

The products of pass 2 and of ``match_fpfh`` accumulate in float64 and
round to float32: never TF32, whatever the process-wide switch says (the
JAX package asks for ``precision="highest"``).
"""
from __future__ import annotations

import math

import torch

from ..utils.types import PointCloud, scalar
from .search import smallest_k, sum_sq
from .sweep import blockwise_accumulate, chunk_rows

FPFH_BINS = 11
FPFH_DIM = 3 * FPFH_BINS


def mm_fp64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float64, rounded to float32 (never TF32)."""
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def pair_angles(n_src, n_tgt, dp, d):
    """Darboux-frame pair angles for broadcastable stacks of point pairs.

    Args: n_src, n_tgt the endpoints' unit normals [..., 3]; dp = p_tgt -
    p_src [..., 3]; d = |dp| [...] (positive; the caller guards d ~ 0).

    The endpoint whose normal makes the smaller angle with the connecting
    line becomes the source (a select, not a branch). Returns (alpha, phi,
    theta, ok); ok is False for degenerate frames (line parallel to the
    source normal; the gate is on the angle |v|/d). Shared by FPFH and VFH.
    """
    a1 = (n_src * dp).sum(dim=-1) / d
    a2 = (n_tgt * dp).sum(dim=-1) / d
    swap = (a1.abs() < a2.abs())[..., None]
    ns = torch.where(swap, n_tgt, n_src)
    nt = torch.where(swap, n_src, n_tgt)
    dvec = torch.where(swap, -dp, dp)                    # source -> target
    phi = torch.where(swap[..., 0], -a2, a1)             # = ns . dvec / d

    v = torch.linalg.cross(dvec, ns, dim=-1)
    vnorm = torch.sqrt(sum_sq(v))
    ok = vnorm > 1e-5 * d
    v = v / torch.clamp(vnorm, min=1e-24)[..., None]
    w = torch.linalg.cross(ns, v, dim=-1)
    alpha = (v * nt).sum(dim=-1)
    theta = torch.atan2((w * nt).sum(dim=-1), (ns * nt).sum(dim=-1))
    return alpha, phi, theta, ok


def to_bin(x: torch.Tensor, lo: float, scale: torch.Tensor,
           bins: int) -> torch.Tensor:
    """Bin ``floor((x - lo) * scale)`` clipped to [0, bins), in float32."""
    return torch.clamp(torch.floor((x - lo) * scale).to(torch.int32),
                       0, bins - 1)


def _fpfh_bin(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # the JAX package's float32(11) / (hi - lo): a float32 division
    f32 = lambda v: torch.scalar_tensor(v, dtype=torch.float32,  # noqa: E731
                                        device=x.device)
    return to_bin(x, lo, f32(FPFH_BINS) / f32(hi - lo), FPFH_BINS)


def _pair_hist_block(q, qn, qv, r, rn, rv, r2):
    """SPFH histogram contributions of a chunk of queries against every
    reference: (hist [q, 33] raw bin counts over in-radius, non-degenerate
    pairs, k [q] count of contributing pairs)."""
    dp = r[None, :, :] - q[:, None, :]                   # [q, M, 3]
    d2 = sum_sq(dp)
    d = torch.sqrt(torch.clamp(d2, min=1e-24))
    inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]
    alpha, phi, theta, ok = pair_angles(qn[:, None, :], rn[None, :, :],
                                        dp, d)
    wgt = (ok & inside).to(torch.float32)
    bins = torch.stack([
        _fpfh_bin(alpha, -1.0, 1.0),
        _fpfh_bin(phi, -1.0, 1.0) + FPFH_BINS,
        _fpfh_bin(theta, -math.pi, math.pi) + 2 * FPFH_BINS,
    ], dim=-1).reshape(q.shape[0], -1)
    hist = torch.zeros((q.shape[0], FPFH_DIM), dtype=torch.float32,
                       device=q.device)
    hist.scatter_add_(1, bins.long(),
                      wgt[..., None].expand(-1, -1, 3).reshape(
                          q.shape[0], -1))
    return hist, wgt.sum(dim=1)


def fpfh(pc: PointCloud, normals: torch.Tensor,
         normals_valid: torch.Tensor | None = None, radius=0.25,
         min_neighbors=3, query_tile: int = 256, ref_tile: int = 512):
    """33-dim FPFH descriptor per point (pcl::FPFHEstimation role).

    Args:
      pc: cloud [N, 3] + mask (a voxel skeleton at registration scale).
      normals: [N, 3] unit normals; ``normals_valid`` [N] optional: points
        without a valid normal neither get a descriptor nor contribute.
      radius: feature radius in metres (larger than the normal radius).
      min_neighbors: descriptors supported by fewer contributing pairs are
        invalid.

    Returns (desc [N, 33] float32, each 11-bin block summing to 100 for
    valid points and zeros elsewhere, valid [N]).
    """
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    r2 = scalar(radius, pc.xyz) ** 2

    spfh, k = blockwise_accumulate(
        pc.xyz, valid, [normals], query_tile, ref_tile,
        lambda q, qv, qe, r, rv, re: _pair_hist_block(
            q, qe[0], qv, r, re[0], rv, r2))

    def weight_step(q, qv, qe, r, rv, re):
        spfh_all, k_all = re
        d2 = sum_sq(r[None, :, :] - q[:, None, :])
        inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]
        w = torch.where(inside, 1.0 / torch.clamp(d2, min=1e-12), 0.0)
        # neighbours' SPFH enter pre-normalised (PCL divides each by its
        # own pair count), so sparse and dense neighbours weigh equally
        nrm = spfh_all / torch.clamp(k_all, min=1.0)[:, None]
        return mm_fp64(w, nrm), inside.sum(dim=1).to(torch.float32)

    wsum, kn = blockwise_accumulate(pc.xyz, valid, [spfh, k], query_tile,
                                    ref_tile, weight_step)
    desc = (spfh / torch.clamp(k, min=1.0)[:, None]
            + wsum / torch.clamp(kn, min=1.0)[:, None])
    ok = valid & (k >= min_neighbors)
    d3 = desc.reshape(-1, 3, FPFH_BINS)
    s = d3.sum(dim=-1, keepdim=True)
    d3 = torch.where(s > 0, 100.0 * d3 / torch.clamp(s, min=1e-12), 0.0)
    return torch.where(ok[:, None], d3.reshape(-1, FPFH_DIM), 0.0), ok


def match_fpfh(desc_a: torch.Tensor, ok_a: torch.Tensor,
               desc_b: torch.Tensor, ok_b: torch.Tensor, k: int = 1,
               query_tile: int = 512, ref_tile: int = 1024):
    """k nearest descriptors in B for every descriptor in A.

    d2 = |a|^2 + |b|^2 - 2 a.b, the cross term accumulated in float64.
    Invalid B rows never match; slots left unmatched (fewer than k valid B
    rows) hold index 0 and the 1e12 sentinel, as the JAX package's running
    top-k leaves them; invalid A rows get the sentinel distance. Of equal
    distances the lower index comes first.

    Returns (idx [N, k] int32 into B, d2 [N, k] ascending).
    """
    n, m = desc_a.shape[0], desc_b.shape[0]
    far = 1e12
    rows = chunk_rows(n, m, query_tile, ref_tile, width=desc_a.shape[1])
    b_sq = (desc_b * desc_b).sum(dim=-1)
    d2s, idxs = [], []
    for i in range(0, n, rows):
        q = desc_a[i:i + rows]
        q_sq = (q * q).sum(dim=-1)
        d2 = q_sq[:, None] + b_sq[None, :] - 2.0 * mm_fp64(q, desc_b.T)
        d2 = torch.where(ok_b[None, :], torch.clamp(d2, min=0.0), far)
        d2, idx = smallest_k(d2, k, fill_idx=0)
        unmatched = d2 >= far
        d2s.append(torch.where(unmatched, far, d2))
        idxs.append(torch.where(unmatched, 0, idx))
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    return idx, torch.where(ok_a[:, None], d2, far)
