"""Fixed-shape spatial search: the pcl::KdTreeFLANN public surface.

Port of ``pointcloud_stitching_tpu/ops/search.py``. Both searches are
exact sweeps: a chunk of queries against every reference (``ops/sweep.py``),
squared distances by direct differences, then the k smallest per query.

Conventions follow PCL: squared distances, results sorted ascending,
radiusSearch capped at ``max_nn``. Absent neighbours (masked points, fewer
than k valid references) come back as index -1 with distance +inf.

Ties: the JAX package merges tiles with ``lax.top_k``, which takes the
lower position first, so of equal distances the lower reference index
wins. ``torch.topk`` promises no order on ties, so the port selects on one
int64 key per pair, ``(bits of d2) << 32 | index``: distances are
non-negative, so their bit patterns sort as the values do, and the keys are
distinct.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud, scalar
from .sweep import chunk_rows


def sum_sq(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over the last axis of [..., 3], summed x, y, z in that order
    (the JAX sweeps' ``sum(d * d, -1)``)."""
    x, y, z = d.unbind(-1)
    return (x * x + y * y) + z * z


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of [..., 3] (broadcast), summed x, y, z in
    that order; elementwise, so TF32 matmuls do not touch it."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def smallest_k(d2: torch.Tensor, k: int, fill_idx: int = -1):
    """The ``k`` smallest of non-negative ``d2`` [n, m] per row, ascending,
    lower index first on ties: (d2 [n, k], idx [n, k] int32). Rows with
    fewer than ``k`` columns are padded with (+inf, ``fill_idx``)."""
    n, m = d2.shape
    kk = min(k, m)
    col = torch.arange(m, dtype=torch.int64, device=d2.device)
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | col
    key = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    best = (key >> 32).to(torch.int32).view(torch.float32)
    idx = (key & 0xFFFFFFFF).to(torch.int32)
    if kk < k:
        best = torch.cat([best, best.new_full((n, k - kk), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_full((n, k - kk), fill_idx)], 1)
    return best, idx


def knn_search(query: PointCloud, ref: PointCloud, k: int,
               exclude_self: bool = False, query_tile: int = 512,
               ref_tile: int = 1024):
    """k nearest valid ref points per valid query point.

    Returns ``(d2, idx)``, both [N, k]: squared distances ascending and
    indices into ``ref``'s padded buffer; -1 / +inf fill the slots of
    invalid queries and missing neighbours. ``exclude_self=True`` drops
    same-index matches (pass the SAME cloud as query and ref).
    """
    if query.xyz.dim() != 2 or ref.xyz.dim() != 2:
        raise ValueError("knn_search expects unbatched [N,3] clouds")
    n, m = query.xyz.shape[0], ref.xyz.shape[0]
    rows = chunk_rows(n, m, query_tile, ref_tile)
    ridx = torch.arange(m, device=ref.xyz.device)
    d2s, idxs = [], []
    for i in range(0, n, rows):
        d2 = sum_sq(query.xyz[i:i + rows, None, :] - ref.xyz[None, :, :])
        bad = ~ref.mask[None, :]
        if exclude_self:
            qidx = torch.arange(i, i + d2.shape[0], device=d2.device)
            bad = bad | (qidx[:, None] == ridx[None, :])
        d2, idx = smallest_k(torch.where(bad, float("inf"), d2), k)
        d2s.append(d2)
        idxs.append(idx)
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    qm = query.mask[:, None]
    ok = torch.isfinite(d2) & qm
    return torch.where(qm, d2, float("inf")), torch.where(ok, idx, -1)


def radius_search(query: PointCloud, ref: PointCloud, radius, max_nn: int,
                  exclude_self: bool = False, query_tile: int = 512,
                  ref_tile: int = 1024):
    """Up to ``max_nn`` valid ref points within ``radius`` of each query.

    Returns ``(d2, idx, count)``: [N, max_nn] squared distances / ref
    indices (ascending, -1 / +inf beyond ``count``) and the per-query
    neighbour count (capped at max_nn). PCL's ``max_nn=0`` ("all
    neighbours") has no fixed-shape equivalent, so max_nn < 1 raises, as in
    the JAX package. ``exclude_self`` as in knn_search.
    """
    if max_nn < 1:
        raise ValueError(
            "radius_search needs max_nn >= 1 (PCL's max_nn=0 'unlimited' "
            "has no fixed-shape equivalent; use ops.count_neighbors)")
    d2, idx = knn_search(query, ref, max_nn, exclude_self=exclude_self,
                         query_tile=query_tile, ref_tile=ref_tile)
    r = scalar(radius, d2)
    within = (idx >= 0) & (d2 <= r * r)
    return (torch.where(within, d2, float("inf")),
            torch.where(within, idx, -1),
            within.sum(dim=1, dtype=torch.int32))
