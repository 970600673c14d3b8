"""Exact batched 1-nearest-neighbour search: kernel K3.

Port of ``pointcloud_stitching_tpu/kernels/nn_pallas.py`` (the module keeps
the reference's name so that each function has an obvious counterpart).
``prepare_ref_batched`` masks and transposes the reference cloud once per
ICP call; ``nn_batched_prepared`` runs the search against it, launching the
hand-written kernel of ``csrc/nn.cu`` for CUDA tensors and the plain
version below for CPU tensors or ``impl="torch"``.

Contract (the TPU kernel's): squared distances by direct differences,
``((dx*dx) + dy*dy) + dz*dz`` in float32 with no ``|q|^2+|r|^2-2qr``
cancellation; masked references become the 1e12 sentinel and never match a
real point; on a tie the lowest reference index wins. The reference is not
padded (the kernel handles a ragged last tile), so ``idx < M`` holds without
the reference's clamp to ``num_ref - 1``; the direct form is non-negative,
so ``d2 >= 0`` needs no clamp either.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, check, library, stream_handle, use_kernel

_FAR = 1e12  # coordinate sentinel for invalid reference points
_PLAIN_REF_BLOCK = 1024


def prepare_ref_batched(ref: torch.Tensor,
                        ref_mask: torch.Tensor | None) -> torch.Tensor:
    """Reference [B, M, 3] (+ mask [B, M]) -> sentinel-masked [B, 3, M].

    Done once per ICP call: the reference cloud is loop-invariant."""
    if ref_mask is not None:
        ref = torch.where(ref_mask[..., None], ref, _FAR)
    return ref.transpose(1, 2).contiguous()


def _nn_plain(query: torch.Tensor, refT: torch.Tensor):
    """Plain version: sweep reference blocks with a running (best, idx),
    first index on ties within a block, strict `<` across blocks."""
    b, n, _ = query.shape
    m = refT.shape[-1]
    best = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=query.device)
    best_idx = torch.zeros((b, n), dtype=torch.int64, device=query.device)
    for j0 in range(0, m, _PLAIN_REF_BLOCK):
        r = refT[:, :, j0:j0 + _PLAIN_REF_BLOCK]              # [B, 3, mb]
        d2 = None
        for c in range(3):
            diff = query[..., c, None] - r[:, None, c, :]      # [B, N, mb]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        am = d2.argmin(dim=-1, keepdim=True)
        m_blk = d2.gather(-1, am)[..., 0]
        better = m_blk < best
        best = torch.where(better, m_blk, best)
        best_idx = torch.where(better, am[..., 0] + j0, best_idx)
    return best_idx.to(torch.int32), best


def nn_batched_prepared(query: torch.Tensor, refT: torch.Tensor,
                        impl: str = "auto"):
    """Batched NN of query [B, N, 3] against a prepared reference
    [B, 3, M] (see prepare_ref_batched). Returns (idx [B, N] int32,
    d2 [B, N] float32)."""
    if query.dim() != 3 or query.shape[-1] != 3 or refT.dim() != 3 \
            or refT.shape[1] != 3 or refT.shape[0] != query.shape[0]:
        raise ValueError(f"query {tuple(query.shape)} / refT "
                         f"{tuple(refT.shape)}: want [B, N, 3] / [B, 3, M]")
    if query.dtype != torch.float32 or refT.dtype != torch.float32:
        raise ValueError("query and refT must be float32")
    b, n, _ = query.shape
    m = refT.shape[-1]
    if m < 1:
        raise ValueError("empty reference cloud")
    if not use_kernel(impl, query):
        return _nn_plain(query, refT)

    if refT.device != query.device:
        raise ValueError("query and refT must be on one device")
    query = query.contiguous()
    refT = refT.contiguous()
    idx = torch.empty((b, n), dtype=torch.int32, device=query.device)
    d2 = torch.empty((b, n), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = library().pcs_nn_batched(
            query.data_ptr(), refT.data_ptr(), b, n, m, idx.data_ptr(),
            d2.data_ptr(), stream_handle(query))
    check(err, "nn_batched_prepared")
    LAUNCHES["nn_batched_prepared"] += 1
    return idx, d2


def nearest_neighbors_pallas_batched(query: torch.Tensor, ref: torch.Tensor,
                                     ref_mask: torch.Tensor | None = None,
                                     impl: str = "auto"):
    """Batched NN: query [B, N, 3] vs ref [B, M, 3] pairwise per batch row."""
    return nn_batched_prepared(query, prepare_ref_batched(ref, ref_mask),
                               impl=impl)


def nearest_neighbors_pallas(query: torch.Tensor, ref: torch.Tensor,
                             ref_mask: torch.Tensor | None = None,
                             impl: str = "auto"):
    """Single-pair NN: query [N, 3] vs ref [M, 3] -> (idx [N], d2 [N])."""
    idx, d2 = nearest_neighbors_pallas_batched(
        query[None], ref[None], None if ref_mask is None else ref_mask[None],
        impl=impl)
    return idx[0], d2[0]
