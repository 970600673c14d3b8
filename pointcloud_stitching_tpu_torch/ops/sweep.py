"""Shared all-pairs sweep: chunks of queries against every reference.

Port of ``pointcloud_stitching_tpu/ops/sweep.py``. The JAX package sweeps
one ``[query_tile x ref_tile]`` block at a time (a ``lax.map`` over query
tiles around a ``fori_loop`` over reference tiles) and adds the blocks up.
Eager PyTorch pays several launches per block, and at registration scale
(113k points, 512 x 1024 tiles) that is some 24,000 blocks. Here a chunk of
queries meets every reference at once, so the sum over references is one
reduction inside ``step`` and a sweep costs a few launches per chunk.

``query_tile`` and ``ref_tile`` keep their roles: a chunk holds as many
queries as keep its ``[chunk, M, ...]`` intermediates within
``CHUNK_TILES`` of the JAX package's tiles, and the references are padded
(masked) to a multiple of ``ref_tile``, the block that ``outer_sum``'s
batched products sum before the blocks are added. Results then depend on
the tiling only through the float32 order of the sums.
"""
from __future__ import annotations

import torch

# pairs of one chunk, in tiles of query_tile x ref_tile pairs: 64 tiles of
# 512 x 1024 keep a chunk's [chunk, M, 3] float32 intermediates near 400 MB
CHUNK_TILES = 64


def chunk_rows(n: int, m: int, query_tile: int, ref_tile: int,
               width: int = 1) -> int:
    """Queries per chunk: at least one, at most ``n``, and at most
    ``query_tile * ref_tile * CHUNK_TILES`` pairs of ``width`` channels."""
    pairs = query_tile * ref_tile * CHUNK_TILES
    return max(1, min(n, pairs // max(m * width, 1)))


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])])


def blockwise_accumulate(xyz: torch.Tensor, valid: torch.Tensor, extras,
                         query_tile: int, ref_tile: int, step):
    """Every query against every reference, ``step``'s results per query.

    ``extras`` tensors (leading dim N) ride along, sliced to the query
    chunk and given whole as the references' extras; ``step`` maps
    (q, qv, q_extras, r, rv, r_extras) -> a tensor or a tuple of tensors of
    [chunk, ...] accumulators summed over the references. The references
    are padded with invalid rows (zeros) to a multiple of
    ``min(ref_tile, N)``. Returns the same structure with leading dim N.
    """
    n = xyz.shape[0]
    rt = min(ref_tile, n)
    m = -(-n // rt) * rt
    r, rv = _pad_rows(xyz, m), _pad_rows(valid, m)
    re = [_pad_rows(e, m) for e in extras]
    rows = chunk_rows(n, m, query_tile, ref_tile)
    parts = []
    for i in range(0, n, rows):
        sl = slice(i, i + rows)
        parts.append(step(xyz[sl], valid[sl], [e[sl] for e in extras],
                          r, rv, re))
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def outer_sum(a: torch.Tensor, b: torch.Tensor, block: int) -> torch.Tensor:
    """sum_r a[q, r, :]^T b[q, r, :] for [q, M, k] inputs, M a multiple of
    ``block``: [q, k, k].

    The JAX package's ``einsum("qr,qri,qrj->qij")`` with the weights folded
    into ``a``, as batched products of ``block`` references each, summed
    after: one product over all M would give cuBLAS one tile per query
    marching along M (2.1 of the 3.4 s of a 113k-point normals sweep on an
    H100, ``scripts/profile_extras.py``).
    """
    q, m, k = a.shape
    nb = m // block
    prod = torch.bmm(a.reshape(q * nb, block, k).transpose(1, 2),
                     b.reshape(q * nb, block, k))
    return prod.reshape(q, nb, k, k).sum(dim=1)
