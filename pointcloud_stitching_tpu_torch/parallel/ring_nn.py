"""Cross-rank nearest-neighbour search: the reference shards go round a ring.

Port of ``pointcloud_stitching_tpu/parallel/ring_nn.py`` (the point-cloud
analogue of ring attention: the scaling axis is the point count). When a
reference cloud is too large for one device, or is sharded with the rest
of the pipeline, the O(N*M) search decomposes blockwise:

  * queries stay where they are, sharded over the mesh (N/D per rank);
  * the reference shard goes one step round the ring (rank i to i + 1)
    after each of the first D - 1 steps;
  * each rank keeps a running (best_d2, best_idx) over the shards it has
    seen, a strict ``<`` keeping the earlier shard on a tie, in the
    reference's visiting order (rank r sees shard r, r-1, ..., r+1), so
    ties across shards resolve as in JAX; global indices are offset by
    the source shard's base.

Each step is the single-device search (K3), so per-rank compute is that
of the unsharded case, D launches of it.
"""
from __future__ import annotations

import torch

from ..ops.nn import nearest_neighbors
from .collectives import check_axis, ring_shift


def ring_nearest_neighbors(query: torch.Tensor, ref: torch.Tensor,
                           ref_mask: torch.Tensor, mesh, axis: str = "cam",
                           query_tile: int = 1024, ref_tile: int = 4096,
                           impl: str = "auto"):
    """NN with both query and reference sharded over ``mesh`` along dim 0.

    Args:
      query: [N/D, 3] this rank's queries.
      ref: [M/D, 3] this rank's reference shard (rank r holds global rows
        r·M/D ... (r+1)·M/D - 1; every rank's shard has the same size).
      ref_mask: [M/D] bool.
      query_tile, ref_tile: ignored (the port's kernel has no such tiles).
      impl: 'auto' | 'cuda' | 'torch' (see kernels.build.use_kernel).
    Returns (idx [N/D] int32 into the global ref, d2 [N/D] f32) for this
    rank's queries.
    """
    check_axis(mesh, axis)
    d, my = mesh.size(), mesh.get_local_rank()
    m_shard = ref.shape[0]
    best_d2 = torch.full((query.shape[0],), float("inf"),
                         dtype=torch.float32, device=query.device)
    best_idx = torch.zeros((query.shape[0],), dtype=torch.int32,
                           device=query.device)
    r_cur, rm_cur = ref, ref_mask
    for step in range(d):
        src = (my - step) % d          # the shard held at this step
        idx, dd = nearest_neighbors(query, r_cur, rm_cur, impl=impl)
        better = dd < best_d2
        best_d2 = torch.where(better, dd, best_d2)
        best_idx = torch.where(better, idx + src * m_shard, best_idx)
        if step + 1 < d:
            # ring shift of the reference shard: M/D x 13 B per step
            r_cur = ring_shift(r_cur, mesh, 1)
            rm_cur = ring_shift(rm_cur, mesh, 1)
    return best_idx, torch.clamp(best_d2, min=0.0)
