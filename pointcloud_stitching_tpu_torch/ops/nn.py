"""Brute-force nearest-neighbour correspondence search.

Port of ``pointcloud_stitching_tpu/ops/nn.py::nearest_neighbors``: the same
contract, routed to kernel K3 (``kernels/nn_pallas.py``). Its plain version
uses the kernel's direct-difference distances, not the
``|q|^2+|r|^2-2qr`` form of the JAX package's XLA sweep, so the two
backends of the port agree bit for bit. ``query_tile``/``ref_tile`` (the
JAX sweep's tiles) are taken and ignored, so callers written for the JAX
package run as they are.
"""
from __future__ import annotations

import torch

from ..kernels.nn_pallas import nearest_neighbors_pallas


def nearest_neighbors(query: torch.Tensor, ref: torch.Tensor,
                      ref_mask: torch.Tensor | None = None,
                      impl: str = "auto", query_tile: int = 1024,
                      ref_tile: int = 4096):
    """For each query point, index + squared distance of its nearest ref.

    Args:
      query: [N, 3] float32.  ref: [M, 3] float32.
      ref_mask: [M] bool; invalid reference points are never matched.
      impl: 'auto' | 'cuda' | 'torch' (see kernels.build.use_kernel).
      query_tile, ref_tile: ignored (the port's kernel has no such tiles).
    Returns:
      (idx [N] int32, d2 [N] float32).
    """
    return nearest_neighbors_pallas(query, ref, ref_mask, impl=impl)
