"""Weighted Kabsch / Umeyama rigid alignment via SVD.

Port of ``pointcloud_stitching_tpu/ops/kabsch.py``, batched over leading
dimensions (the JAX package vmaps it).
"""
from __future__ import annotations

import torch

from .se3 import mm, se3_from_rt


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Best-fit rigid transform [..., 4, 4] minimising
    sum_i w_i |T*src_i - dst_i|^2 over [..., N, 3] correspondences.

    Returns identity where the total weight is ~0 (all correspondences
    rejected), so a streaming ICP step never produces NaN.
    """
    w = weights.to(torch.float32)
    wsum = w.sum(dim=-1)
    safe = wsum > 1e-6
    denom = torch.where(safe, wsum, 1.0)[..., None]
    cs = (w[..., None] * src).sum(dim=-2) / denom
    cd = (w[..., None] * dst).sum(dim=-2) / denom
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", w[..., None] * s, d)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(mm(V, Ut))
    S = torch.eye(3, dtype=torch.float32, device=src.device).expand(
        H.shape).clone()
    S[..., 2, 2] = det
    R = mm(mm(V, S), Ut)
    t = cd - mm(R, cs[..., None])[..., 0]
    T = se3_from_rt(R, t)
    eye = torch.eye(4, dtype=torch.float32, device=src.device)
    return torch.where(safe[..., None, None], T, eye)
