"""SE(3) rigid transforms on padded point clouds.

Port of ``pointcloud_stitching_tpu/ops/se3.py``. The JAX package computes
every product here at ``precision="highest"`` because the TPU's default
matmul pass rounds operands to bf16. The counterpart on an NVIDIA card is
TF32, which rounds rotation entries at about 1e-3: ``StitchingPipeline``
turns it off for matmuls and cuDNN and sets the float32 matmul precision to
"highest", so ``mm`` and ``se3_apply`` run in full float32.
"""
from __future__ import annotations

import torch

from ..utils.types import PointCloud, scalar


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul in full float32 (TF32 off; see the module docstring)."""
    return torch.matmul(a, b)


def se3_apply(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 (or batched [...,4,4]) rigid transform(s) to [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.matmul(xyz, R.transpose(-1, -2)) + t[..., None, :]


def transform_cloud(T: torch.Tensor, pc: PointCloud) -> PointCloud:
    xyz = se3_apply(T, pc.xyz)
    xyz = torch.where(pc.mask[..., None], xyz, 0.0)
    return pc.replace(xyz=xyz)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Return A @ B (apply B first, then A)."""
    return mm(A, B)


def _bottom_row(like: torch.Tensor, lead) -> torch.Tensor:
    # built on the device (no host-to-device copy, which would sync)
    row = torch.eye(4, dtype=like.dtype, device=like.device)[3:]
    return row.expand(*lead, 1, 4)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -mm(Rt, t)], dim=-1)
    return torch.cat([top, _bottom_row(T, T.shape[:-2])], dim=-2)


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(R, R.shape[:-2])], dim=-2)


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3],
    with the same series guard at theta^2 < 1e-12 as the JAX package."""
    t2 = (omega * omega).sum(dim=-1, keepdim=True)         # theta^2
    small = t2 < 1e-12
    t2s = torch.where(small, 1.0, t2)
    th = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1)], dim=-2)    # [w]_x
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + A[..., None] * K + B[..., None] * mm(K, K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3] (small angles;
    not intended near theta = pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-6, 0.5,
                        theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    return w * scale[..., None]


def se3_power(T: torch.Tensor, alpha) -> torch.Tensor:
    """Fractional power of a near-identity rigid transform (rotation via
    so3_log/so3_exp, translation scaled linearly); exact at alpha 0 and 1."""
    alpha = scalar(alpha, T)
    omega = so3_log(T[..., :3, :3])
    R = so3_exp(alpha[..., None] * omega)
    t = alpha[..., None] * T[..., :3, 3]
    return se3_from_rt(R, t)


def se3_blend(A: torch.Tensor, B: torch.Tensor, alpha) -> torch.Tensor:
    """(1-alpha)*A + alpha*B, with the rotation projected back to SO(3) by
    SVD (polar projection) and the translation blended linearly."""
    alpha = scalar(alpha, A)
    M = (1.0 - alpha) * A[..., :3, :3] + alpha * B[..., :3, :3]
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(mm(U, Vt))
    S = torch.eye(3, dtype=A.dtype, device=A.device).expand(M.shape).clone()
    S[..., 2, 2] = det
    R = mm(mm(U, S), Vt)
    t = (1.0 - alpha) * A[..., :3, 3] + alpha * B[..., :3, 3]
    return se3_from_rt(R, t)

