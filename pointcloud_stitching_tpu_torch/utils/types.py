"""Core data types of the PyTorch port.

Mirrors ``pointcloud_stitching_tpu/utils/types.py``: point clouds are
fixed-capacity padded buffers with a validity mask, and intrinsics follow
librealsense's ``rs2_intrinsics`` (fx, fy, ppx, ppy plus five Brown–Conrady
coefficients). Both are small dataclasses of tensors; ``width``, ``height``
and ``model`` stay plain Python ints because they change the program (the
shapes and the distortion branch), as they are static in the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class DistortionModel(enum.IntEnum):
    """Distortion models, matching librealsense's rs2_distortion semantics."""

    NONE = 0
    BROWN_CONRADY = 1          # forward model: distort during projection
    INVERSE_BROWN_CONRADY = 2  # forward model applied during deprojection
    # a camera batch that mixes the models above; the per-camera ids ride
    # in Intrinsics.model_ids and deprojection selects per camera
    MIXED = -1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a float32 tensor on ``like``'s
    device. A Python number is filled in on the device: copying it from the
    host would wait for the device's queue to drain."""
    if torch.is_tensor(x):
        return x.to(dtype=torch.float32, device=like.device)
    return torch.scalar_tensor(float(x), dtype=torch.float32,
                               device=like.device)


@dataclasses.dataclass
class Intrinsics:
    """Pinhole + Brown–Conrady intrinsics for one camera or a camera batch."""

    fx: torch.Tensor
    fy: torch.Tensor
    ppx: torch.Tensor
    ppy: torch.Tensor
    coeffs: torch.Tensor  # [..., 5] Brown–Conrady: k1, k2, p1, p2, k3
    # per-camera int32 distortion ids, only when model == MIXED
    model_ids: Optional[torch.Tensor] = None
    width: int = 848
    height: int = 480
    model: int = int(DistortionModel.NONE)

    @classmethod
    def create(cls, fx, fy, ppx, ppy, coeffs=None, width=848, height=480,
               model=DistortionModel.NONE, device=None) -> "Intrinsics":
        if coeffs is None:
            coeffs = torch.zeros((5,), dtype=torch.float32)
        return cls(fx=_f32(fx, device), fy=_f32(fy, device),
                   ppx=_f32(ppx, device), ppy=_f32(ppy, device),
                   coeffs=_f32(coeffs, device), width=int(width),
                   height=int(height), model=int(model))

    @classmethod
    def d435_default(cls, width=848, height=480, device=None) -> "Intrinsics":
        """Nominal D435 848x480 depth intrinsics (typical factory values)."""
        return cls.create(fx=425.0, fy=425.0, ppx=width / 2.0,
                          ppy=height / 2.0, width=width, height=height,
                          device=device)

    def stack(self, others: list["Intrinsics"]) -> "Intrinsics":
        """Stack per-camera intrinsics into a batched Intrinsics (leading
        axis). Cameras may mix distortion models (the result is MIXED with
        per-camera model_ids); resolutions must match."""
        all_i = [self, *others]
        if any(i.width != self.width or i.height != self.height
               for i in all_i):
            raise ValueError(
                "stacked cameras must share width/height (pad mixed-"
                "resolution rigs to a common shape first)")
        models = [i.model for i in all_i]
        if any(m == int(DistortionModel.MIXED) for m in models):
            raise ValueError("cannot re-stack an already-MIXED Intrinsics")
        mixed = len(set(models)) > 1
        dev = self.fx.device
        return Intrinsics(
            fx=torch.stack([i.fx for i in all_i]),
            fy=torch.stack([i.fy for i in all_i]),
            ppx=torch.stack([i.ppx for i in all_i]),
            ppy=torch.stack([i.ppy for i in all_i]),
            coeffs=torch.stack([i.coeffs for i in all_i]),
            model_ids=(torch.tensor(models, dtype=torch.int32, device=dev)
                       if mixed else None),
            width=self.width, height=self.height,
            model=(int(DistortionModel.MIXED) if mixed else self.model))

    def replace(self, **changes) -> "Intrinsics":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Intrinsics":
        return self.replace(
            fx=self.fx.to(device), fy=self.fy.to(device),
            ppx=self.ppx.to(device), ppy=self.ppy.to(device),
            coeffs=self.coeffs.to(device),
            model_ids=(None if self.model_ids is None
                       else self.model_ids.to(device)))


@dataclasses.dataclass
class PointCloud:
    """Fixed-capacity padded point cloud.

    xyz:  [..., N, 3] float32 (meters)
    rgb:  [..., N, 3] float32 in [0, 255] or None
    mask: [..., N]    bool — True where the slot holds a real point
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    rgb: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1, dtype=torch.int32)

    def replace(self, **changes) -> "PointCloud":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_points(cls, xyz, rgb=None, capacity: Optional[int] = None,
                    device=None) -> "PointCloud":
        """Build a cloud from a dense [N,3] array, padding to ``capacity``."""
        xyz = _f32(xyz, device)
        n = xyz.shape[-2]
        cap = capacity or n
        pad = cap - n
        if pad < 0:
            raise ValueError(f"capacity {cap} < point count {n}")
        dev = xyz.device
        mask = torch.cat([torch.ones((n,), dtype=torch.bool, device=dev),
                          torch.zeros((pad,), dtype=torch.bool, device=dev)])
        zeros = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        xyz = torch.cat([xyz, zeros], dim=-2)
        if rgb is not None:
            rgb = torch.cat([_f32(rgb, dev), zeros], dim=-2)
        return cls(xyz=xyz, mask=mask, rgb=rgb)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
