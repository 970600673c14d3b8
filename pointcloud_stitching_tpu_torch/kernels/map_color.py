"""Texture-mapped colour for every camera of a frame set in one launch.

The CUDA route of ``ops/deproject.py::map_color`` (``csrc/map_color.cu``,
kernel ``map_color_kernel``). It replaces no TPU kernel: the JAX package
maps colour with plain ``jnp``, and the port's plain version is the torch
composition in ``ops/deproject.py::map_color``, which CPU tensors and
``impl='torch'`` take. On the card the composition writes a float32 copy
of every colour frame each frame before it gathers from it; the kernel
reads each point's three bytes from the ``uint8`` frame itself.

The kernel forms ``u = rint(fma(x / z, fx, ppx))`` as the composition's
``torch.addcmul`` and ``torch.round`` do. The composition's transform is a
cuBLAS matmul whose summation order is not the kernel's, so the two may
differ in the last bit of a point's colour-frame position and so pick the
neighbouring pixel, but only where ``u`` or ``v`` lies on a half pixel.
Each camera's distortion model (``DistortionModel``: none, Brown-Conrady
or inverse Brown-Conrady, mixed across cameras) is applied as
``project`` applies it, operation by operation.
"""
from __future__ import annotations

import torch

from ..utils.types import DistortionModel, Intrinsics
from .build import LAUNCHES, check, library, stream_handle


def map_color_cuda(xyz: torch.Tensor, mask: torch.Tensor,
                   color: torch.Tensor, color_intr: Intrinsics,
                   depth_to_color: torch.Tensor) -> torch.Tensor:
    """Each point's colour [..., N, 3] float32 from CUDA tensors: points
    ``xyz`` [..., N, 3] float32 in the depth frame, ``mask`` [..., N]
    bool, colour frames ``color`` [..., Hc, Wc, 3] uint8, the colour
    intrinsics (fields broadcast against the leading dims) and the
    depth→colour extrinsics ``depth_to_color`` [..., 4, 4]. A point that is
    masked, behind the colour sensor or outside its frame gets 0."""
    if xyz.dtype != torch.float32 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz: want float32 [..., N, 3], got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    batch, n = xyz.shape[:-2], xyz.shape[-2]
    if mask.dtype != torch.bool or mask.shape != xyz.shape[:-1]:
        raise ValueError(f"mask: want bool {tuple(xyz.shape[:-1])}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if color.dtype != torch.uint8 or color.shape[:-3] != batch or \
            color.shape[-1] != 3:
        raise ValueError(f"color: want uint8 [{', '.join(map(str, batch))}"
                         f"{', ' if batch else ''}Hc, Wc, 3], got "
                         f"{color.dtype} {tuple(color.shape)}")
    dev = xyz.device
    if any(t.device != dev for t in (mask, color, depth_to_color)):
        raise ValueError("xyz, mask, color and depth_to_color must be on "
                         "one device")
    hc, wc = color.shape[-3], color.shape[-2]
    ncam = batch.numel()

    def per_camera(t, tail=(), dtype=torch.float32):
        # no copy where the field is already [*batch, *tail] of dtype
        return t.to(device=dev, dtype=dtype).expand(
            *batch, *tail).reshape(ncam, *tail).contiguous()

    ext = per_camera(depth_to_color, (4, 4))
    fx, fy, ppx, ppy = (per_camera(f) for f in (
        color_intr.fx, color_intr.fy, color_intr.ppx, color_intr.ppy))
    coeffs = per_camera(color_intr.coeffs, (5,))
    # one model for every camera rides as a scalar: no tensor to make
    mixed = color_intr.model == int(DistortionModel.MIXED)
    model_ids = (per_camera(color_intr.model_ids, dtype=torch.int32)
                 if mixed else None)
    xyz, mask, color = xyz.contiguous(), mask.contiguous(), color.contiguous()
    rgb = torch.empty((*batch, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_map_color(
            xyz.data_ptr(), mask.data_ptr(), color.data_ptr(), ext.data_ptr(),
            fx.data_ptr(), fy.data_ptr(), ppx.data_ptr(), ppy.data_ptr(),
            coeffs.data_ptr(),
            None if model_ids is None else model_ids.data_ptr(),
            -1 if mixed else color_intr.model, ncam, n, hc, wc,
            rgb.data_ptr(), stream_handle(xyz))
    check(err, "map_color")
    LAUNCHES["map_color"] += 1
    return rgb
