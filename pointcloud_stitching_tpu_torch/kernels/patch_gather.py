"""Brick-local image gather for the TSDF integrator: kernel K5.

Port of ``pointcloud_stitching_tpu/kernels/patch_gather.py``. The TSDF
integrator reads one image plane (depth, or colour packed into one plane)
at the pixel each voxel of an 8³ brick projects to. The TPU kernel DMAs a
128×256 window per brick into VMEM and selects from it with one-hot MXU
products, because Mosaic has no vector gather; on a GPU each thread reads
its pixel directly (``csrc/patch_gather.cu``), and the window survives
only as the contract: starts aligned down to 8 rows / 128 columns and
clamped, local indices relative to the caller's unaligned starts, and 0.0
for anything outside the aligned window or the image. The bf16 limb modes
of the TPU kernel have no counterpart: a gather copies the float32 value.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, check, library, stream_handle, use_kernel

_WV = 128          # window rows (v); start aligned down to 8
_WU = 256          # window cols (u); start aligned down to 128
_BVOX = 512        # voxels per 8³ brick
# spans a brick may cover and still fit a window after start alignment:
# v0 aligns down by <= 7 rows, u0 by <= 127 cols
SPAN_V = _WV - 8
SPAN_U = _WU - 128


def _patch_gather_plain(img, v0, u0, iv, iu):
    """Plain version: the kernel's formula with torch ops."""
    H, W = img.shape
    hp = max(512, -(-H // 8) * 8)
    wp = max(1024, -(-W // 128) * 128)
    v0a = torch.clamp(v0 - torch.remainder(v0, 8), 0, hp - _WV)
    u0a = torch.clamp(u0 - torch.remainder(u0, 128), 0, wp - _WU)
    ivl = iv + (v0 - v0a)[:, None]
    iul = iu + (u0 - u0a)[:, None]
    r = v0a[:, None] + ivl
    c = u0a[:, None] + iul
    ok = ((ivl >= 0) & (ivl < _WV) & (iul >= 0) & (iul < _WU)
          & (r < H) & (c < W))
    val = img[torch.clamp(r, 0, H - 1), torch.clamp(c, 0, W - 1)]
    return torch.where(ok, val, 0.0)


def patch_gather(img: torch.Tensor, v0: torch.Tensor, u0: torch.Tensor,
                 iv: torch.Tensor, iu: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """img[v0[b] + iv[b, k], u0[b] + iu[b, k]] for brick-grouped indices.

    Args:
      img: [H, W] float32.
      v0/u0: [NB] int32 window starts (any values: aligned down to 8/128
        and clamped as the TPU kernel does; the local indices stay
        relative to these unaligned starts).
      iv/iu: [NB, 512] int32 local indices. Entries outside the aligned
        window, or on a pixel outside the image, read 0.0; entries in the
        alignment slop (slightly negative indices that the aligned-down
        window still covers) read the real pixel, so callers gate the
        voxels they do not want (the integrator gates on pix_ok).
      impl: 'auto' launches the CUDA kernel for a CUDA tensor and takes the
        plain version for a CPU tensor; 'cuda' and 'torch' force one.

    Returns [NB, 512] float32, bit for bit the gathered values.
    """
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img: want float32 [H, W], got {img.dtype} "
                         f"{tuple(img.shape)}")
    nb = v0.shape[0]
    for name, a, shape in (("v0", v0, (nb,)), ("u0", u0, (nb,)),
                           ("iv", iv, (nb, _BVOX)), ("iu", iu, (nb, _BVOX))):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"{name}: want int32 {list(shape)}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if not use_kernel(impl, img):
        return _patch_gather_plain(img, v0, u0, iv, iu)

    if any(a.device != img.device for a in (v0, u0, iv, iu)):
        raise ValueError("img, v0, u0, iv and iu must be on one device")
    if nb == 0:  # nothing to launch
        return img.new_zeros((0, _BVOX))
    img, v0, u0 = img.contiguous(), v0.contiguous(), u0.contiguous()
    iv, iu = iv.contiguous(), iu.contiguous()
    out = torch.empty((nb, _BVOX), dtype=torch.float32, device=img.device)
    H, W = img.shape
    with torch.cuda.device(img.device):
        err = library().pcs_patch_gather(
            img.data_ptr(), H, W, v0.data_ptr(), u0.data_ptr(),
            iv.data_ptr(), iu.data_ptr(), nb, out.data_ptr(),
            stream_handle(img))
    check(err, "patch_gather")
    LAUNCHES["patch_gather"] += 1
    return out
