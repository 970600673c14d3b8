"""Voxel-grid downsampling with fixed-capacity output.

Port of ``pointcloud_stitching_tpu/ops/voxel.py`` (``pcl::VoxelGrid``
semantics; the numpy oracle in tests/oracle.py is the contract):

  * per-axis voxel index  ijk = floor(p * (1/leaf)) - floor(min_p * (1/leaf))
  * one output point per occupied voxel = centroid of its points
  * output ordered by ascending (ix, iy, iz)

Uniquing is sort-based: sort by voxel key (``torch.sort``, a library op,
as the JAX package leaves its sort to XLA), flag the run starts, then one
segment sum per run (kernel K1 for one cloud, K2 for a camera batch
flattened into one id range). Two branches, chosen per call exactly as in
the JAX package:

  * packed: when the scene fits 2^30 cells, 65536 per axis, and
    leaf <= 0.03 m, sort one int32 linearised key with 3x10-bit quantised
    in-voxel offsets as payload; every summed channel is a small integer,
    so the sums are exact and the centroid is quantised at leaf/2048. One
    cloud goes through ``segment_sum_packed`` (on a card: the pack kernel,
    the sort and K1, which builds the rows itself); a camera batch through
    ``packed_rows``' composition and K2. The format, its words and their
    decoding (``finalize_packed``) live in ``kernels/segment_reduce.py``;
  * exact: sort the (packed (ix, iy), iz) key pair — built here as one
    int64 key (k1 << 32) | kz — with the float coordinates as payload.

The branch choice is a Python ``if`` on a 0-d device bool: one host sync
per voxel pass (the JAX package's ``lax.cond`` has none). Where the leaf is
a Python number above 3 cm the packed branch cannot be taken, so the pass
takes the exact branch without the sync (``packed_impossible``).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..kernels.segment_reduce import SENTINEL as _SENTINEL
from ..kernels.segment_reduce import (finalize_packed, packed_rows,
                                      run_starts, segment_sum_from_flags,
                                      segment_sum_packed, segment_sum_sorted)
from ..utils.profiling import annotate
from ..utils.types import PointCloud, scalar

_PACK_MAX_LEAF = 0.03
_PACK_MAX_CELLS = float(2 ** 30)


def packed_impossible(leaf) -> bool:
    """True when the host knows, without reading the device, that the
    packed branch is out: ``leaf`` is a Python number whose float32 value
    (the one the device compares) is above ``_PACK_MAX_LEAF``. A tensor
    leaf, or a leaf of 3 cm or less, needs the scene's extents."""
    return (isinstance(leaf, numbers.Real) and not torch.is_tensor(leaf)
            and bool(np.float32(leaf) > np.float32(_PACK_MAX_LEAF)))


def voxel_indices(xyz: torch.Tensor, mask: torch.Tensor, leaf):
    """Per-axis int32 voxel indices (PCL convention), sentinel for invalid."""
    return _indices_and_min(xyz, mask, 1.0 / scalar(leaf, xyz))[0]


def _indices_and_min(xyz: torch.Tensor, mask: torch.Tensor,
                     inv: torch.Tensor):
    """``voxel_indices`` at ``inv`` = 1 / leaf, and the valid points' least
    floor(xyz * inv) per axis ([..., 1, 3], sentinel where none is valid)."""
    f = torch.floor(xyz * inv).to(torch.int32)
    fm = torch.where(mask[..., None], f, _SENTINEL)
    min_ijk = fm.amin(dim=-2, keepdim=True)
    ijk = f - min_ijk
    return torch.where(mask[..., None], ijk, _SENTINEL), min_ijk


def _extents(ijk: torch.Tensor) -> torch.Tensor:
    """Per-axis occupied extent (nx, ny, nz) of sentinel-masked indices."""
    valid = ijk[..., 0] != _SENTINEL
    mx = torch.where(valid[..., None], ijk, -1).amax(dim=-2)
    return mx + 1  # all-invalid cloud -> extent 0


def _sorted_segments(pc: PointCloud, leaf):
    """Exact sort by the (packed (ix, iy), iz) key pair; returns (flags,
    vals [..., N, 4 or 7]) with channels [x, y, z, 1] (+ [r, g, b])."""
    xyz, mask = pc.xyz, pc.mask
    ijk = voxel_indices(xyz, mask, leaf)
    # pack (ix, iy) into one key, clamped as in the JAX package
    kx = torch.clamp(ijk[..., 0], max=32766)
    ky = torch.clamp(ijk[..., 1], max=65534)
    kz = ijk[..., 2]
    k1 = torch.where(ijk[..., 0] == _SENTINEL, _SENTINEL, kx * 65536 + ky)
    # lexicographic (k1, kz) as one int64 key; both halves are >= 0
    key = (k1.to(torch.int64) << 32) | kz.to(torch.int64)
    skey, perm = torch.sort(key, dim=-1)
    idx3 = perm[..., None].expand(*perm.shape, 3)
    sxyz = xyz.gather(-2, idx3)

    valid = (skey >> 32) != _SENTINEL
    flags = run_starts(skey, valid)
    chans = [sxyz, torch.ones_like(sxyz[..., :1])]
    if pc.rgb is not None:
        chans.append(pc.rgb.gather(-2, idx3))
    vals = torch.cat(chans, dim=-1)
    vals = torch.where(valid[..., None], vals, 0.0)
    return flags, vals


def _finalize(sums: torch.Tensor, has_rgb: bool) -> PointCloud:
    counts = sums[..., 3]
    out_mask = counts > 0.0
    denom = torch.clamp(counts, min=1.0)[..., None]
    out_xyz = torch.where(out_mask[..., None], sums[..., :3] / denom, 0.0)
    out_rgb = None
    if has_rgb:
        out_rgb = torch.where(out_mask[..., None], sums[..., 4:7] / denom, 0.0)
    return PointCloud(xyz=out_xyz, mask=out_mask, rgb=out_rgb)


def _flags_to_seg(flags: torch.Tensor, capacity: int) -> torch.Tensor:
    """Boundary flags -> nondecreasing segment ids in [-1, capacity]: rows
    before the first flag get -1, ids past the last slot the discard id
    capacity."""
    seg = torch.cumsum(flags.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    return torch.clamp(seg, max=capacity)


def _reduce_batched(flags, vals, capacity: int, impl: str):
    """Flat K2 pass over a camera batch: cloud b owns ids
    [b*(capacity+1), b*(capacity+1) + capacity], the last its discard.

    The flat ids do not decrease, as K2 needs. Only a cloud with no valid
    point has rows before its first flag; their id -1 lands in the previous
    cloud's discard slot (or drops, for cloud 0), and their values are 0."""
    b, n = flags.shape
    ch = vals.shape[-1]
    seg = _flags_to_seg(flags, capacity)
    offs = (torch.arange(b, dtype=torch.int32, device=seg.device)
            * (capacity + 1))[:, None]
    seg_flat = (seg + offs).reshape(-1)
    sums = segment_sum_sorted(vals.reshape(b * n, ch), seg_flat,
                              b * (capacity + 1), impl=impl)
    return sums.reshape(b, capacity + 1, ch)[:, :capacity]


def voxel_downsample(pc: PointCloud, leaf, capacity: int,
                     impl: str = "auto", interpret: bool = False,
                     packed: str = "auto") -> PointCloud:
    """Downsample to one centroid per occupied voxel; output padded to
    ``capacity`` (voxels past capacity drop, in sort order).

    Args:
      pc: PointCloud with xyz [N, 3] or camera-batched [B, N, 3] (+mask).
      leaf: voxel edge in meters (Python float or 0-d tensor).
      capacity: per-cloud output size.
      impl: 'auto' | 'cuda' | 'torch' segment-sum backend.
      interpret: taken at the JAX package's position and ignored (Pallas's
        interpreter; the port's CPU path is the kernel's plain version).
      packed: 'auto' picks the packed branch when it is exact enough (see
        the module docstring); 'never' forces the exact branch.
    """
    if packed not in ("auto", "never"):
        raise ValueError(f"unknown packed mode {packed!r}")
    batched = pc.xyz.dim() == 3

    def reduce_fn(flags, vals):
        if batched:
            return _reduce_batched(flags, vals, capacity, impl)
        return segment_sum_from_flags(vals, flags, capacity, impl=impl)

    has_rgb = pc.rgb is not None
    if packed == "auto" and not packed_impossible(leaf):
        inv = 1.0 / scalar(leaf, pc.xyz)
        ijk, min_ijk = _indices_and_min(pc.xyz, pc.mask, inv)
        ext = _extents(ijk)
        cells = ext.to(torch.float32).prod(dim=-1)
        # per-axis bound <= 2^16 keeps the index channels exact
        fits = ((cells <= _PACK_MAX_CELLS).all() & (ext <= 65536).all()
                & (scalar(leaf, pc.xyz) <= _PACK_MAX_LEAF))
        if has_rgb:
            # pack only when lossless: 8-bit integer colours
            fits = fits & (pc.rgb == torch.round(pc.rgb)).all() \
                & ((pc.rgb >= 0) & (pc.rgb <= 255)).all()
        with annotate("pcs.sync"):
            fits = bool(fits)  # the one host sync of the pass
        if fits:
            dims = torch.clamp(ext, min=1)
            if batched:
                sums = _reduce_batched(*packed_rows(
                    pc.xyz, pc.mask, pc.rgb, inv, min_ijk, dims), capacity,
                    impl)
            else:
                sums = segment_sum_packed(pc.xyz, pc.mask, pc.rgb, inv,
                                          min_ijk, dims, capacity, impl=impl)
            return finalize_packed(sums, min_ijk, leaf, has_rgb)
    flags, vals = _sorted_segments(pc, leaf)
    return _finalize(reduce_fn(flags, vals), has_rgb)


def decimate_depth(depth: torch.Tensor, stride: int) -> torch.Tensor:
    """Grid-stride decimation of a depth image before deprojection."""
    if stride <= 1:
        return depth
    return depth[..., ::stride, ::stride]
