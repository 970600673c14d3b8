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
    so the sums are exact and the centroid is quantised at leaf/2048;
  * exact: sort the (packed (ix, iy), iz) key pair — built here as one
    int64 key (k1 << 32) | kz — with the float coordinates as payload.

The branch choice is a Python ``if`` on a 0-d device bool: one host sync
per voxel pass (the JAX package's ``lax.cond`` has none).
"""
from __future__ import annotations

import torch

from ..kernels.segment_reduce import (segment_sum_from_flags,
                                      segment_sum_sorted)
from ..utils.types import PointCloud, scalar

_SENTINEL = 2 ** 31 - 1
_PACK_MAX_LEAF = 0.03
_PACK_MAX_CELLS = float(2 ** 30)


def voxel_indices(xyz: torch.Tensor, mask: torch.Tensor, leaf):
    """Per-axis int32 voxel indices (PCL convention), sentinel for invalid."""
    inv = 1.0 / scalar(leaf, xyz)
    f = torch.floor(xyz * inv).to(torch.int32)
    fm = torch.where(mask[..., None], f, _SENTINEL)
    min_ijk = fm.amin(dim=-2, keepdim=True)
    ijk = f - min_ijk
    return torch.where(mask[..., None], ijk, _SENTINEL)


def _extents(ijk: torch.Tensor) -> torch.Tensor:
    """Per-axis occupied extent (nx, ny, nz) of sentinel-masked indices."""
    valid = ijk[..., 0] != _SENTINEL
    mx = torch.where(valid[..., None], ijk, -1).amax(dim=-2)
    return mx + 1  # all-invalid cloud -> extent 0


def _prev(a: torch.Tensor) -> torch.Tensor:
    """a shifted right by one along the last axis, -1 in front."""
    return torch.cat([torch.full_like(a[..., :1], -1), a[..., :-1]], dim=-1)


def _sorted_segments_packed(pc: PointCloud, leaf, ijk: torch.Tensor):
    """Packed sort: linearised key + quantised offsets (+ 8-bit RGB).

    Returns (flags, vals [..., N, 7 or 10], min_ijk) with integer channels
    [ix·flag, iy·flag, iz·flag, q0, q1, q2, 1] (+ [r, g, b]).
    """
    xyz, mask = pc.xyz, pc.mask
    inv = 1.0 / scalar(leaf, xyz)
    ext = _extents(ijk)
    ny = torch.clamp(ext[..., 1:2], min=1)
    nz = torch.clamp(ext[..., 2:3], min=1)
    key = (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
    key = torch.where(mask, key, _SENTINEL)

    # in-voxel offsets in units of leaf/1024 (floor of the f32 fraction)
    p = xyz * inv
    frac = p - torch.floor(p)
    oq = torch.clamp((frac * 1024.0).to(torch.int32), 0, 1023)
    off = (oq[..., 0] << 20) | (oq[..., 1] << 10) | oq[..., 2]

    skey, perm = torch.sort(key, dim=-1)
    soff = off.gather(-1, perm)
    valid = skey != _SENTINEL

    sk = torch.where(valid, skey, 0)
    iz = sk % nz
    t = sk // nz
    iy = t % ny
    ix = t // ny
    fm = torch.where(mask[..., None], torch.floor(p).to(torch.int32),
                     _SENTINEL)
    min_ijk = fm.amin(dim=-2, keepdim=True)

    flags = (skey != _prev(skey)) & valid
    f = flags.to(torch.float32)
    q = torch.stack([(soff >> 20) & 1023, (soff >> 10) & 1023, soff & 1023],
                    dim=-1).to(torch.float32)
    chans = [torch.stack([ix, iy, iz], dim=-1).to(torch.float32) * f[..., None],
             q, torch.ones_like(f)[..., None]]
    if pc.rgb is not None:
        rq = torch.clamp(pc.rgb.to(torch.int32), 0, 255)
        rgb_packed = (rq[..., 0] << 16) | (rq[..., 1] << 8) | rq[..., 2]
        srgb = rgb_packed.gather(-1, perm)
        chans.append(torch.stack([(srgb >> 16) & 255, (srgb >> 8) & 255,
                                  srgb & 255], dim=-1).to(torch.float32))
    vals = torch.cat(chans, dim=-1)
    vals = torch.where(valid[..., None], vals, 0.0)
    return flags, vals, min_ijk


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
    flags = (skey != _prev(skey)) & valid
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


def _finalize_packed(sums: torch.Tensor, min_ijk: torch.Tensor, leaf,
                     has_rgb: bool = False) -> PointCloud:
    """Centroids from integer-channel sums: (base + (Σq/n + ½)/1024)·leaf."""
    counts = sums[..., 6]
    out_mask = counts > 0.0
    denom = torch.clamp(counts, min=1.0)[..., None]
    base = sums[..., :3] + min_ijk.to(torch.float32)
    mean_q = sums[..., 3:6] / denom
    xyz = (base + (mean_q + 0.5) * (1.0 / 1024.0)) * scalar(leaf, sums)
    rgb = None
    if has_rgb:
        rgb = torch.where(out_mask[..., None], sums[..., 7:10] / denom, 0.0)
    return PointCloud(xyz=torch.where(out_mask[..., None], xyz, 0.0),
                      mask=out_mask, rgb=rgb)


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
    if packed == "auto":
        ijk = voxel_indices(pc.xyz, pc.mask, leaf)
        ext = _extents(ijk)
        cells = ext.to(torch.float32).prod(dim=-1)
        # per-axis bound <= 2^16 keeps the index channels exact
        fits = ((cells <= _PACK_MAX_CELLS).all() & (ext <= 65536).all()
                & (scalar(leaf, pc.xyz) <= _PACK_MAX_LEAF))
        if has_rgb:
            # pack only when lossless: 8-bit integer colours
            fits = fits & (pc.rgb == torch.round(pc.rgb)).all() \
                & ((pc.rgb >= 0) & (pc.rgb <= 255)).all()
        if bool(fits):  # the one host sync of the pass
            flags, vals, min_ijk = _sorted_segments_packed(pc, leaf, ijk)
            return _finalize_packed(reduce_fn(flags, vals), min_ijk, leaf,
                                    has_rgb)
    flags, vals = _sorted_segments(pc, leaf)
    return _finalize(reduce_fn(flags, vals), has_rgb)


def decimate_depth(depth: torch.Tensor, stride: int) -> torch.Tensor:
    """Grid-stride decimation of a depth image before deprojection."""
    if stride <= 1:
        return depth
    return depth[..., ::stride, ::stride]
