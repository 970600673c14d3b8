"""Z-slab sharded TSDF: the volume's last grid axis over a mesh of ranks.

Port of ``pointcloud_stitching_tpu/parallel/tsdf_shard.py``. The TSDF
integrate is voxel-local (every voxel's update reads only its own
projection into the depth images), so the multi-device decomposition is a
slab of the grid per rank with the frames replicated:

  * integrate: each rank fuses all cameras into its own Z slab (the pruned
    path through K5 for 'auto'); no collective at all;
  * raycast: each rank marches its slab extended by a ``halo`` of
    neighbour boundary planes (one open shift per direction and field;
    the edge slabs get zeros, weight-0 planes that read as unobserved, as
    outside the unsharded volume), then the per-pixel hits min-combine
    over the mesh (an all-reduce MIN of the depth, SUMs of the tie count
    and the tie-averaged fields). Slabs that find the same crossing (in
    the halo overlap) compute identical values from identical samples, so
    the tie average is exact.

A rank holds the slab ``shard_volume`` gives it: the global origin, leaf
and truncation, and Z/D planes of every field. Slab voxel centres are
``(origin + Zs·k·leaf) + j·leaf`` against the unsharded
``origin + (Zs·k + j)·leaf``: bit for bit the same when ``leaf`` is a
power of two and ``origin`` a multiple of it (every product is exact in
float32), within an ulp otherwise, which can move a pixel's rounding at
an exact half-pixel boundary.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.tsdf import RaycastResult, TSDFVolume, integrate, raycast
from ..utils.types import scalar
from .collectives import all_gather, all_reduce, check_axis, shift_open


def shard_volume(vol: TSDFVolume, mesh, axis: str = "z") -> TSDFVolume:
    """This rank's Z slab of ``vol`` (a copy): Z/D planes of tsdf, weight
    (and rgb); origin, leaf and trunc stay the global ones. The grid's Z
    extent must divide by the mesh size."""
    check_axis(mesh, axis)
    n, r = mesh.size(), mesh.get_local_rank()
    Z = vol.shape[2]
    if Z % n != 0:
        raise ValueError(f"grid Z={Z} not divisible by mesh size {n}")
    zs = Z // n
    return vol.replace(
        tsdf=vol.tsdf[:, :, r * zs:(r + 1) * zs].clone(),
        weight=vol.weight[:, :, r * zs:(r + 1) * zs].clone(),
        rgb=(None if vol.rgb is None
             else vol.rgb[:, :, r * zs:(r + 1) * zs].clone()))


def _slab_origin(origin: torch.Tensor, leaf: torch.Tensor, zs_owned: int,
                 my: int, extra_lo: int = 0) -> torch.Tensor:
    """World origin of this rank's slab: the global origin shifted by the
    slab's first GLOBAL z index (minus ``extra_lo`` halo planes), in the
    reference's float32 order: origin + [0, 0, 1]·((k·Zs - extra)·leaf)."""
    idx = scalar(my, origin)
    off = (idx * float(zs_owned) - float(extra_lo)) * leaf
    return torch.cat([origin[:2], (origin[2] + off)[None]])


def _slab_depth(vol: TSDFVolume, mesh, seen: set) -> int:
    """The slab's Z planes, the same on every rank: checked with one
    all_gather the first time a shape is seen (every rank raises together
    when the slabs differ)."""
    zs = vol.shape[2]
    if vol.shape not in seen:
        # all_gather of each rank's slab shape: D x 24 B
        shapes = all_gather(torch.tensor(vol.shape, dtype=torch.int64,
                                         device=vol.device), mesh)
        if not bool((shapes == shapes[0]).all()):
            raise ValueError(
                "the ranks hold slabs of different shapes "
                f"{shapes.tolist()}: each must hold its shard_volume slab")
        seen.add(vol.shape)
    return zs


def make_sharded_integrate(mesh, axis: str = "z", method: str = "auto"):
    """Build ``fn(vol, depth, intr, extrinsics, **kw) -> TSDFVolume``
    integrating one multi-camera frame into this rank's Z slab.

    ``vol`` is this rank's slab (:func:`shard_volume`); depth, intrinsics,
    extrinsics, colour and ``cam_mask`` are the whole frame on every rank.
    Each rank runs the single-device ``integrate`` (``method='auto'`` the
    pruned path through K5) on its slab with a shifted origin; the step
    has no collective. A 2-D depth frame promotes its intrinsics,
    extrinsics and colour to one camera, as ``integrate`` does. Returns
    this rank's new slab.
    """
    check_axis(mesh, axis)
    seen: set = set()

    def fn(vol: TSDFVolume, depth, intr, extrinsics,
           depth_scale: float = 0.001, max_weight: float = 64.0,
           color=None, cam_mask=None, z_min: float = 0.0,
           z_max: float = float("inf")) -> TSDFVolume:
        zs = _slab_depth(vol, mesh, seen)
        org = _slab_origin(vol.origin, vol.leaf, zs, mesh.get_local_rank())
        out = integrate(vol.replace(origin=org), depth, intr, extrinsics,
                        depth_scale=depth_scale, max_weight=max_weight,
                        color=color, cam_mask=cam_mask, z_min=z_min,
                        z_max=z_max, method=method)
        return out.replace(origin=vol.origin)

    return fn


def _exchange_halo(a: torch.Tensor, halo: int, mesh,
                   channels: bool) -> torch.Tensor:
    """Extend a slab with ``halo`` boundary planes from each Z neighbour;
    edge slabs receive zeros."""
    zax = 3 if channels else 2
    lo = a.narrow(zax, 0, halo)
    hi = a.narrow(zax, a.shape[zax] - halo, halo)
    # two open shifts of X x Y x halo (x 3) x 4 B
    from_prev = shift_open(hi, mesh, 1)
    from_next = shift_open(lo, mesh, -1)
    return torch.cat([from_prev, a, from_next], dim=zax)


def make_sharded_raycast(mesh, axis: str = "z", t_min: float = 0.2,
                         t_max: float = 8.0, step: Optional[float] = None,
                         stride: int = 1, halo: Optional[int] = None):
    """Build ``fn(vol, intr, extrinsics) -> RaycastResult`` rendering a
    Z-slab sharded volume: a per-slab march over a halo-extended field,
    then a per-pixel min-combine of the hits over the mesh. The result is
    whole and the same on every rank.

    ``step`` is the march step in meters (default: half the truncation
    band, read from the volume). ``halo`` defaults to
    ``ceil(1.5·step/leaf) + 2`` planes: enough that the slab owning a
    crossing's far sample also holds the march's previous sample, the
    trilinear refinement's ±step/2 probes and the normal lattice around
    the refined hit.
    """
    check_axis(mesh, axis)
    n = mesh.size()
    seen: set = set()

    def fn(vol: TSDFVolume, intr, extrinsics) -> RaycastResult:
        zs = _slab_depth(vol, mesh, seen)
        step_f = step if step is not None else 0.5 * float(vol.trunc)
        leaf_f = float(vol.leaf)
        halo_p = halo if halo is not None else (
            int(math.ceil(1.5 * step_f / leaf_f)) + 2)
        if halo_p > zs:
            # a clamped halo would SILENTLY drop crossings near slab
            # boundaries (neither neighbour sees both march samples);
            # refuse instead — every remedy changes results or shapes,
            # so it must be the caller's explicit choice
            raise ValueError(
                f"sharded raycast needs a {halo_p}-plane halo (step "
                f"{step_f:.4g} m at leaf {leaf_f:.4g} m) but the Z slab is "
                f"only {zs} planes deep on this {n}-rank mesh — use a "
                f"smaller step, fewer ranks / a deeper grid, or pass halo= "
                f"explicitly (risking missed crossings at slab boundaries)")
        ext = vol.replace(
            tsdf=_exchange_halo(vol.tsdf, halo_p, mesh, False),
            # halo weights arrive 0 on edge slabs and as the neighbour's
            # real evidence elsewhere; the NaN-masked field treats both
            # correctly (models/tsdf.py _nan_field)
            weight=_exchange_halo(vol.weight, halo_p, mesh, False),
            rgb=(None if vol.rgb is None
                 else _exchange_halo(vol.rgb, halo_p, mesh, True)),
            origin=_slab_origin(vol.origin, vol.leaf, zs,
                                mesh.get_local_rank(), extra_lo=halo_p))
        rc = raycast(ext, intr, extrinsics, t_min=t_min, t_max=t_max,
                     step=step_f, stride=stride)
        # min-combine: the earliest valid hit over the slabs wins; on exact
        # ties every winner computed identical values, so the average is
        # exact. all_reduce MIN of h x w x 4 B, SUM of the same
        d = torch.where(rc.valid, rc.depth, float("inf"))
        dmin = all_reduce(d, "min", mesh)
        sel = rc.valid & (d == dmin)
        cnt = all_reduce(sel.to(torch.float32), "sum", mesh)
        den = torch.clamp(cnt, min=1.0)

        def comb(x):
            # all_reduce SUM of h x w (x 3) x 4 B
            m = sel[..., None] if x.dim() == 3 else sel
            s = all_reduce(torch.where(m, x, 0.0), "sum", mesh)
            return s / (den[..., None] if x.dim() == 3 else den)

        valid_g = cnt > 0.0
        return RaycastResult(
            depth=torch.where(valid_g, dmin, 0.0),
            vertex=comb(rc.vertex), normal=comb(rc.normal), valid=valid_g,
            rgb=None if rc.rgb is None else comb(rc.rgb))

    return fn
