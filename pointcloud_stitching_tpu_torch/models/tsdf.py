"""Dense TSDF volume: KinectFusion-style scene fusion on the GPU.

Port of ``pointcloud_stitching_tpu/models/tsdf.py``: a truncated signed
distance field on a dense [X, Y, Z] grid (Curless–Levoy / KinFu, the
``pcl::gpu::kinfu::TsdfVolume`` role), with

  * ``integrate``: one multi-camera depth frame (and optional colour)
    folded into the running weighted average. ``method='dense'`` projects
    every voxel into every camera (the oracle); the pruned path (the
    default) classifies 8³ bricks per camera and gathers depth only for
    the bricks the classifier cannot settle, through kernel K5
    (``kernels/patch_gather.py``). The two are bit for bit equal;
  * ``raycast``: a fixed-step march to the zero level, trilinear
    refinement and gradient normals;
  * ``track`` / ``rig_track``: projective point-to-plane ICP against the
    ray-cast model (frame-to-model tracking), and its lift to a rigid rig;
  * ``extract_cloud`` / ``extract_mesh`` (marching tetrahedra of
    ``ops/surface.py``), ``save_volume`` / ``load_volume`` (the JAX
    package's ``.npz`` layout, version 1, readable both ways).

Arithmetic follows the JAX package operation for operation. Where XLA
contracts a multiply feeding an add into one fused multiply-add (voxel
centres, the 3×3 transform, the pinhole, the running-average merge, the
ray and tracking arithmetic), the port calls ``torch.addcmul`` in the same
order, so the CPU tests can hold integration to the JAX package bit for
bit. Points travel as coordinate planes (x, y, z), and the voxel transform
is written out element by element (``_transform``) instead of a matmul: a
matmul's summation order may depend on its shape, and the dense and the
pruned path transform different numbers of voxels; elementwise, every
voxel gets the same bits in both.

Data-dependent branches (pruned or unpruned per camera, patched or full
near-camera lookup) are host decisions in PyTorch. ``integrate`` reads the
counts they need in two host reads per call, whatever the number of
cameras: the brick-class counts of every camera, then the non-fitting brick
counts of every camera.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.patch_gather import SPAN_U, SPAN_V, patch_gather
from ..ops.deproject import deproject, project_planes
from ..ops.se3 import mm, se3_compose, se3_from_rt, se3_inverse, so3_exp
from ..ops.surface import marching_tetrahedra, nonzero_static
from ..utils.platform import platform_device
from ..utils.types import Intrinsics, PointCloud, scalar

_F32 = torch.float32


@dataclasses.dataclass
class TSDFVolume:
    """Dense truncated signed distance volume (see the module docstring).

    tsdf:   [X, Y, Z] f32 in [-1, 1] (distance / trunc; +1 = free space)
    weight: [X, Y, Z] f32 accumulated evidence (0 = never observed)
    origin: [3] f32 world position of voxel (0, 0, 0)'s CENTER
    leaf:   0-d f32 voxel edge (meters)
    trunc:  0-d f32 truncation band (meters)
    rgb:    [X, Y, Z, 3] f32 running-average colour in [0, 255], or None

    Every tensor lives on ``device``; ``create`` and ``load_volume`` take it
    explicitly and otherwise ask ``utils.platform.platform_device()``.
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    origin: torch.Tensor
    leaf: torch.Tensor
    trunc: torch.Tensor
    rgb: Optional[torch.Tensor] = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.tsdf.shape)

    @property
    def device(self) -> torch.device:
        return self.tsdf.device

    def replace(self, **changes) -> "TSDFVolume":
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(cls, shape: tuple[int, int, int], leaf: float,
               origin=(0.0, 0.0, 0.0), trunc: float | None = None,
               with_rgb: bool = False, device=None) -> "TSDFVolume":
        """An empty volume: ``shape`` voxels of edge ``leaf`` anchored so
        voxel (0,0,0)'s centre sits at ``origin``; ``trunc`` defaults to 4
        leaves. ``device`` defaults to ``platform_device()`` (the first GPU,
        or the CPU only when ``PCS_PLATFORM=cpu``)."""
        dev = platform_device() if device is None else torch.device(device)
        X, Y, Z = shape
        t = 4.0 * leaf if trunc is None else trunc
        return cls(
            tsdf=torch.ones((X, Y, Z), dtype=_F32, device=dev),
            weight=torch.zeros((X, Y, Z), dtype=_F32, device=dev),
            origin=torch.tensor(origin, dtype=_F32, device=dev),
            leaf=torch.tensor(leaf, dtype=_F32, device=dev),
            trunc=torch.tensor(t, dtype=_F32, device=dev),
            rgb=(torch.zeros((X, Y, Z, 3), dtype=_F32, device=dev)
                 if with_rgb else None))


def _transform(T: torch.Tensor, x, y, z):
    """T [..., 4, 4] applied to points given as coordinate planes, element
    by element: each output plane is fma(R_i2, z, fma(R_i1, y, R_i0 * x)) +
    t_i, the order of XLA's dot. Returns (x, y, z) planes of shape [...,
    *x.shape] (a batch of transforms maps the same points once each)."""
    T = T.reshape(*T.shape[:-2], *(1,) * x.dim(), 4, 4)
    return tuple(torch.addcmul(torch.addcmul(T[..., i, 0] * x, T[..., i, 1],
                                             y), T[..., i, 2], z)
                 + T[..., i, 3] for i in range(3))


def _fma3(a, x, b, y, c, z):
    """a*x + b*y + c*z as XLA contracts the elementwise expression:
    fma(c, z, fma(a, x, b*y))."""
    return torch.addcmul(torch.addcmul(b * y, a, x), c, z)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the IEEE result XLA and CUDA
    give; PyTorch's CPU kernel can miss it by an ulp): the float64 root of a
    float32 value rounds to the float32 root exactly."""
    return torch.sqrt(a.double()).float()


def _voxel_centers(shape, origin, leaf):
    """World positions of every voxel centre as (x, y, z) planes [V]
    (V = X·Y·Z, voxel order): origin + index · leaf per axis."""
    X, Y, Z = shape
    dev = origin.device
    view = ((X, 1, 1), (1, Y, 1), (1, 1, Z))
    return tuple(torch.addcmul(origin[a], torch.arange(
        shape[a], dtype=_F32, device=dev).reshape(view[a]).expand(X, Y, Z),
        leaf).reshape(-1) for a in range(3))


def _cam_slice(intr: Intrinsics, c) -> Intrinsics:
    """Select camera ``c`` from batched Intrinsics."""
    return intr.replace(
        fx=intr.fx[c], fy=intr.fy[c], ppx=intr.ppx[c], ppy=intr.ppy[c],
        coeffs=intr.coeffs[c],
        model_ids=None if intr.model_ids is None else intr.model_ids[c])


_DO_NOT_PORT = ("method {!r} is not ported: it is on ROADMAP.md's \"Do not "
                "port\" list (the superseded 'brick' scatter integrator and "
                "the XLA one-hot form 'mxu_xla'); use 'auto' or 'dense'")


def integrate(vol: TSDFVolume, depth: torch.Tensor, intr: Intrinsics,
              extrinsics, depth_scale: float = 0.001,
              max_weight: float = 64.0,
              color: Optional[torch.Tensor] = None,
              cam_mask: Optional[torch.Tensor] = None,
              z_min: float = 0.0, z_max: float = math.inf,
              method: str = "auto",
              kernel_impl: str = "auto") -> TSDFVolume:
    """Fuse one multi-camera depth frame into the volume (returns a new
    volume; the input is left as it was).

    The Curless–Levoy projective update: every voxel centre projects into
    each camera, the signed distance along the ray is ``depth(pixel) -
    z_cam``, folded into a truncated running weighted average; voxels more
    than ``trunc`` behind the surface are left untouched, voxels in front
    collect free-space evidence (+1), which carves away geometry that left
    the scene.

    Args:
      vol: current state.
      depth: [ncam, H, W] (or [H, W]) uint16 raw units or float meters.
      intr: per-camera Intrinsics (batched to match, or single).
      extrinsics: [ncam, 4, 4] (or [4, 4]) camera→world transforms.
      depth_scale: meters per raw unit for integer depth.
      max_weight: evidence cap.
      color: [ncam, H, W, 3] (or [H, W, 3]) uint8/float colour aligned to
        the depth, required iff the volume has rgb.
      cam_mask: [ncam] bool; False drops a camera.
      z_min/z_max: depth validity range (meters).
      method: 'auto' | 'mxu' | 'mxu_pallas' (all three: the brick-pruned
        path with K5, the JAX package's fast path) or 'dense' (the oracle:
        one gather per voxel per camera). 'brick' and 'mxu_xla' are on
        ROADMAP's "Do not port" list and raise.
      kernel_impl: 'auto' | 'cuda' | 'torch' for K5 ('auto' launches the
        kernel on CUDA tensors and takes its plain version on the CPU).

    Returns the new volume; the pruned path equals 'dense' bit for bit.
    """
    if (color is not None) != (vol.rgb is not None):
        raise ValueError("color presence must match the volume's with_rgb")
    if method in ("brick", "mxu_xla"):
        raise ValueError(_DO_NOT_PORT.format(method))
    if method not in ("auto", "dense", "mxu", "mxu_pallas"):
        raise ValueError(f"unknown integrate method {method!r}")
    dev = vol.device
    depth = torch.as_tensor(depth).to(dev)
    extrinsics = torch.as_tensor(np.asarray(extrinsics, np.float32)
                                 if not torch.is_tensor(extrinsics)
                                 else extrinsics).to(device=dev, dtype=_F32)
    intr = intr.to(dev)
    if color is not None:
        color = torch.as_tensor(color).to(dev)
    if depth.dim() == 2:
        depth = depth[None]
        if extrinsics.dim() == 2:
            extrinsics = extrinsics[None]
        if color is not None and color.dim() == 3:
            color = color[None]
        if intr.fx.dim() == 0:
            intr = intr.replace(
                fx=intr.fx[None], fy=intr.fy[None], ppx=intr.ppx[None],
                ppy=intr.ppy[None], coeffs=intr.coeffs[None],
                model_ids=(None if intr.model_ids is None
                           else intr.model_ids[None]))
    if cam_mask is None:
        cam_mask = torch.ones((depth.shape[0],), dtype=torch.bool, device=dev)
    cam_mask = torch.as_tensor(cam_mask).to(dev)
    args = (vol, depth, intr, extrinsics, scalar(depth_scale, vol.tsdf),
            scalar(max_weight, vol.tsdf), color, cam_mask,
            scalar(z_min, vol.tsdf), scalar(z_max, vol.tsdf))
    if method == "dense":
        return _integrate_dense(*args)
    return _integrate_pruned(*args, kernel_impl=kernel_impl)


def _terms_from_depth(d, p_cz, pix_ok, trunc, z_min, z_max, mask_c):
    """Curless–Levoy terms given an already-looked-up depth d [N] (meters).

    Shared by both integrators so the update math cannot drift between
    them. Returns (wt = w·t_obs, w_obs, obs, sdf); d at pix_ok-false voxels
    is don't-care (gated to zero weight)."""
    d_ok = pix_ok & (d > z_min) & (d > 0.0) & (d < z_max)
    sdf = d - p_cz
    obs = d_ok & (sdf > -trunc) & mask_c
    t_obs = torch.clamp(sdf / trunc, max=1.0)
    w_obs = obs.to(_F32)
    return w_obs * t_obs, w_obs, obs, sdf


def _rgb4(obs, sdf, trunc, rgb_px):
    """[N, 4]: near-surface-gated colour sum and its weight."""
    wc = (obs & (torch.abs(sdf) <= trunc)).to(_F32)[:, None]
    return torch.cat([wc * rgb_px, wc], dim=-1)


def _pixels(p_c, intr_c, W: int, H: int):
    """Nearest pixel of camera-frame points (x, y, z planes): (ui, vi,
    pix_ok)."""
    u, v, in_front = _project_soa(*p_c, intr_c)
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    pix_ok = in_front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    return ui, vi, pix_ok


def _voxel_update_terms(p_w, depth_flat, intr_c, inv_ext_c, trunc,
                        z_min, z_max, W: int, H: int, mask_c,
                        color_flat=None):
    """Exact per-voxel terms for ONE camera: p_w world voxel centres as
    (x, y, z) planes [N], depth_flat [H*W] meters. Returns (wt [N], w [N],
    rgb4 [N, 4] or None)."""
    p_c = _transform(inv_ext_c, *p_w)
    ui, vi, pix_ok = _pixels(p_c, intr_c, W, H)
    flat = (torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)).long()
    d = depth_flat[flat]
    wt, w_obs, obs, sdf = _terms_from_depth(
        d, p_c[2], pix_ok, trunc, z_min, z_max, mask_c)
    rgb4 = None
    if color_flat is not None:
        rgb4 = _rgb4(obs, sdf, trunc, color_flat[flat].to(_F32))
    return wt, w_obs, rgb4


def _merge(vol: TSDFVolume, sum_wt, sum_w, sum_rgb, max_weight
           ) -> TSDFVolume:
    """The running-average update from per-frame sums in the volume's own
    [X, Y, Z] layout (the same elementwise arithmetic for both paths)."""
    w_new = vol.weight + sum_w
    t_new = torch.where(w_new > 0.0,
                        torch.addcmul(sum_wt, vol.tsdf, vol.weight)
                        / torch.clamp(w_new, min=1e-12), 1.0)
    new_rgb = None
    if vol.rgb is not None:
        rw_old = torch.minimum(vol.weight, max_weight)
        rgb_acc = torch.addcmul(sum_rgb[..., :3], vol.rgb, rw_old[..., None])
        rw_new = rw_old + sum_rgb[..., 3]
        new_rgb = torch.where(rw_new[..., None] > 0.0,
                              rgb_acc / torch.clamp(rw_new,
                                                    min=1e-12)[..., None],
                              0.0)
    return vol.replace(tsdf=t_new, weight=torch.minimum(w_new, max_weight),
                       rgb=new_rgb)


def _integrate_dense(vol: TSDFVolume, depth, intr, extrinsics, depth_scale,
                     max_weight, color, cam_mask, z_min, z_max) -> TSDFVolume:
    shape = vol.shape
    V = shape[0] * shape[1] * shape[2]
    ncam, H, W = depth.shape
    has_rgb = vol.rgb is not None
    dev = vol.device

    p_w = _voxel_centers(shape, vol.origin, vol.leaf)          # 3 x [V]
    depth_m = depth.to(_F32) * depth_scale                    # [ncam, H, W]
    inv_ext = se3_inverse(extrinsics)                         # world→cam
    sum_wt = torch.zeros((V,), dtype=_F32, device=dev)
    sum_w = torch.zeros((V,), dtype=_F32, device=dev)
    sum_rgb = torch.zeros((V, 4), dtype=_F32, device=dev) if has_rgb \
        else None
    for c in range(ncam):   # cameras accumulate in order
        wt, w_obs, rgb4 = _voxel_update_terms(
            p_w, depth_m[c].reshape(-1), _cam_slice(intr, c), inv_ext[c],
            vol.trunc, z_min, z_max, W, H, cam_mask[c],
            color_flat=color[c].reshape(-1, 3) if has_rgb else None)
        sum_wt = sum_wt + wt
        sum_w = sum_w + w_obs
        if has_rgb:
            sum_rgb = sum_rgb + rgb4
    return _merge(vol, sum_wt.reshape(shape), sum_w.reshape(shape),
                  sum_rgb.reshape(*shape, 4) if has_rgb else None,
                  max_weight)


# --------------------------------------------------------------------------
# brick classification (8³ bricks)
# --------------------------------------------------------------------------
#
# FREE        whole brick provably sdf >= trunc with every pixel valid and
#             strictly inside the image: +1 per voxel, no per-voxel work.
# FREE_BORDER the same, but the footprint crosses the image border: the
#             per-voxel bounds test runs, the depth gather does not.
# SKIP        provably no voxel updates (behind the camera, outside the
#             image, invalid footprint, or occluded).
# REFINE      everything unproven: the exact per-voxel math, depth gathered
#             through K5.
# The bounds are conservative (folded depth tiles, corner-projected
# footprint boxes with a pixel margin, 1e-4 m slack on every trunc
# comparison), so anything uncertain lands in REFINE, which is exact.

_BRICK = 8
_BVOX = _BRICK ** 3
_BBOX_MARGIN_PX = 3.0       # footprint slack: distortion bend + rounding
_FM = 1e-4                  # meters of slack on trunc comparisons
_TILE_F = 32                # fine depth tile (96-px folded window)
_TILE_C = 64                # coarse fallback tile (192-px window)



def _corners(dev) -> torch.Tensor:
    """[8, 3] unit-cube corners, x major: [[x, y, z] for x in (0, 1) for
    y in (0, 1) for z in (0, 1)], made on the device (a copy from the host
    would wait for the device's queue)."""
    i = torch.arange(8, device=dev)
    return torch.stack([i // 4, (i // 2) % 2, i % 2], dim=-1).to(_F32)


def _to_bricks(a: torch.Tensor, shape) -> torch.Tensor:
    """[X,Y,Z](,C) → [NB, 512](,C) brick-major (8³ bricks contiguous)."""
    X, Y, Z = shape
    chan = tuple(a.shape[3:])
    t = a.reshape(X // _BRICK, _BRICK, Y // _BRICK, _BRICK,
                  Z // _BRICK, _BRICK, *chan)
    t = t.permute(0, 2, 4, 1, 3, 5, *range(6, 6 + len(chan)))
    return t.reshape(-1, _BVOX, *chan)


def _from_bricks(ab: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of _to_bricks."""
    X, Y, Z = shape
    chan = tuple(ab.shape[2:])
    t = ab.reshape(X // _BRICK, Y // _BRICK, Z // _BRICK,
                   _BRICK, _BRICK, _BRICK, *chan)
    t = t.permute(0, 3, 1, 4, 2, 5, *range(6, 6 + len(chan)))
    return t.reshape(X, Y, Z, *chan)


def _brick_voxel_world(bids: torch.Tensor, shape, origin, leaf):
    """[K] brick ids → world voxel centres as (x, y, z) planes [K*512]."""
    _, Y, Z = shape
    nby, nbz = Y // _BRICK, Z // _BRICK
    o = torch.arange(_BVOX, device=bids.device)
    brick = (bids // (nby * nbz), (bids // nbz) % nby, bids % nbz)
    local = (o // 64, (o // 8) % 8, o % 8)
    return tuple(torch.addcmul(origin[a], (brick[a][:, None] * _BRICK
                                           + local[a][None]).to(_F32),
                               leaf).reshape(-1) for a in range(3))


def _pad_const(a: torch.Tensor, pads, value) -> torch.Tensor:
    """Pad the last two dims of ``a`` (any dtype, bool included) by ((top,
    bottom), (left, right)) with a constant."""
    (t, b), (l, r) = pads
    h, w = a.shape[-2:]
    out = a.new_full((*a.shape[:-2], h + t + b, w + l + r), value)
    out[..., t:t + h, l:l + w] = a
    return out


def _tile_stats(depth_m, z_min, z_max, tile: int):
    """Per-tile valid-depth stats with a 3×3 tile-neighbourhood fold, for
    depth [..., H, W] (one camera or a batch): (dmin, dmax, allv) [...,
    ⌈H/tile⌉, ⌈W/tile⌉], entry (i, j) bounding the 3·tile-px window centred
    on tile (i, j). Pads are +inf / -inf / True, so out-of-image pixels
    never poison a tile."""
    H, W = depth_m.shape[-2:]
    lead = depth_m.shape[:-2]
    valid = (depth_m > torch.clamp(z_min, min=0.0)) & (depth_m < z_max)
    ph, pw = -(-H // tile), -(-W // tile)
    pad = ((0, ph * tile - H), (0, pw * tile - W))
    inf = math.inf

    def tiles(a, value):
        return _pad_const(a, pad, value).reshape(*lead, ph, tile, pw, tile)

    dmin = tiles(torch.where(valid, depth_m, inf), inf).amin(dim=(-3, -1))
    dmax = tiles(torch.where(valid, depth_m, -inf), -inf).amax(dim=(-3, -1))
    allv = tiles(valid, True).all(dim=-1).all(dim=-2)

    def fold3(a, op, ident):
        p = _pad_const(a, ((1, 1), (1, 1)), ident)
        rows = op(op(p[..., :-2, :], p[..., 1:-1, :]), p[..., 2:, :])
        return op(op(rows[..., :-2], rows[..., 1:-1]), rows[..., 2:])

    return (fold3(dmin, torch.minimum, inf),
            fold3(dmax, torch.maximum, -inf),
            fold3(allv, torch.logical_and, True))


def _classify_bricks(depth_m, intr, inv_ext, shape, origin, leaf, trunc,
                     z_min, z_max):
    """Per-brick class flags: (free_full, free_border, refine) bool [...,
    NB] (everything else provably updates nothing). For one camera (depth
    [H, W], unbatched intrinsics, inv_ext [4, 4]) or a batch of cameras
    (leading dims on all three), each classified on its own."""
    X, Y, Z = shape
    H, W = depth_m.shape[-2:]
    lead = depth_m.shape[:-2]
    dev = depth_m.device
    nb = (X // _BRICK) * (Y // _BRICK) * (Z // _BRICK)

    fine = _tile_stats(depth_m, z_min, z_max, _TILE_F)
    coarse = _tile_stats(depth_m, z_min, z_max, _TILE_C)
    dmin_g = fine[0].amin(dim=(-2, -1))[..., None]
    dmax_g = fine[1].amax(dim=(-2, -1))[..., None]
    allv_g = fine[2].flatten(-2).all(dim=-1)[..., None]

    # brick corner boxes → camera-frame z range + footprint pixel box
    nby, nbz = Y // _BRICK, Z // _BRICK
    bidx = torch.arange(nb, dtype=torch.int32, device=dev)
    lo = torch.stack([bidx // (nby * nbz), (bidx // nbz) % nby, bidx % nbz],
                     dim=-1).to(_F32) * float(_BRICK)
    corn = lo[:, None, :] + (float(_BRICK) - 1.0) * _corners(dev)[None]
    p_c = _transform(inv_ext, *(torch.addcmul(origin[a], corn[..., a], leaf)
                                for a in range(3)))     # 3 x [..., nb, 8]
    zmin_b = p_c[2].amin(dim=-1)
    zmax_b = p_c[2].amax(dim=-1)

    def per_corner(t):  # camera fields [...] -> [..., 1, 1]
        return None if t is None else t[..., None, None]

    u, v, _ = _project_soa(*p_c, intr.replace(
        fx=per_corner(intr.fx), fy=per_corner(intr.fy),
        ppx=per_corner(intr.ppx), ppy=per_corner(intr.ppy),
        coeffs=intr.coeffs[..., None, None, :],
        model_ids=per_corner(intr.model_ids)))
    m = _BBOX_MARGIN_PX + 1.0   # +1: round() widens the index range
    u0 = u.amin(dim=-1) - m
    u1 = u.amax(dim=-1) + m
    v0 = v.amin(dim=-1) - m
    v1 = v.amax(dim=-1) + m

    in_front_all = zmin_b > 1e-6      # project()'s gate is z > 1e-9
    in_front_none = zmax_b <= 0.0
    fully_in = (u0 >= 0) & (u1 <= W - 1) & (v0 >= 0) & (v1 <= H - 1)
    fully_out = (u1 < 0) | (u0 > W - 1) | (v1 < 0) | (v0 > H - 1)

    def level(tile, stats):
        """One folded read per stat; fits when the footprint spans <= 2
        tiles."""
        ph, pw = stats[0].shape[-2:]
        tu0 = torch.floor(u0 / tile).to(torch.int32)
        tv0 = torch.floor(v0 / tile).to(torch.int32)
        fits = ((torch.floor(u1 / tile).to(torch.int32) - tu0 <= 1)
                & (torch.floor(v1 / tile).to(torch.int32) - tv0 <= 1))
        at = (torch.clamp(tv0, 0, ph - 1) * pw
              + torch.clamp(tu0, 0, pw - 1)).long()
        return fits, tuple(torch.gather(s.reshape(*lead, ph * pw), -1, at)
                           for s in stats)

    fits_f, vf = level(_TILE_F, fine)
    fits_c, vc = level(_TILE_C, coarse)

    def pick(i, glob):
        return torch.where(fits_f, vf[i], torch.where(fits_c, vc[i], glob))

    dmin_r = pick(0, dmin_g)
    dmax_r = pick(1, dmax_g)
    allv_r = pick(2, allv_g)

    free_c = in_front_all & allv_r & (dmin_r - zmax_b >= trunc + _FM)
    # dmax_r == -inf (footprint entirely invalid) makes this true too:
    # those voxels all have d_ok == False
    occl = in_front_all & (dmax_r - zmin_b < -trunc - _FM)
    free_full = free_c & fully_in
    free_border = free_c & ~fully_in & ~fully_out
    skip = in_front_none | (in_front_all & (fully_out | occl))
    refine = ~(free_full | free_border | skip)
    return free_full, free_border, refine


# --------------------------------------------------------------------------
# pruned integration through K5
# --------------------------------------------------------------------------
#
# Only REFINE bricks are gathered, each through one 128×256 window plan
# (K5); FREE bricks add +1 to the camera's delta, FREE_BORDER bricks run the
# per-voxel bounds test with no gather, SKIP bricks cost nothing. A camera
# with more REFINE bricks than half the grid (or more FREE_BORDER bricks
# than an eighth of it) takes the unpruned lookup over every brick, as in
# the JAX package. Bricks whose valid footprint does not fit a window
# (cameras close to the volume) are patched by a direct gather, or, when
# more than an eighth of the gathered bricks miss, the camera's whole
# selection is gathered directly. Every per-voxel delta is a single value
# added into a zero buffer (the categories are exclusive) and cameras sum
# in order, exactly as in the dense path, so pruning is bitwise. The JAX
# package sizes its selections with static capacities (XLA needs static
# shapes); the port sizes them exactly, and the results never depend on
# either.

def _brick_pixels(bsel, shape, origin, leaf, inv_ext_c, intr_c, W: int,
                  H: int):
    """The voxels of bricks ``bsel`` [K] in camera c: (p_cz [K*512]
    camera-frame z, pix_ok [K*512], uib/vib [K, 512] int32 pixel coordinates
    clipped to the image)."""
    K = bsel.shape[0]
    p_c = _transform(inv_ext_c, *_brick_voxel_world(bsel, shape, origin,
                                                    leaf))
    ui, vi, pix_ok = _pixels(p_c, intr_c, W, H)
    uib = torch.clamp(ui, 0, W - 1).reshape(K, _BVOX)
    vib = torch.clamp(vi, 0, H - 1).reshape(K, _BVOX)
    return p_c[2], pix_ok, uib, vib


def _plan_windows(ui, vi, pix_ok):
    """Per-brick K5 window plan: ui/vi [K, 512] int32 CLIPPED image
    coordinates, pix_ok [K, 512]. Returns (v0, u0, fits): raw window
    starts [K] (K5 aligns and clamps them) and the bricks whose valid
    footprint fits one window."""
    big = 1 << 20
    u_min = torch.where(pix_ok, ui, big).amin(dim=1)
    u_max = torch.where(pix_ok, ui, -1).amax(dim=1)
    v_min = torch.where(pix_ok, vi, big).amin(dim=1)
    v_max = torch.where(pix_ok, vi, -1).amax(dim=1)
    none_ok = ~pix_ok.any(dim=1)
    fits = none_ok | ((u_max - u_min < SPAN_U) & (v_max - v_min < SPAN_V))
    u0 = torch.where(none_ok, 0, u_min).to(torch.int32)
    v0 = torch.where(none_ok, 0, v_min).to(torch.int32)
    return v0, u0, fits


def _unpack_rgb(planes, packed: bool):
    """[N] gathered plane(s) → [N, 3] exact channel values."""
    if packed:
        p = planes[0]
        b = torch.floor(p / 65536.0)          # /2^16 is exact scaling
        rem = p - b * 65536.0                 # integers <= 2^24: exact
        g = torch.floor(rem / 256.0)
        r = rem - g * 256.0
        return torch.stack([r, g, b], dim=-1)
    return torch.stack(planes, dim=-1)


def _integrate_pruned(vol: TSDFVolume, depth, intr, extrinsics, depth_scale,
                      max_weight, color, cam_mask, z_min, z_max,
                      kernel_impl: str = "auto") -> TSDFVolume:
    X0, Y0, Z0 = vol.shape
    # any shape: bricks tile an internally padded grid; the pad voxels'
    # terms are computed and sliced off before the merge
    shape = tuple(-(-s // _BRICK) * _BRICK for s in (X0, Y0, Z0))
    X, Y, Z = shape
    nb = (X // _BRICK) * (Y // _BRICK) * (Z // _BRICK)
    gcap = min(nb, max(256, nb // 2))   # REFINE bricks past this: unpruned
    bcap = min(nb, max(256, nb // 8))   # FREE_BORDER bricks past this too
    ncam, H, W = depth.shape
    has_rgb = vol.rgb is not None
    dev = vol.device
    origin, leaf, trunc = vol.origin, vol.leaf, vol.trunc

    depth_raw = depth.to(_F32)
    depth_m = depth_raw * depth_scale
    inv_ext = se3_inverse(extrinsics)
    # colour planes ride the depth's windows: 8-bit channels pack into ONE
    # integer-valued f32 plane (<= 2^24 - 1, exact); wider dtypes gather
    # three float planes
    packed = has_rgb and color.dtype == torch.uint8
    col_planes = ()
    if has_rgb:
        colf = color.to(_F32)
        col_planes = ((colf[..., 0] + 256.0 * colf[..., 1]
                       + 65536.0 * colf[..., 2],) if packed
                      else tuple(colf[..., i] for i in range(3)))
    intrs = [_cam_slice(intr, c) for c in range(ncam)]

    # 1. classify every camera's bricks at once; one host read of all the
    # counts
    free_full, free_border, refine = _classify_bricks(
        depth_m, intr, inv_ext, shape, origin, leaf, trunc, z_min, z_max)
    counts = torch.stack([refine.sum(dim=-1), free_border.sum(dim=-1)],
                         dim=-1).tolist()

    # 2. per camera: the bricks to gather, their voxels' pixels and window
    # plans; one host read of every camera's count of non-fitting bricks
    plans = []
    for c in range(ncam):
        n_refine, n_border = counts[c]
        unpruned = n_border > bcap or n_refine > gcap
        bsel = (torch.arange(nb, device=dev) if unpruned
                else nonzero_static(refine[c], n_refine))
        p_cz, pix_ok, uib, vib = _brick_pixels(bsel, shape, origin, leaf,
                                               inv_ext[c], intrs[c], W, H)
        v0, u0, fits = _plan_windows(uib, vib, pix_ok.reshape(uib.shape))
        plans.append(dict(unpruned=unpruned, bsel=bsel, p_cz=p_cz,
                          pix_ok=pix_ok, uib=uib, vib=vib, v0=v0, u0=u0,
                          fits=fits))
    n_bad = torch.stack([(~p["fits"]).sum() for p in plans]).tolist() \
        if plans else []

    # 3. gathers and per-camera deltas, summed in camera order
    sum_wt = torch.zeros((nb, _BVOX), dtype=_F32, device=dev)
    sum_w = torch.zeros((nb, _BVOX), dtype=_F32, device=dev)
    sum_rgb = torch.zeros((nb, _BVOX, 4), dtype=_F32, device=dev) \
        if has_rgb else None
    for c in range(ncam):
        p = plans[c]
        K = p["bsel"].shape[0]
        vib, uib, v0, u0 = p["vib"], p["uib"], p["v0"], p["u0"]
        iv = vib - v0[:, None]
        iu = uib - u0[:, None]
        d = patch_gather(depth_raw[c], v0, u0, iv, iu,
                         impl=kernel_impl) * depth_scale
        cols = [patch_gather(pl[c], v0, u0, iv, iu, impl=kernel_impl)
                for pl in col_planes]
        flat = (vib * W + uib).long()
        kb = min(K, max(64, K // 8))    # near-camera patch budget
        if n_bad[c] > kb:
            # too many non-fitting bricks: gather the whole selection
            d = depth_m[c].reshape(-1)[flat]
            cols = [pl[c].reshape(-1)[flat] for pl in col_planes]
        elif n_bad[c] > 0:
            # gather only the bricks whose footprint missed the window
            bad = nonzero_static(~p["fits"], n_bad[c])
            rows = flat[bad]
            d[bad] = depth_m[c].reshape(-1)[rows]
            for cp, pl in zip(cols, col_planes):
                cp[bad] = pl[c].reshape(-1)[rows]
        wt, w_obs, obs, sdf = _terms_from_depth(
            d.reshape(-1), p["p_cz"], p["pix_ok"], trunc, z_min, z_max,
            cam_mask[c])
        wt, w_obs = wt.reshape(K, _BVOX), w_obs.reshape(K, _BVOX)
        rgb4 = None
        if has_rgb:
            rgb4 = _rgb4(obs, sdf, trunc, _unpack_rgb(
                [cp.reshape(-1) for cp in cols], packed)).reshape(K, _BVOX, 4)

        if p["unpruned"]:
            d_wt, d_w, d_rgb = wt, w_obs, rgb4
        else:
            rb = p["bsel"]
            d_wt = torch.zeros((nb, _BVOX), dtype=_F32,
                               device=dev).index_add_(0, rb, wt)
            d_w = torch.zeros((nb, _BVOX), dtype=_F32,
                              device=dev).index_add_(0, rb, w_obs)
            d_rgb = torch.zeros((nb, _BVOX, 4), dtype=_F32, device=dev) \
                .index_add_(0, rb, rgb4) if has_rgb else None
            # FREE_BORDER: classification proved sdf >= trunc and valid
            # depth for every in-image pixel; only the bounds test runs
            # (colour needs nothing: |sdf| <= trunc is provably false)
            bb = nonzero_static(free_border[c], counts[c][1])
            q_c = _transform(inv_ext[c], *_brick_voxel_world(
                bb, shape, origin, leaf))
            _, _, ok = _pixels(q_c, intrs[c], W, H)
            wb = (ok & cam_mask[c]).to(_F32).reshape(-1, _BVOX)
            d_wt.index_add_(0, bb, wb)   # t_obs == 1 in proven free space
            d_w.index_add_(0, bb, wb)
            # FREE interior bricks: every voxel adds exactly 1.0, INTO the
            # camera's delta, so the camera sum keeps the dense order
            fb = (free_full[c] & cam_mask[c]).to(_F32)[:, None]
            d_wt, d_w = d_wt + fb, d_w + fb
        sum_wt = sum_wt + d_wt
        sum_w = sum_w + d_w
        if has_rgb:
            sum_rgb = sum_rgb + d_rgb

    # merge in the volume's own layout, cropping the internal padding
    def natural(a):
        return _from_bricks(a, shape)[:X0, :Y0, :Z0]

    return _merge(vol, natural(sum_wt), natural(sum_w),
                  natural(sum_rgb) if has_rgb else None, max_weight)


# --------------------------------------------------------------------------
# sampling helpers
# --------------------------------------------------------------------------

def _sample_trilinear(field, weight, p, origin, leaf):
    """Trilinear sample of ``field`` ([X,Y,Z] or [X,Y,Z,C]) at world points
    [R, 3]. Returns (values [R] or [R, C], valid [R]); valid needs all 8
    support voxels observed (weight > 0) and in bounds."""
    X, Y, Z = field.shape[:3]
    chan = field.dim() == 4
    g = (p - origin) / leaf
    g0 = torch.floor(g)
    f = g - g0
    i0 = g0.to(torch.int32)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.int32,
                      device=p.device)
    ok = ((i0 >= 0) & (i0 < hi)).all(dim=-1)
    i0c = torch.minimum(torch.clamp(i0, min=0), hi - 1).long()
    vals = 0.0
    wmin = None
    ff = field.reshape(-1, field.shape[-1]) if chan else field.reshape(-1)
    wf = weight.reshape(-1)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                flat = ((i0c[:, 0] + dx) * Y + (i0c[:, 1] + dy)) * Z \
                    + (i0c[:, 2] + dz)
                wgt = ((f[:, 0] if dx else 1 - f[:, 0])
                       * (f[:, 1] if dy else 1 - f[:, 1])
                       * (f[:, 2] if dz else 1 - f[:, 2]))
                v = ff[flat]
                vals = vals + (wgt[:, None] * v if chan else wgt * v)
                wmin = wf[flat] if wmin is None else torch.minimum(wmin,
                                                                   wf[flat])
    return vals, ok & (wmin > 0.0)


def _nan_field(vol: TSDFVolume) -> torch.Tensor:
    """Flat tsdf with NaN where never observed (weight == 0): one read per
    sample instead of two, and NaN compares False in the march logic."""
    return torch.where(vol.weight > 0.0, vol.tsdf, math.nan).reshape(-1)


def _sample_nearest_soa(flat_field, shape, gx, gy, gz):
    """Nearest sample of a NaN-masked flat field at grid coords (SoA); NaN
    for out-of-volume or never-observed."""
    X, Y, Z = shape
    ix = torch.round(gx).to(torch.int32)
    iy = torch.round(gy).to(torch.int32)
    iz = torch.round(gz).to(torch.int32)
    inside = ((ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
              & (iz >= 0) & (iz < Z))
    flat = ((torch.clamp(ix, 0, X - 1) * Y + torch.clamp(iy, 0, Y - 1)) * Z
            + torch.clamp(iz, 0, Z - 1)).long()
    return torch.where(inside, flat_field[flat], math.nan)


def _cell_corners_soa(flat_field, shape, gx, gy, gz):
    """The 8 cell corners + interpolation fractions at grid coords:
    (corners [2][2][2], fx, fy, fz), NaN corners for out-of-volume cells."""
    X, Y, Z = shape
    g0x, g0y, g0z = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx_, fy_, fz_ = gx - g0x, gy - g0y, gz - g0z
    i0x, i0y, i0z = (g0x.to(torch.int32), g0y.to(torch.int32),
                     g0z.to(torch.int32))
    ok = ((i0x >= 0) & (i0x < X - 1) & (i0y >= 0) & (i0y < Y - 1)
          & (i0z >= 0) & (i0z < Z - 1))
    i0x = torch.clamp(i0x, 0, X - 2)
    i0y = torch.clamp(i0y, 0, Y - 2)
    i0z = torch.clamp(i0z, 0, Z - 2)
    c = [[[None, None], [None, None]], [[None, None], [None, None]]]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                flat = (((i0x + dx) * Y + (i0y + dy)) * Z
                        + (i0z + dz)).long()
                c[dx][dy][dz] = torch.where(ok, flat_field[flat], math.nan)
    return c, fx_, fy_, fz_


def _trilinear_from_corners(c, fx_, fy_, fz_):
    """Trilinear value from _cell_corners_soa output (NaN-propagating)."""
    val = torch.zeros_like(fx_)
    for dx in (0, 1):
        wx = fx_ if dx else 1.0 - fx_
        for dy in (0, 1):
            wy = fy_ if dy else 1.0 - fy_
            for dz in (0, 1):
                wz = fz_ if dz else 1.0 - fz_
                val = torch.addcmul(val, wx * wy * wz, c[dx][dy][dz])
    return val


def _sample_trilinear_soa(flat_field, shape, gx, gy, gz):
    """Trilinear sample (SoA, NaN-masked): 8 random reads."""
    c, fx_, fy_, fz_ = _cell_corners_soa(flat_field, shape, gx, gy, gz)
    return _trilinear_from_corners(c, fx_, fy_, fz_)


# SoA mirror of ops.deproject.project for ONE camera: (u, v, in_front)
_project_soa = project_planes


# --------------------------------------------------------------------------
# ray casting
# --------------------------------------------------------------------------

class RaycastResult(NamedTuple):
    """Per-pixel model view rendered from the volume (world frame)."""

    depth: torch.Tensor            # [h, w] f32 z-depth in the camera frame
    vertex: torch.Tensor           # [h, w, 3] f32 world-frame hit points
    normal: torch.Tensor           # [h, w, 3] f32 world-frame normals
    valid: torch.Tensor            # [h, w] bool: the ray found a surface
    rgb: Optional[torch.Tensor] = None  # [h, w, 3] f32 if the volume has rgb


def raycast(vol: TSDFVolume, intr: Intrinsics, extrinsics,
            t_min: float = 0.2, t_max: float = 8.0,
            step: float | None = None, stride: int = 1,
            prior_depth: Optional[torch.Tensor] = None,
            prior_window: float = 0.3,
            depth_scale: float = 0.001) -> RaycastResult:
    """Render the volume from ONE camera by marching rays to the zero level.

    Fixed-step march (nearest-voxel samples) + linear refinement at the
    sign change + one trilinear secant step + trilinear-gradient normals
    (the KinFu renderer). ``step`` defaults to half the truncation band
    (read from the device once). ``stride`` renders every stride-th pixel.
    ``prior_depth`` [H, W] (raw integer units or meters) limits each ray to
    ±``prior_window`` around its pixel's live depth (the tracking regime);
    rays with an invalid live pixel march the window from t_min.
    """
    if step is None:
        step = 0.5 * float(vol.trunc)
    dev = vol.device
    ext = torch.as_tensor(extrinsics).to(device=dev, dtype=_F32)
    intr = intr.to(dev)
    if prior_depth is None:
        n_steps = max(2, int(np.ceil((t_max - t_min) / step)))
        prior = None
    else:
        n_steps = max(2, int(np.ceil(2.0 * prior_window / step)) + 2)
        h = -(-int(intr.height) // stride)
        w = -(-int(intr.width) // stride)
        d = torch.as_tensor(prior_depth).to(dev)[::stride, ::stride][:h, :w]
        prior = d.to(_F32) * (1.0 if d.is_floating_point()
                              else scalar(depth_scale, vol.tsdf))
    return _raycast(vol, intr, ext, scalar(t_min, vol.tsdf),
                    scalar(step, vol.tsdf), prior,
                    scalar(prior_window, vol.tsdf), n_steps, int(stride))


def _raycast(vol: TSDFVolume, intr: Intrinsics, extrinsics, t_min, step,
             prior, window, n_steps: int, stride: int) -> RaycastResult:
    """SoA renderer: one NaN-masked field read per sample, crossing logic
    on NaN-compare semantics, normals from the 32-node lattice around the
    hit cell."""
    h = -(-intr.height // stride)
    w = -(-intr.width // stride)
    dev = vol.device
    intr_s = _strided_intr(intr, stride, h, w)
    # unit-depth deprojection = per-pixel ray direction incl. distortion
    dirs_cam = deproject(torch.ones((h, w), dtype=_F32, device=dev), intr_s,
                         depth_scale=1.0).xyz                 # [h*w, 3]
    x, y, z = dirs_cam[:, 0], dirs_cam[:, 1], dirs_cam[:, 2]
    # the norm is a reduction in XLA: fma(z, z, fma(y, y, x * x))
    dir_norm = _sqrt(torch.addcmul(torch.addcmul(x * x, y, y), z, z))
    dcx, dcy, dcz = x / dir_norm, y / dir_norm, z / dir_norm   # unit rays
    R = extrinsics[:3, :3]
    o_w = extrinsics[:3, 3]
    dwx, dwy, dwz = (_fma3(R[i, 0], dcx, R[i, 1], dcy, R[i, 2], dcz)
                     for i in range(3))
    nray = h * w

    if prior is None:
        t_start = torch.full((nray,), 1.0, dtype=_F32, device=dev) * t_min
    else:
        d_live = prior.reshape(-1)
        t_live = d_live / torch.clamp(dcz, min=1e-6)
        t_start = torch.where(d_live > 0.0,
                              torch.maximum(t_live - window, t_min), t_min)

    field = _nan_field(vol)
    shape = vol.shape
    ox, oy, oz = vol.origin[0], vol.origin[1], vol.origin[2]
    leaf = vol.leaf

    def grid_coords(t):
        gx = (torch.addcmul(o_w[0], dwx, t) - ox) / leaf
        gy = (torch.addcmul(o_w[1], dwy, t) - oy) / leaf
        gz = (torch.addcmul(o_w[2], dwz, t) - oz) / leaf
        return gx, gy, gz

    prev_val = torch.full((nray,), math.nan, dtype=_F32, device=dev)
    hit_t = torch.zeros((nray,), dtype=_F32, device=dev)
    found = torch.zeros((nray,), dtype=torch.bool, device=dev)
    for k in range(n_steps):
        t = t_start + step * float(k)      # XLA keeps these two unfused
        val = _sample_nearest_soa(field, shape, *grid_coords(t))
        # NaN (outside / unobserved) compares False on both sides, so an
        # unobserved sample can neither open nor close a crossing
        cross = (prev_val > 0.0) & (val <= 0.0) & ~found
        frac = prev_val / torch.clamp(prev_val - val, min=1e-12)
        t_cross = torch.addcmul(t - step, step, torch.clamp(frac, 0.0, 1.0))
        hit_t = torch.where(cross, t_cross, hit_t)
        found = found | cross
        prev_val = val

    # one trilinear secant refinement half a step either side
    hs = 0.5 * step
    v_a = _sample_trilinear_soa(field, shape, *grid_coords(hit_t - hs))
    v_b = _sample_trilinear_soa(field, shape, *grid_coords(hit_t + hs))
    denom = v_a - v_b
    tr = torch.clamp(v_a / torch.where(torch.abs(denom) < 1e-12, 1e-12,
                                       denom), 0.0, 1.0)
    refine_ok = v_a >= v_b            # False when either side is NaN
    t_ref = torch.addcmul(hit_t - hs, 2.0 * hs, tr)
    hit_t = torch.where(found & refine_ok, t_ref, hit_t)

    # normals: central differences of trilinear samples one leaf apart,
    # all six from one shared 32-node corner lattice around the hit cell
    gx, gy, gz = grid_coords(hit_t)
    X, Y, Z = shape
    g0x, g0y, g0z = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx_, fy_, fz_ = gx - g0x, gy - g0y, gz - g0z
    i0x, i0y, i0z = (g0x.to(torch.int32), g0y.to(torch.int32),
                     g0z.to(torch.int32))
    okc = ((i0x >= 0) & (i0x < X - 1) & (i0y >= 0) & (i0y < Y - 1)
           & (i0z >= 0) & (i0z < Z - 1))
    b0x = torch.clamp(i0x, 0, X - 2)
    b0y = torch.clamp(i0y, 0, Y - 2)
    b0z = torch.clamp(i0z, 0, Z - 2)

    def node(dx, dy, dz):
        ix, iy, iz = b0x + dx, b0y + dy, b0z + dz
        ok = (okc & (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
              & (iz >= 0) & (iz < Z))
        flat = ((torch.clamp(ix, 0, X - 1) * Y + torch.clamp(iy, 0, Y - 1))
                * Z + torch.clamp(iz, 0, Z - 1)).long()
        return torch.where(ok, field[flat], math.nan)

    nd = {}
    for dx in (-1, 0, 1, 2):
        for dy in (0, 1):
            for dz in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)
    for dy in (-1, 2):
        for dx in (0, 1):
            for dz in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)
    for dz in (-1, 2):
        for dx in (0, 1):
            for dy in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)

    def tri(sx, sy, sz):
        # trilinear sample at the hit fractions, cell shifted one leaf
        val = torch.zeros_like(fx_)
        for dx in (0, 1):
            wx = fx_ if dx else 1.0 - fx_
            for dy in (0, 1):
                wy = fy_ if dy else 1.0 - fy_
                for dz in (0, 1):
                    wz = fz_ if dz else 1.0 - fz_
                    val = torch.addcmul(val, wx * wy * wz,
                                        nd[(dx + sx, dy + sy, dz + sz)])
        return val

    nx = tri(1, 0, 0) - tri(-1, 0, 0)
    ny = tri(0, 1, 0) - tri(0, -1, 0)
    nz = tri(0, 0, 1) - tri(0, 0, -1)
    gvalid = ~torch.isnan(nx + ny + nz)  # any NaN node poisons the sums
    nn_ = _sqrt(_fma3(nx, nx, ny, ny, nz, nz))
    nrm = torch.clamp(nn_, min=1e-12)
    nx, ny, nz = nx / nrm, ny / nrm, nz / nrm
    # flip stragglers toward the camera (a consistent hemisphere)
    flip = _fma3(nx, dwx, ny, dwy, nz, dwz) > 0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)
    valid = found & gvalid & (nn_ > 1e-9)

    z_cam = hit_t * dcz                                       # z-depth
    phx = torch.addcmul(o_w[0], dwx, hit_t)
    phy = torch.addcmul(o_w[1], dwy, hit_t)
    phz = torch.addcmul(o_w[2], dwz, hit_t)
    rgb = None
    if vol.rgb is not None:
        rgb_v, _ = _sample_trilinear(vol.rgb, vol.weight,
                                     torch.stack([phx, phy, phz], dim=-1),
                                     vol.origin, vol.leaf)
        rgb = torch.where(valid[:, None], rgb_v, 0.0).reshape(h, w, 3)

    def vm(a):
        return torch.where(valid, a, 0.0)

    return RaycastResult(
        depth=vm(z_cam).reshape(h, w),
        vertex=torch.stack([vm(phx), vm(phy), vm(phz)],
                           dim=-1).reshape(h, w, 3),
        normal=torch.stack([vm(nx), vm(ny), vm(nz)],
                           dim=-1).reshape(h, w, 3),
        valid=valid.reshape(h, w),
        rgb=rgb)


def _strided_intr(intr: Intrinsics, stride: int, h: int, w: int
                  ) -> Intrinsics:
    """Intrinsics for the every-``stride``-th-pixel image: fx' = fx/stride,
    ppx' = ppx/stride."""
    if stride == 1 and (h, w) == (intr.height, intr.width):
        return intr
    s = float(stride)
    return intr.replace(fx=intr.fx / s, fy=intr.fy / s, ppx=intr.ppx / s,
                        ppy=intr.ppy / s, width=w, height=h)


# --------------------------------------------------------------------------
# frame-to-model tracking (projective point-to-plane ICP)
# --------------------------------------------------------------------------

class TrackResult(NamedTuple):
    T: torch.Tensor             # [4, 4] refined camera→world
    rms: torch.Tensor           # point-to-plane RMS over inliers (m)
    n_matched: torch.Tensor     # inlier count at the last iteration


def track(vol: TSDFVolume, depth: torch.Tensor, intr: Intrinsics,
          T_init, iterations: int = 6, rounds: int = 2,
          depth_scale: float = 0.001, dist_gate: float = 0.1,
          normal_gate: float = 0.5, stride: int = 2,
          t_min: float = 0.2, t_max: float = 8.0,
          prior_window: Optional[float] = None) -> TrackResult:
    """Refine a camera pose against the volume (KinFu frame-to-model).

    Each of ``rounds`` ray-casts the model from the current estimate, then
    runs ``iterations`` Gauss–Newton steps of projective point-to-plane ICP
    (each live pixel projects into the model view: one gather, no NN
    search). ``prior_window`` opts into raycast's prior-depth band. Steps
    along twist directions whose eigenvalue is below 1e-5 of the largest
    are zeroed, so unobservable directions stay at the prior.
    """
    dev = vol.device
    depth = torch.as_tensor(depth).to(dev)
    T = torch.as_tensor(T_init).to(device=dev, dtype=_F32)
    res = None
    for _ in range(max(1, int(rounds))):
        model = raycast(vol, intr, T, t_min=t_min, t_max=t_max,
                        stride=stride,
                        prior_depth=None if prior_window is None else depth,
                        prior_window=prior_window or 0.0,
                        depth_scale=depth_scale)
        res = _track(depth, intr.to(dev), T, model,
                     float(depth_scale), scalar(dist_gate, T),
                     scalar(normal_gate, T), int(iterations), int(stride))
        T = res.T
    return res


def _track(depth, intr, T_init, model: RaycastResult, depth_scale,
           dist_gate, normal_gate, iterations: int,
           stride: int) -> TrackResult:
    h, w = model.depth.shape
    intr_s = _strided_intr(intr, stride, h, w)
    d_live = depth[::stride, ::stride][:h, :w]
    live = deproject(d_live, intr_s, depth_scale=depth_scale)  # cam frame
    p_live = live.xyz                                          # [h*w, 3]
    live_ok = live.mask & (p_live[:, 2] > 1e-6)

    # live normals from the organised grid (cross of image-axis tangents),
    # oriented toward the camera like the model's ray-cast normals
    pg = p_live.reshape(h, w, 3)
    du = torch.diff(pg, dim=1, append=pg[:, -1:, :])
    dv = torch.diff(pg, dim=0, append=pg[-1:, :, :])
    n_live = torch.linalg.cross(du, dv, dim=-1).reshape(-1, 3)
    n_norm = torch.linalg.vector_norm(n_live, dim=-1, keepdim=True)
    n_live = n_live / torch.clamp(n_norm, min=1e-12)
    n_live = torch.where((n_live * p_live).sum(-1, keepdim=True) > 0,
                         -n_live, n_live)
    n_ok = n_norm[:, 0] > 1e-12

    # SoA planes; the model's validity rides in its vertex-x plane as NaN
    vmx = torch.where(model.valid, model.vertex[..., 0],
                      math.nan).reshape(-1)
    vmy, vmz = (model.vertex[..., 1].reshape(-1),
                model.vertex[..., 2].reshape(-1))
    nmx, nmy, nmz = (model.normal[..., i].reshape(-1) for i in range(3))
    plx, ply, plz = p_live[:, 0], p_live[:, 1], p_live[:, 2]
    nlx, nly, nlz = n_live[:, 0], n_live[:, 1], n_live[:, 2]
    inv_init = se3_inverse(T_init)

    def rot(M, i, x, y, z):
        return _fma3(M[i, 0], x, M[i, 1], y, M[i, 2], z)

    T = T_init
    rms = n_in = None
    for _ in range(iterations):
        pwx, pwy, pwz = (rot(T, i, plx, ply, plz) + T[i, 3]
                         for i in range(3))
        nwx, nwy, nwz = (rot(T, i, nlx, nly, nlz) for i in range(3))
        # project into the model view, gather its vertex + normal there
        qx, qy, qz = (rot(inv_init, i, pwx, pwy, pwz) + inv_init[i, 3]
                      for i in range(3))
        u, v, in_front = _project_soa(qx, qy, qz, intr_s)
        ui = torch.round(u).to(torch.int32)
        vi = torch.round(v).to(torch.int32)
        pix_ok = in_front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        flat = (torch.clamp(vi, 0, h - 1) * w
                + torch.clamp(ui, 0, w - 1)).long()
        gvmx, gvmy, gvmz = vmx[flat], vmy[flat], vmz[flat]
        gnmx, gnmy, gnmz = nmx[flat], nmy[flat], nmz[flat]
        r = _fma3(gnmx, pwx - gvmx, gnmy, pwy - gvmy, gnmz, pwz - gvmz)
        ok = (live_ok & n_ok & pix_ok
              & (_fma3(nwx, gnmx, nwy, gnmy, nwz, gnmz) > normal_gate)
              & (torch.abs(r) < dist_gate))   # NaN r compares False
        wgt = ok.to(_F32)
        r = torch.where(ok, r, 0.0)
        # J = [p_w x n_m, n_m] as six planes; A = Jᵀ W J
        Jt = torch.stack([torch.addcmul(-(pwz * gnmy), pwy, gnmz),
                          torch.addcmul(-(pwx * gnmz), pwz, gnmx),
                          torch.addcmul(-(pwy * gnmx), pwx, gnmy),
                          gnmx, gnmy, gnmz], dim=0)            # [6, N]
        Jt = torch.where(ok[None, :], Jt, 0.0)
        A = mm(Jt * wgt[None, :], Jt.T)                        # [6, 6]
        b = -mm(Jt, (wgt * r)[:, None])[:, 0]
        n_in = wgt.sum()
        # solve in the eigenbasis, zeroing the step along directions the
        # scene cannot observe (eigenvalue < 1e-5 of the largest)
        evals, evecs = torch.linalg.eigh(A)
        lam_max = torch.clamp(evals[-1], min=1e-12)
        keep = evals > 1e-5 * lam_max
        coef = torch.where(keep, mm(evecs.T, b[:, None])[:, 0]
                           / torch.clamp(evals, min=1e-12), 0.0)
        xi = mm(evecs, coef[:, None])[:, 0]
        dT = se3_from_rt(so3_exp(xi[:3]), xi[3:])
        T = se3_compose(dT, T)
        rms = torch.sqrt((wgt * r * r).sum() / torch.clamp(n_in, min=1.0))
    return TrackResult(T=T, rms=rms, n_matched=n_in.to(torch.int32))


class RigTrackResult(NamedTuple):
    extrinsics: torch.Tensor   # [ncam, 4, 4] corrected rig (== input if gated)
    G: torch.Tensor            # [4, 4] world-frame correction (I if gated)
    applied: bool              # the correction passed every gate
    track: TrackResult         # the anchor camera's frame-to-model result


def rig_track(vol: TSDFVolume, depth: torch.Tensor, intr: Intrinsics,
              extrinsics, cam: int = 0, depth_scale: float = 0.001,
              prior_window: Optional[float] = 0.3,
              min_matched: int = 300, max_rms: float = 0.05,
              max_step: float = 0.5, max_step_rot: float = 0.5,
              **track_kw) -> RigTrackResult:
    """Correct a whole rig from the volume: track camera ``cam`` against
    it, lift the single-camera correction ``G = T_tracked @ T_est^-1`` to
    every camera (the rigid-rig assumption), and apply it only if it passes
    the gates (``min_matched`` pixels, ``max_rms`` fit, a step below
    ``max_step`` m / ``max_step_rot`` rad). The gates read host scalars;
    ``applied`` is a host bool. ``**track_kw`` goes to :func:`track`."""
    dev = vol.device
    ext = torch.as_tensor(extrinsics).to(device=dev, dtype=_F32)
    squeeze = ext.dim() == 2
    if squeeze:
        ext = ext[None]
    depth = torch.as_tensor(depth).to(dev)
    d = depth if depth.dim() == 3 else depth[None]
    intr_c = _cam_slice(intr, cam) if intr.fx.dim() else intr
    T_est = ext[cam]
    res = track(vol, d[cam], intr_c, T_est, depth_scale=depth_scale,
                prior_window=prior_window, **track_kw)
    G = mm(res.T, se3_inverse(T_est))
    dt = float(torch.linalg.vector_norm(G[:3, 3]))
    cos_th = (float(torch.trace(G[:3, :3])) - 1.0) * 0.5
    ang = math.acos(min(1.0, max(-1.0, cos_th)))
    ok = (int(res.n_matched) >= int(min_matched)
          and float(res.rms) <= float(max_rms)
          and math.isfinite(dt) and dt <= float(max_step)
          and ang <= float(max_step_rot))
    if ok:
        out = mm(G[None], ext)
    else:
        out, G = ext, torch.eye(4, dtype=_F32, device=dev)
    return RigTrackResult(extrinsics=out[0] if squeeze else out,
                          G=G, applied=ok, track=res)


# --------------------------------------------------------------------------
# extraction / persistence
# --------------------------------------------------------------------------

def extract_cloud(vol: TSDFVolume, capacity: int, band: float = 0.5,
                  min_weight: float = 1.0) -> PointCloud:
    """Near-surface voxels (|tsdf| <= band, weight >= min_weight) as a
    ``capacity``-slot PointCloud, in voxel order."""
    near = ((torch.abs(vol.tsdf) <= scalar(band, vol.tsdf))
            & (vol.weight >= scalar(min_weight, vol.tsdf))).reshape(-1)
    sel = nonzero_static(near, capacity)
    n = near.sum(dtype=torch.int32)
    ok = torch.arange(capacity, device=vol.device) < n
    p = torch.stack([c[sel] for c in _voxel_centers(vol.shape, vol.origin,
                                                    vol.leaf)], dim=-1)
    rgb = None
    if vol.rgb is not None:
        rgb = torch.where(ok[:, None], vol.rgb.reshape(-1, 3)[sel], 0.0)
    return PointCloud(xyz=torch.where(ok[:, None], p, 0.0), mask=ok, rgb=rgb)


def extract_mesh(vol: TSDFVolume, cell_capacity: int,
                 min_weight: float = 1.0):
    """Marching-tetrahedra mesh of the TSDF zero level (the negated field,
    unobserved nodes masked). Returns ``(verts [3, 3, T], valid [T],
    n_active)`` as ``ops.surface.marching_tetrahedra`` does; weld with
    ``ops.surface.weld_mesh``."""
    return marching_tetrahedra(-vol.tsdf, 0.0, cell_capacity,
                               origin=vol.origin, leaf=vol.leaf,
                               node_valid=vol.weight >= scalar(min_weight,
                                                               vol.tsdf))


def save_volume(path: str, vol: TSDFVolume) -> None:
    """Persist the volume (``.npz``, the JAX package's keys, version 1)."""
    keys = ("tsdf", "weight", "origin", "leaf", "trunc") + (
        () if vol.rgb is None else ("rgb",))
    arrs = {k: getattr(vol, k).detach().cpu().numpy() for k in keys}
    arrs["version"] = np.int32(1)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrs)


def load_volume(path: str, device=None) -> TSDFVolume:
    """Load a ``save_volume`` checkpoint (the port's or the JAX
    package's) onto ``device`` (default ``platform_device()``)."""
    from ..utils.convert import tsdf_volume_from_numpy
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        if int(z["version"]) != 1:
            raise ValueError(
                f"unknown tsdf checkpoint version {z['version']}")
        arrays = {k: z[k] for k in z.files if k != "version"}
    return tsdf_volume_from_numpy(
        arrays, platform_device() if device is None else device)
