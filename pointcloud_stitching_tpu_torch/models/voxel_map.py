"""Temporal voxel map: a persistent world model on the device.

Port of ``pointcloud_stitching_tpu/models/voxel_map.py``. The map is three
dense tensors of a fixed capacity (``ijk`` absolute biased voxel indices,
sentinel-marked empty slots; ``sums`` weighted coordinate sums;
``weight`` evidence; optional ``rgb_sums``) and its update is one sort and
one segment sum, the machinery of the per-frame voxel grid
(``ops/voxel.py``):

  * decay the map's weights and sums, evict slots below ``min_weight``;
  * concatenate the map's rows with the incoming cloud's rows (absolute
    voxel index, unit weight), sort them by voxel key, and sum each run of
    equal keys with kernel K1 (``kernels/segment_reduce.py``
    ``segment_sum_from_flags``) into the new map; voxels past the capacity
    drop in ascending key order.

Keys are absolute (a fixed world-origin bias), so successive frames agree
on voxel identity: at a 1 cm leaf the map spans ±163 m in x and ±327 m in
y and z; points outside are dropped. The sort is on one int64 key
``(k1 << 32) | kz``, stable, so the result does not depend on the sort.

The update makes no host sync: scalars are filled in on the device
(``utils.types.scalar``) and nothing is read back, so a stream can enqueue
its map update behind the stitch step. K1 adds in float64 and rounds each
sum to float32 once (the JAX package adds in float32): port and JAX agree
to float32 rounding, not bit for bit; kernel and plain version agree bit
for bit while the float64 sums are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.segment_reduce import segment_sum_from_flags
from ..ops.icp import ICPResult, icp
from ..ops.voxel import _SENTINEL, _prev
from ..utils.platform import platform_device
from ..utils.types import PointCloud, scalar

# per-axis index bias and largest biased index: x packs into the upper half
# of the 31-bit key k1 = ix * 65536 + iy (15 bits), y and z get 16 bits
_BIAS = (16384, 32768, 32768)
_BOUND = (32766, 65534, 65534)

_F32 = torch.float32


@dataclasses.dataclass
class VoxelMap:
    """Fixed-capacity persistent voxel map (see the module docstring).

    ijk:      [cap, 3] int32 absolute biased indices, _SENTINEL = empty
    sums:     [cap, 3] f32 weighted xyz sums
    weight:   [cap] f32 evidence weight
    leaf:     0-d f32 voxel edge (meters): it rides in the state, so a map
              is never updated under another grid than it was built with
    rgb_sums: [cap, 3] f32 weighted colour sums, or None

    Every tensor lives on one device.
    """

    ijk: torch.Tensor
    sums: torch.Tensor
    weight: torch.Tensor
    leaf: torch.Tensor
    rgb_sums: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.ijk.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ijk.device

    def replace(self, **changes) -> "VoxelMap":
        return dataclasses.replace(self, **changes)

    def count(self) -> torch.Tensor:
        """Occupied-voxel count (0-d int32 on the device)."""
        return (self.ijk[:, 0] != _SENTINEL).sum(dtype=torch.int32)

    @classmethod
    def create(cls, capacity: int, leaf: float, with_rgb: bool = False,
               device=None) -> "VoxelMap":
        """An empty map of ``capacity`` slots. ``device`` defaults to
        ``platform_device()`` (the first GPU, or the CPU only when
        ``PCS_PLATFORM=cpu``)."""
        dev = platform_device() if device is None else torch.device(device)
        return cls(
            ijk=torch.full((capacity, 3), _SENTINEL, dtype=torch.int32,
                           device=dev),
            sums=torch.zeros((capacity, 3), dtype=_F32, device=dev),
            weight=torch.zeros((capacity,), dtype=_F32, device=dev),
            leaf=torch.full((), float(leaf), dtype=_F32, device=dev),
            rgb_sums=(torch.zeros((capacity, 3), dtype=_F32, device=dev)
                      if with_rgb else None))

    def as_cloud(self, min_weight=0.0) -> PointCloud:
        """The map as a PointCloud of weight-averaged centroids; voxels
        below ``min_weight`` are masked (not evicted)."""
        occ = (self.ijk[:, 0] != _SENTINEL) & (self.weight > 0.0)
        keep = occ & (self.weight >= scalar(min_weight, self.weight))
        denom = torch.clamp(self.weight, min=1e-12)[:, None]
        xyz = torch.where(keep[:, None], self.sums / denom, 0.0)
        rgb = None
        if self.rgb_sums is not None:
            rgb = torch.where(keep[:, None], self.rgb_sums / denom, 0.0)
        return PointCloud(xyz=xyz, mask=keep, rgb=rgb)


def _biased_ijk(xyz: torch.Tensor, inv: torch.Tensor):
    """(ijk [..., 3] int32 = floor(p * inv) + bias, in-bounds mask). The
    bias is added per axis as Python ints: a constant copied from the
    host would wait for the device's queue."""
    f = torch.floor(xyz * inv).to(torch.int32)
    ijk = torch.stack([f[..., a] + _BIAS[a] for a in range(3)], dim=-1)
    ok = torch.ones_like(ijk[..., 0], dtype=torch.bool)
    for a in range(3):
        ok = ok & (ijk[..., a] >= 0) & (ijk[..., a] <= _BOUND[a])
    return ijk, ok


def _keys_from_ijk(ijk: torch.Tensor):
    """(k1, kz) lexicographic sort keys from biased per-axis indices."""
    invalid = ijk[:, 0] == _SENTINEL
    k1 = torch.where(invalid, _SENTINEL, ijk[:, 0] * 65536 + ijk[:, 1])
    kz = torch.where(invalid, _SENTINEL, ijk[:, 2])
    return k1, kz


def _sort_key(k1: torch.Tensor, kz: torch.Tensor) -> torch.Tensor:
    """The (k1, kz) pair as one int64 key; both halves are >= 0."""
    return (k1.to(torch.int64) << 32) | kz.to(torch.int64)


def _merge_rows(vmap: VoxelMap, cloud: PointCloud, decay, min_weight):
    """The map's decayed rows and the cloud's rows, sorted by voxel key:
    (flags [cap+N] bool, vals [cap+N, 7 or 10] f32) for K1, with channels
    [ix·flag, iy·flag, iz·flag, sx, sy, sz, w] (+ [r, g, b] sums)."""
    like = vmap.sums
    decay = scalar(decay, like)
    min_w = scalar(min_weight, like)

    # decay + evict the map's rows
    w = vmap.weight * decay
    live = (vmap.ijk[:, 0] != _SENTINEL) & (w >= min_w)
    map_ijk = torch.where(live[:, None], vmap.ijk, _SENTINEL)
    map_sums = torch.where(live[:, None], vmap.sums * decay, 0.0)
    map_w = torch.where(live, w, 0.0)

    # incoming points -> absolute biased voxel indices, unit weight
    pij, in_bounds = _biased_ijk(cloud.xyz, 1.0 / vmap.leaf)
    ok = cloud.mask & in_bounds
    new_ijk = torch.where(ok[:, None], pij, _SENTINEL)
    new_sums = torch.where(ok[:, None], cloud.xyz, 0.0)
    new_w = ok.to(_F32)

    k1, kz = _keys_from_ijk(torch.cat([map_ijk, new_ijk]))
    chans = [torch.cat([map_sums, new_sums]),
             torch.cat([map_w, new_w])[:, None]]
    if vmap.rgb_sums is not None:
        chans.append(torch.cat([vmap.rgb_sums * live[:, None] * decay,
                                cloud.rgb * new_w[:, None]]))
    vals_in = torch.cat(chans, dim=-1)                   # [cap+N, 4(+3)]
    skey, perm = torch.sort(_sort_key(k1, kz), stable=True)
    svals = vals_in[perm]

    sk1 = skey >> 32
    valid = sk1 != _SENTINEL
    flags = (skey != _prev(skey)) & valid
    # per-axis indices on each run's first row only (flag-masked: one
    # contribution survives the sum); they are <= 65534, exact in f32
    sk1v = torch.where(valid, sk1, 0)
    ix, iy = sk1v // 65536, sk1v % 65536
    iz = torch.where(valid, skey & 0xFFFFFFFF, 0)
    idx_ch = torch.stack([ix, iy, iz], dim=-1).to(_F32) * flags.to(
        _F32)[:, None]
    vals = torch.cat([idx_ch, torch.where(valid[:, None], svals, 0.0)],
                     dim=-1)                             # [cap+N, 7(+3)]
    return flags, vals


def _finish(sums: torch.Tensor, leaf: torch.Tensor, max_weight,
            has_rgb: bool) -> VoxelMap:
    """The new map from K1's [cap, 7 or 10] sums; weights above
    ``max_weight`` rescale with their sums (the mean is kept)."""
    out_w = sums[:, 6]
    occ = out_w > 0.0
    out_ijk = torch.where(occ[:, None], torch.round(sums[:, :3]).to(
        torch.int32), _SENTINEL)
    max_w = scalar(max_weight, sums)
    scale = torch.where(out_w > max_w, max_w / torch.clamp(out_w, min=1e-12),
                        1.0)
    return VoxelMap(ijk=out_ijk, sums=sums[:, 3:6] * scale[:, None],
                    weight=out_w * scale, leaf=leaf,
                    rgb_sums=(sums[:, 7:10] * scale[:, None] if has_rgb
                              else None))


def voxel_map_update(vmap: VoxelMap, cloud: PointCloud, decay=1.0,
                     min_weight=0.05, max_weight=float("inf"),
                     impl: str = "auto", interpret: bool = False) -> VoxelMap:
    """Merge one world-frame cloud into the map; returns the new map.

    Args:
      vmap: the current map.
      cloud: world-frame points ([N, 3] xyz + mask, and rgb iff the map was
        created ``with_rgb``), typically a ``StitchOutput.cloud``; the sort
        merges duplicates whatever the input.
      decay: per-update multiplicative weight decay (1.0 = never forget;
        0.98 at 30 Hz forgets in ~1.7 s); sums decay with the weights.
      min_weight: decayed slots below this are evicted.
      max_weight: cap on a voxel's evidence (its sums rescale to keep the
        mean); inf = pure accumulation.
      impl: K1's backend, 'auto' | 'cuda' | 'torch' (as ``voxel_downsample``).
      interpret: taken at the JAX package's position and ignored (Pallas's
        interpreter; the port's CPU path is K1's plain version).

    Scalars may be Python numbers or 0-d tensors; no host sync is made.
    Occupied voxels past the capacity drop in ascending key order.
    """
    if (cloud.rgb is not None) != (vmap.rgb_sums is not None):
        raise ValueError("cloud rgb presence must match map rgb presence")
    flags, vals = _merge_rows(vmap, cloud, decay, min_weight)
    sums = segment_sum_from_flags(vals, flags, vmap.capacity, impl=impl)
    return _finish(sums, vmap.leaf, max_weight, vmap.rgb_sums is not None)


def save_map(path: str, vmap: VoxelMap) -> None:
    """Persist the full map state as a resumable ``.npz`` checkpoint (the
    JAX package's keys, version 1; an extensionless path gets ``.npz``)."""
    arrs = {k: getattr(vmap, k).detach().cpu().numpy()
            for k in ("ijk", "sums", "weight", "leaf")}
    arrs["version"] = np.int32(1)
    if vmap.rgb_sums is not None:
        arrs["rgb_sums"] = vmap.rgb_sums.detach().cpu().numpy()
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrs)


def load_map(path: str, capacity: int | None = None,
             device=None) -> VoxelMap:
    """Load a ``save_map`` checkpoint (the port's or the JAX package's)
    onto ``device`` (default ``platform_device()``).

    ``capacity`` resizes on load: a larger map pads with empty slots, a
    smaller one keeps the highest-weight voxels (stable order).
    """
    from ..utils.convert import voxel_map_from_numpy
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        if int(z["version"]) != 1:
            raise ValueError(f"unknown map checkpoint version {z['version']}")
        a = {"ijk": z["ijk"].astype(np.int32),
             "sums": z["sums"].astype(np.float32),
             "weight": z["weight"].astype(np.float32),
             "leaf": np.float32(z["leaf"]),
             "rgb_sums": (z["rgb_sums"].astype(np.float32)
                          if "rgb_sums" in z else None)}
    cap0 = a["ijk"].shape[0]
    if capacity is not None and capacity > cap0:
        pad = capacity - cap0
        fill = {"ijk": np.full((pad, 3), _SENTINEL, np.int32),
                "sums": np.zeros((pad, 3), np.float32),
                "weight": np.zeros((pad,), np.float32),
                "rgb_sums": np.zeros((pad, 3), np.float32)}
        for k, v in fill.items():
            if a[k] is not None:
                a[k] = np.concatenate([a[k], v])
    elif capacity is not None and capacity < cap0:
        keep = np.argsort(-a["weight"], kind="stable")[:capacity]
        for k in ("ijk", "sums", "weight", "rgb_sums"):
            if a[k] is not None:
                a[k] = a[k][keep]
    return voxel_map_from_numpy(
        a, platform_device() if device is None else device)


def localize(vmap: VoxelMap, cloud: PointCloud,
             init_T: torch.Tensor | None = None, iterations: int = 10,
             max_corr_dist=0.1, min_weight=0.0,
             nn_impl: str = "auto") -> ICPResult:
    """Register a cloud against the accumulated map (ICP with the map's
    centroids as the reference): the cloud->map transform."""
    return icp(cloud, vmap.as_cloud(min_weight), init_T=init_T,
               iterations=iterations, max_corr_dist=max_corr_dist,
               nn_impl=nn_impl)


class TemporalAccumulator:
    """Holds a map and feeds it stitched clouds::

        acc = TemporalAccumulator(capacity=2**20, leaf=0.01, decay=0.98)
        ...
        def on_frame(i, out):              # MulticameraClient callback
            acc.update(out.cloud)
        snapshot = acc.cloud()             # denoised accumulated scene
    """

    def __init__(self, capacity: int, leaf: float, decay: float = 1.0,
                 min_weight: float = 0.05, max_weight: float = float("inf"),
                 with_rgb: bool = False, impl: str = "auto",
                 interpret: bool = False, device=None):
        """The JAX package's parameters at its positions (``interpret`` is
        taken and ignored); ``device`` defaults to ``platform_device()``."""
        self.state = VoxelMap.create(capacity, leaf, with_rgb=with_rgb,
                                     device=device)
        self._decay = decay
        self._min_weight = min_weight
        self._max_weight = max_weight
        self._impl = impl

    def update(self, cloud: PointCloud) -> None:
        """Absorb one world-frame cloud."""
        self.state = voxel_map_update(self.state, cloud, self._decay,
                                      self._min_weight, self._max_weight,
                                      impl=self._impl)

    def cloud(self, min_weight=0.0) -> PointCloud:
        return self.state.as_cloud(min_weight)

    def localize(self, cloud: PointCloud, **kw) -> ICPResult:
        return localize(self.state, cloud, **kw)

    def save(self, path: str) -> None:
        """Checkpoint the accumulation state (see ``save_map``)."""
        save_map(path, self.state)

    @classmethod
    def load(cls, path: str, capacity: int | None = None,
             decay: float = 1.0, min_weight: float = 0.05,
             max_weight: float = float("inf"), impl: str = "auto",
             interpret: bool = False,
             device=None) -> "TemporalAccumulator":
        """Resume from a ``save`` checkpoint: ``leaf`` and colour come from
        the file, the update policy is passed fresh (``interpret`` is
        taken at the JAX package's position and ignored)."""
        acc = cls.__new__(cls)
        acc.state = load_map(path, capacity=capacity, device=device)
        acc._decay = decay
        acc._min_weight = min_weight
        acc._max_weight = max_weight
        acc._impl = impl
        return acc
