"""Spatial change detection: which query points occupy voxels that the
reference never touched.

Port of ``pointcloud_stitching_tpu/ops/change.py`` (the role of
``pcl::OctreePointCloudChangeDetector``). Both clouds are hashed onto the
voxel map's absolute grid (``floor(p * (1/leaf)) + bias``, so the diff never
shifts with either cloud's extent), and the diff is one sort and a scan:

    sort [ref rows ++ query rows] by voxel key (one int64 key, stable)
    -> runs of equal keys
    -> per run: does it hold a reference row (scatter_reduce "amax")
    -> back to the query's slots

The result is a set question, so it does not depend on the sort's order:
port and JAX package give the same mask.
"""
from __future__ import annotations

import torch

from ..models.voxel_map import _biased_ijk, _keys_from_ijk, _sort_key
from ..utils.types import PointCloud, scalar
from .voxel import _SENTINEL


def _abs_keys(xyz: torch.Tensor, mask: torch.Tensor, leaf):
    """(k1, kz) keys on the absolute biased grid; sentinel for masked or
    out-of-range rows. Multiplies by the reciprocal leaf, as PCL does."""
    ijk, ok = _biased_ijk(xyz, 1.0 / scalar(leaf, xyz))
    return _keys_from_ijk(torch.where((mask & ok)[..., None], ijk, _SENTINEL))


def detect_changes(ref: PointCloud, query: PointCloud, leaf) -> torch.Tensor:
    """[Nq] bool: True where ``query.mask`` is set and the point's voxel
    (edge ``leaf``) holds no valid reference point. Capacities may differ;
    points outside the map's absolute grid are never reported."""
    rk1, rkz = _abs_keys(ref.xyz, ref.mask, leaf)
    return _diff_mask(rk1, rkz, query, leaf)


def detect_changes_map(vmap, query: PointCloud, min_weight=0.0
                       ) -> torch.Tensor:
    """``detect_changes`` against a ``models.voxel_map.VoxelMap``: its
    occupied voxels with at least ``min_weight`` evidence are the baseline,
    its leaf the resolution."""
    occ = ((vmap.ijk[:, 0] != _SENTINEL)
           & (vmap.weight >= scalar(min_weight, vmap.weight)))
    rk1, rkz = _keys_from_ijk(torch.where(occ[:, None], vmap.ijk, _SENTINEL))
    return _diff_mask(rk1, rkz, query, vmap.leaf)


def _diff_mask(rk1, rkz, query: PointCloud, leaf) -> torch.Tensor:
    qk1, qkz = _abs_keys(query.xyz, query.mask, leaf)
    nq = qk1.shape[0]
    dev = qk1.device
    key = _sort_key(torch.cat([rk1, qk1]), torch.cat([rkz, qkz]))
    is_ref = torch.cat([torch.ones_like(rk1), torch.zeros_like(qk1)])
    # query rows carry their slot, reference and invalid rows a drop slot
    slot = torch.cat([torch.full_like(rk1, nq),
                      torch.arange(nq, dtype=torch.int32, device=dev)])
    slot = torch.where(torch.cat([rk1, qk1]) == _SENTINEL, nq, slot)

    skey, perm = torch.sort(key, stable=True)
    sref, sslot = is_ref[perm], slot[perm].long()
    new_seg = torch.cat([torch.ones_like(skey[:1], dtype=torch.bool),
                         skey[1:] != skey[:-1]])
    seg = torch.cumsum(new_seg, 0) - 1
    has_ref = torch.zeros_like(sref).scatter_reduce(0, seg, sref, "amax")
    changed = (has_ref[seg] == 0) & ((skey >> 32) != _SENTINEL)

    out = torch.zeros((nq + 1,), dtype=torch.int32, device=dev)
    out = out.scatter_reduce(0, sslot, changed.to(torch.int32), "amax")
    return out[:nq].to(torch.bool)
