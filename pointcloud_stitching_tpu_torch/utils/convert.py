"""Carry the JAX package's state over to the port.

The stitcher has no weights: its state is the camera intrinsics, the
per-camera extrinsics and the config; the TSDF scene model's is its volume,
the temporal voxel map's its slots, an NDT map its cell table.
The JAX side hands them over as numpy arrays (``np.asarray`` of each field)
and these functions build the port's counterparts, so both sides compute
the same thing. The config crosses as JSON through
``StitchConfig.from_jax_json``.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import Intrinsics

INTRINSICS_FIELDS = ("fx", "fy", "ppx", "ppy", "coeffs")


def intrinsics_from_numpy(fields: dict, width: int, height: int, model: int,
                          device=None) -> Intrinsics:
    """Intrinsics from numpy fields ``fx, fy, ppx, ppy, coeffs`` (and
    ``model_ids`` for a MIXED rig); ``width``/``height``/``model`` are the
    static ints."""
    t = {k: torch.tensor(np.asarray(fields[k], np.float32), device=device)
         for k in INTRINSICS_FIELDS}
    ids = fields.get("model_ids")
    if ids is not None:
        ids = torch.tensor(np.asarray(ids, np.int32), device=device)
    return Intrinsics(**t, model_ids=ids, width=int(width),
                      height=int(height), model=int(model))


def extrinsics_from_numpy(a, device=None) -> torch.Tensor:
    """[..., 4, 4] camera→world transforms as float32."""
    a = np.asarray(a, np.float32)
    if a.shape[-2:] != (4, 4):
        raise ValueError(f"extrinsics must be [..., 4, 4], got {a.shape}")
    return torch.tensor(a, device=device)


TSDF_FIELDS = ("tsdf", "weight", "origin", "leaf", "trunc")


def tsdf_volume_from_numpy(arrays: dict, device):
    """The port's ``TSDFVolume`` from a JAX volume's arrays as numpy
    (``np.asarray`` of ``tsdf``, ``weight``, ``origin``, ``leaf``,
    ``trunc`` and, for a coloured volume, ``rgb``), on ``device``."""
    from ..models.tsdf import TSDFVolume
    t = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
         for k in TSDF_FIELDS}
    rgb = arrays.get("rgb")
    if rgb is not None:
        rgb = torch.tensor(np.asarray(rgb, np.float32), device=device)
    return TSDFVolume(**t, rgb=rgb)


def voxel_map_from_numpy(arrays: dict, device):
    """The port's ``VoxelMap`` from a JAX map's arrays as numpy
    (``np.asarray`` of ``ijk``, ``sums``, ``weight``, ``leaf`` and, for a
    coloured map, ``rgb_sums``), on ``device``."""
    from ..models.voxel_map import VoxelMap
    dtypes = {"ijk": np.int32, "sums": np.float32, "weight": np.float32,
              "leaf": np.float32}
    t = {k: torch.tensor(np.asarray(arrays[k], dt), device=device)
         for k, dt in dtypes.items()}
    rgb = arrays.get("rgb_sums")
    if rgb is not None:
        rgb = torch.tensor(np.asarray(rgb, np.float32), device=device)
    return VoxelMap(**t, rgb_sums=rgb)


NDT_FIELDS = {"keys": np.int32, "mu": np.float32, "inv_cov": np.float32,
              "valid": np.bool_, "base": np.int32, "dims": np.int32,
              "cell": np.float32}


def ndt_map_from_numpy(arrays: dict, device):
    """The port's ``NDTMap`` from a JAX map's arrays as numpy (``np.asarray``
    of each of its fields), on ``device``: a map built by the JAX package
    aligns clouds in the port."""
    from ..ops.ndt import NDTMap
    return NDTMap(**{k: torch.tensor(np.asarray(arrays[k], dt),
                                     device=device)
                     for k, dt in NDT_FIELDS.items()})
