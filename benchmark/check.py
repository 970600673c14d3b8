"""The comparison that decides ``correct``.

Each judged output of the timed path (the refined extrinsics and the
fused cloud of one frame set; the traffic's ``samples`` of them, drawn
from the seed) is held against the plain reference (``reference.py``) on
the same frames and calibration:

* ``pose_gap_mm``: the largest distance, over the cameras and the eight
  corners of the crop box, between a corner moved by the program's
  refined extrinsics and by the reference's own ring ICP;
* ``voxel_mismatch_pct``: voxels (by their absolute (ix, iy, iz)) that one
  side has and the other lacks, in % of the reference's;
* ``moved_voxels_pct``: voxels both have whose centroids lie more than
  ``MOVED_M`` apart, in % of the reference's;
* ``color_off_pct``, only for a configuration with colour: voxels both
  have whose mean colours differ by more than ``COLOR_LEVELS`` in any
  channel, in % of the voxels both have.

The two cloud numbers judge the fused cloud against the reference's
cloud built with the program's refined extrinsics, which ``pose_gap_mm``
judges by themselves: a pose a few micrometres off moves thousands of
points across voxel faces, which would drown a fault of the cloud stages
in the ICP's own rounding. A run compares the worst cloud numbers over
its judged frames, the median of ``pose_gap_mm`` over them and
``pose_far_frames``, the count of its judged frames whose ``pose_gap_mm``
passes that number's limit: the ring ICP turns a rounding-level
difference into a correspondence that one side takes and the other does
not in about one frame in a hundred and forty, which moves that frame's
poses by up to a millimetre while the median frame stays within a few
micrometres, so no limit holds on the worst frame, and the count catches
a fault of the ICP that strikes some frames and not others. Each number's
limit is in the configuration file (``limits``), set in PERF.md from the
readings of sound runs and of the control. The colour number judges the
program's per-voxel mean colour against the reference's, whose colour
map (``reference.map_color``) and cloud take the same extrinsics.
"""
from __future__ import annotations

import itertools
import statistics

import torch

from . import reference

MOVED_M = 5e-4      # a centroid moved by more than a twentieth of 1 cm
COLOR_LEVELS = 1.0  # a mean colour off by more than one 8-bit level
NAMES = ("pose_gap_mm", "pose_far_frames", "voxel_mismatch_pct",
         "moved_voxels_pct")
FRAME = ("pose_gap_mm", "voxel_mismatch_pct", "moved_voxels_pct")
COLOR = "color_off_pct"


def _corners(cfg: dict) -> torch.Tensor:
    lo, hi = cfg["crop_lo"], cfg["crop_hi"]
    return torch.tensor(list(itertools.product(*zip(lo, hi))),
                        dtype=torch.float64)


def pose_gap_mm(ext_a: torch.Tensor, ext_b: torch.Tensor,
                cfg: dict) -> float:
    """Largest distance in mm between crop-box corners moved by two sets of
    extrinsics [C, 4, 4]."""
    a, b = ext_a.double().cpu(), ext_b.double().cpu()
    x = _corners(cfg)
    pa = torch.einsum("cij,nj->cni", a[:, :3, :3], x) + a[:, None, :3, 3]
    pb = torch.einsum("cij,nj->cni", b[:, :3, :3], x) + b[:, None, :3, 3]
    return float((pa - pb).norm(dim=-1).max()) * 1e3


def cloud_gaps(xyz: torch.Tensor, ref_xyz: torch.Tensor, leaf: float,
               rgb: torch.Tensor | None = None,
               ref_rgb: torch.Tensor | None = None):
    """(voxel_mismatch_pct, moved_voxels_pct) of a cloud's centroids [n, 3]
    against the reference's [m, 3]; with the mean colours ``rgb`` [n, 3]
    and ``ref_rgb`` [m, 3], also ``color_off_pct``."""
    a, b = xyz.double().cpu(), ref_xyz.double().cpu()
    m = max(len(b), 1)

    def keyed(p, c):
        k = torch.floor(p / leaf).to(torch.int64)
        key = ((k[:, 0] + 2 ** 20) << 42) | ((k[:, 1] + 2 ** 20) << 21) \
            | (k[:, 2] + 2 ** 20)
        order = torch.argsort(key)
        return key[order], p[order], None if c is None else c[order]

    ka, pa, ca = keyed(a, None if rgb is None else rgb.double().cpu())
    kb, pb, cb = keyed(b, None if ref_rgb is None else ref_rgb.double().cpu())
    both = torch.isin(ka, kb)
    mismatch = (int((~both).sum()) + int((~torch.isin(kb, ka)).sum()))
    ia = torch.searchsorted(kb, ka[both])
    moved = int(((pa[both] - pb[ia]).norm(dim=-1) > MOVED_M).sum())
    gaps = (mismatch / m * 100.0, moved / m * 100.0)
    if rgb is None:
        return gaps
    off = int(((ca[both] - cb[ia]).abs() > COLOR_LEVELS).any(-1).sum())
    return (*gaps, off / max(int(both.sum()), 1) * 100.0)


def judge(ext, xyz, depths, calib, intr: dict, cfg: dict, device,
          rgb=None, colors=None, color: dict | None = None) -> dict:
    """The numbers of one frame set: the program's refined extrinsics
    ``ext`` and valid centroids ``xyz`` (with colour: their mean colours
    ``rgb``) against the reference computed on ``device`` from the same
    ``depths``, ``calib`` and, with colour, ``colors`` [C, hc, wc, 3] of
    the sensor ``color`` (``harness.color_of``)."""
    depths = depths.to(device)
    calib = calib.to(device)
    if colors is not None:
        colors = colors.to(device)
    ref_ext, ref_xyz, icp, ref_rgb = reference.stitch(
        depths, calib, intr, cfg, cloud_ext=ext.to(device), colors=colors,
        color=color)
    gaps = cloud_gaps(xyz, ref_xyz, cfg["out_voxel_leaf"], rgb, ref_rgb)
    names = FRAME + ((COLOR,) if colors is not None else ())
    return dict(zip(names, (pose_gap_mm(ext, ref_ext, cfg), *gaps)),
                voxels=len(xyz), ref_voxels=len(ref_xyz),
                icp_voxels_max=max(icp, default=0))


def worst(readings: list[dict], limits: dict) -> dict:
    """The number of each kind a run compares over its judged frames: the
    median ``pose_gap_mm``, the count of frames whose ``pose_gap_mm``
    passes its limit, and the largest of the others."""
    gaps = [r["pose_gap_mm"] for r in readings]
    return {"pose_gap_mm": statistics.median(gaps),
            "pose_far_frames": sum(g > limits["pose_gap_mm"] for g in gaps),
            **{k: max(r[k] for r in readings)
               for k in FRAME[1:] + (COLOR,) if k in readings[0]}}


def verdict(readings: list[dict], limits: dict, color: bool = False):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit (``color_off_pct`` too where ``color``); no reading at all is
    not correct."""
    names = NAMES + ((COLOR,) if color else ())
    if not readings:
        return False, {k: {"value": None, "limit": limits[k]}
                       for k in names}
    w = worst(readings, limits)
    table = {k: {"value": w[k], "limit": limits[k]} for k in names}
    return all(w[k] <= limits[k] for k in names), table
