"""Calibration (.cal) file IO — 4x4 extrinsics as whitespace text.

Copy of ``pointcloud_stitching_tpu/io/calio.py`` (numpy only; any module
of the JAX package loads JAX through its package ``__init__``). The
intrinsics functions take and give the port's ``Intrinsics``.

Keeps the reference's on-disk format (reference: registration tool writes a
4x4 text matrix per camera; src/pcs-multicamera-client.cpp loads one .cal per
camera at startup — SURVEY.md §1 L5/L2) so existing calibrations carry over
unchanged.
"""
from __future__ import annotations

import os

import numpy as np


def load_cal(path: str) -> np.ndarray:
    """Load a 4x4 float32 extrinsic matrix from a .cal text file."""
    m = np.loadtxt(path, dtype=np.float64)
    m = np.asarray(m, np.float32).reshape(4, 4)
    return m


def save_cal(path: str, T) -> None:
    T = np.asarray(T, np.float64).reshape(4, 4)
    np.savetxt(path, T, fmt="%.9g")


def load_cals(paths: list[str]) -> np.ndarray:
    """Load N .cal files into a stacked [N, 4, 4] array."""
    return np.stack([load_cal(p) for p in paths])


def discover_cals(directory: str, prefix: str = "") -> list[str]:
    """List .cal files in a directory, sorted by name (camera order)."""
    out = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.endswith(".cal") and f.startswith(prefix))
    return out


# ---------------------------------------------------------------------------
# Intrinsics files (.intr.json)
# ---------------------------------------------------------------------------
#
# The reference never persists intrinsics: its camera node reads them from
# the device (rs2 API) and deprojects locally. Here deprojection runs
# centrally on the TPU (DEPTH16 mode), so the client must know every
# camera's intrinsics — a small JSON per camera, written once at rig
# bring-up (runtime/realsense_server.py dumps it from the device when
# pyrealsense2 is present) and loaded by stitch_cli --intr-dir.

def save_intrinsics(path: str, intr) -> None:
    """Write one camera's Intrinsics as JSON (librealsense field names)."""
    import json
    d = {
        "fx": float(intr.fx),
        "fy": float(intr.fy),
        "ppx": float(intr.ppx),
        "ppy": float(intr.ppy),
        "coeffs": [float(c) for c in intr.coeffs.reshape(-1).tolist()],
        "model": int(intr.model),
        "width": int(intr.width),
        "height": int(intr.height),
    }
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_intrinsics(path: str, device=None):
    """Load one camera's Intrinsics from JSON (tensors on ``device``)."""
    import json

    from ..utils.types import Intrinsics
    with open(path) as f:
        d = json.load(f)
    return Intrinsics.create(
        fx=d["fx"], fy=d["fy"], ppx=d["ppx"], ppy=d["ppy"],
        coeffs=d.get("coeffs"), model=d.get("model", 0),
        width=d.get("width", 848), height=d.get("height", 480),
        device=device)


def load_intrinsics_stack(paths: list[str], device=None):
    """Load N per-camera .intr.json files into one batched Intrinsics
    (mixed distortion models are fine — see Intrinsics.stack)."""
    cams = [load_intrinsics(p, device) for p in paths]
    return cams[0].stack(cams[1:])


def discover_intrinsics(directory: str, prefix: str = "") -> list[str]:
    """List .intr.json files in a directory, sorted by name (camera order)."""
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.endswith(".intr.json") and f.startswith(prefix))
