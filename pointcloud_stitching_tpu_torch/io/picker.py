"""Correspondence picking: map clicked pixels back to point indices.

Copy of ``pointcloud_stitching_tpu/io/picker.py`` (numpy only; any module
of the JAX package loads JAX through its package ``__init__``).

The headless-friendly equivalent of the reference registration tool's
interactive picking (reference: registration/ dual-viewport PCL
``manual_registration`` workflow, shift-click >=3 pairs in each cloud —
SURVEY.md §3.4). A serving box has no VTK; instead each cloud renders to
an orthographic image *plus an index map* remembering which point won each
pixel's depth test, so a pixel click (cv2 mouse event, or coordinates typed
over ssh) maps exactly to the point index the reference's 3-D picker would
have returned. The resulting pairs feed ``register_cli.py --picks``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


def projection_bounds(xyz: np.ndarray, axis: str = "z"
                      ) -> tuple[np.ndarray, float]:
    """The (lo, span) window render_indexed/render_orthographic use for
    autoscale — exposed so two views (or a test's expected pixel math) can
    share one projection."""
    keep = [i for i in range(3) if i != AXIS_INDEX[axis]]
    uv = np.asarray(xyz, np.float32).reshape(-1, 3)[:, keep]
    lo, hi = uv.min(axis=0), uv.max(axis=0)
    return lo, float(np.maximum(hi - lo, 1e-6).max())


def project_pixels(xyz: np.ndarray, axis: str, size: int,
                   bounds: tuple[np.ndarray, float]) -> np.ndarray:
    """Pixel coordinates [N, 2] (u=x-col, v=y-row) of each point under the
    same projection render_indexed uses."""
    keep = [i for i in range(3) if i != AXIS_INDEX[axis]]
    uv = np.asarray(xyz, np.float32).reshape(-1, 3)[:, keep]
    lo, span = np.asarray(bounds[0], np.float32), max(float(bounds[1]), 1e-6)
    px = ((uv - lo) / span * (size - 1)).astype(np.int32)
    return np.clip(px, 0, size - 1)


def render_indexed(xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                   axis: str = "z", size: int = 800,
                   bounds: Optional[tuple] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Depth-buffered orthographic render that also returns the index map.

    Returns (img [size,size,3] uint8, index_map [size,size] int32) where
    index_map[v, u] is the index (into ``xyz``) of the point visible at that
    pixel, -1 where no point landed. Same splatting rule as
    io.render.render_orthographic (far-to-near painter's order), so the
    image pixel a user clicks IS the point the index map names.
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    img = np.zeros((size, size, 3), np.uint8)
    idx_map = np.full((size, size), -1, np.int32)
    if len(xyz) == 0:
        return img, idx_map
    if bounds is None:
        bounds = projection_bounds(xyz, axis)
    px = project_pixels(xyz, axis, size, bounds)
    d = xyz[:, AXIS_INDEX[axis]]

    order = np.argsort(-d)  # far first; near overwrites
    if rgb is not None:
        colors = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)[order]
    else:
        dn = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        t = (dn[order] * 255).astype(np.uint8)
        colors = np.stack([t, 255 - t, np.full_like(t, 128)], axis=-1)
    img[px[order, 1], px[order, 0]] = colors
    idx_map[px[order, 1], px[order, 0]] = order.astype(np.int32)
    return img, idx_map


def pick_index(index_map: np.ndarray, u: int, v: int,
               radius: int = 4) -> int:
    """Point index at pixel (u, v), searching a (2r+1)^2 window for the
    nearest hit (clicks rarely land exactly on a 1-px splat). -1 if the
    window is empty."""
    size = index_map.shape[0]
    u0, u1 = max(u - radius, 0), min(u + radius + 1, size)
    v0, v1 = max(v - radius, 0), min(v + radius + 1, size)
    window = index_map[v0:v1, u0:u1]
    hits = np.argwhere(window >= 0)
    if len(hits) == 0:
        return -1
    centre = np.array([v - v0, u - u0])
    best = hits[np.argmin(((hits - centre) ** 2).sum(axis=1))]
    return int(window[best[0], best[1]])


def save_picks(path: str, pairs: list[tuple[int, int]]) -> None:
    """Write a register_cli-compatible picks file (src_idx dst_idx lines)."""
    with open(path, "w") as f:
        for s, t in pairs:
            f.write(f"{s} {t}\n")
