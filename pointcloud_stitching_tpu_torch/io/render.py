"""Host-side cloud rendering: orthographic projections to image files.

Copy of ``pointcloud_stitching_tpu/io/render.py`` (numpy only), but
``render_cloud`` takes the port's PointCloud of tensors on any device.

The visualization sink replacing the reference's live
``pcl::visualization::PCLVisualizer`` window (reference: client render loop —
SURVEY.md §1 L4). A serving box has no GUI; the faithful equivalent is a
stream of rendered snapshots (plus the .ply writer in io/plyio.py). Uses
cv2 when available, else writes binary PPM (zero-dependency).
"""
from __future__ import annotations

import numpy as np


def render_orthographic(xyz: np.ndarray, rgb: np.ndarray | None = None,
                        axis: str = "z", size: int = 800,
                        background: int = 0,
                        bounds: tuple | None = None) -> np.ndarray:
    """Project points along an axis into a [size, size, 3] uint8 image.

    Depth-buffered splatting: nearer points win; colored by RGB if present,
    else by depth colormap. ``bounds=(lo, span)`` pins the projection window
    (lo: [2] min corner in the projected plane, span: scalar width) so a
    live view doesn't rescale every frame; None autoscales to this cloud.
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    if len(xyz) == 0:
        return np.full((size, size, 3), background, np.uint8)
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    keep = [i for i in range(3) if i != ax]
    uv = xyz[:, keep]
    d = xyz[:, ax]

    if bounds is not None:
        lo, span = np.asarray(bounds[0], np.float32), float(bounds[1])
        span = max(span, 1e-6)
    else:
        lo, hi = uv.min(axis=0), uv.max(axis=0)
        span = np.maximum(hi - lo, 1e-6).max()
    px = ((uv - lo) / span * (size - 1)).astype(np.int32)
    px = np.clip(px, 0, size - 1)

    order = np.argsort(-d)  # far first; near overwrites
    img = np.full((size, size, 3), background, np.uint8)
    if rgb is not None:
        colors = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)[order]
    else:
        dn = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        t = (dn[order] * 255).astype(np.uint8)
        colors = np.stack([t, 255 - t, np.full_like(t, 128)], axis=-1)
    img[px[order, 1], px[order, 0]] = colors
    return img


def view_rotation(azimuth: float, elevation: float) -> np.ndarray:
    """Orbit-view basis as a 3x3 matrix with rows [right, up, forward].

    Degrees. azimuth orbits around the sensor-vertical (y) axis, elevation
    tilts above/below the horizon; (0, 0) looks along +z — exactly the
    ``axis="z"`` orthographic view — (90, 0) along +x, (0, 90) along +y.
    """
    az = np.deg2rad(azimuth)
    el = np.deg2rad(elevation)
    f = np.array([np.cos(el) * np.sin(az), np.sin(el),
                  np.cos(el) * np.cos(az)], np.float32)
    r = np.array([np.cos(az), 0.0, -np.sin(az)], np.float32)
    u = np.cross(f, r)
    return np.stack([r, u, f]).astype(np.float32)


def shade_from_normals(rgb: np.ndarray, azimuth: float,
                       elevation: float) -> np.ndarray:
    """Lambert-shade encoded normals into gray colors.

    ``rgb`` carries the stitcher's quantized normals (q = (n+1)*127.5 —
    cfg.with_normals output, possibly voxel-averaged). A headlight at the
    camera (light direction = the orbit view's forward) gives the classic
    surface-relief view; |n·l| is used so PCL's toward-the-sensor normal
    orientation never blacks out a surface seen from behind. Points whose
    averaged normal cancelled out (depth edges) shade to a dim floor
    instead of a false highlight.
    """
    n = np.asarray(rgb, np.float32) * (1.0 / 127.5) - 1.0
    norm = np.linalg.norm(n, axis=-1)
    fwd = view_rotation(azimuth, elevation)[2]
    lam = np.abs(n @ fwd) / np.maximum(norm, 1e-6)
    lam = np.where(norm < 0.3, 0.0, lam)
    g = (40.0 + 215.0 * np.clip(lam, 0.0, 1.0)).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def render_view(xyz: np.ndarray, rgb: np.ndarray | None = None,
                azimuth: float = 0.0, elevation: float = 0.0,
                size: int = 800, background: int = 0,
                bounds: tuple | None = None,
                shade_normals: bool = False) -> np.ndarray:
    """Orbit-viewpoint orthographic render (the interactive counterpart of
    ``render_orthographic``'s fixed axes).

    The operator-facing equivalent of PCLVisualizer's mouse orbit (reference:
    ``viewer.spinOnce()`` loop — SURVEY.md §3.2): rotate the cloud into the
    (azimuth, elevation) basis, then depth-buffer-splat along the view
    forward. (0, 0) reproduces ``render_orthographic(axis="z")`` exactly.
    ``bounds`` as in render_orthographic, in the *rotated* frame.
    ``shade_normals`` treats rgb as encoded normals (cfg.with_normals
    streams) and Lambert-shades them with a view-forward headlight.
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    if len(xyz) == 0:
        return np.full((size, size, 3), background, np.uint8)
    p = xyz @ view_rotation(azimuth, elevation).T
    uv, d = p[:, :2], p[:, 2]

    if bounds is not None:
        lo, span = np.asarray(bounds[0], np.float32), float(bounds[1])
        span = max(span, 1e-6)
    else:
        lo, hi = uv.min(axis=0), uv.max(axis=0)
        span = np.maximum(hi - lo, 1e-6).max()
    px = ((uv - lo) / span * (size - 1)).astype(np.int32)
    px = np.clip(px, 0, size - 1)

    order = np.argsort(-d)
    img = np.full((size, size, 3), background, np.uint8)
    if rgb is not None and shade_normals:
        colors = shade_from_normals(rgb, azimuth, elevation)[order]
    elif rgb is not None:
        colors = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)[order]
    else:
        dn = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        t = (dn[order] * 255).astype(np.uint8)
        colors = np.stack([t, 255 - t, np.full_like(t, 128)], axis=-1)
    img[px[order, 1], px[order, 0]] = colors
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Write an image; cv2 if present (png/jpg), else PPM."""
    try:
        import cv2
        cv2.imwrite(path, img[..., ::-1])  # cv2 expects BGR
        return
    except ImportError:
        pass
    if not path.endswith(".ppm"):
        path = path.rsplit(".", 1)[0] + ".ppm"
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())


def render_cloud(pc, path: str, axis: str = "z", size: int = 800) -> None:
    """Render a (device) PointCloud's valid points to an image file."""
    mask = pc.mask.cpu().numpy()
    xyz = pc.xyz.cpu().numpy()[mask]
    rgb = None if pc.rgb is None else pc.rgb.cpu().numpy()[mask]
    save_image(path, render_orthographic(xyz, rgb, axis=axis, size=size))
