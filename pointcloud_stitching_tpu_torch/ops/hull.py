"""Convex and concave hulls of point clouds (pcl::ConvexHull,
pcl::ConcaveHull and pcl::CropHull roles).

Port of ``pointcloud_stitching_tpu/ops/hull.py``. The work splits as in
the JAX package:

- on the device, the support point of the cloud in each of D Fibonacci
  directions: a blockwise running argmax over [block, D] scores. Every
  hull vertex is the support point of some direction, so a dense set of
  directions recovers the hull's vertices (up to facets narrower than the
  sampling gap); the result is an inner approximation made of real cloud
  points;
- on the host, qhull (scipy) over the surviving candidates for the facets
  (``exact=True`` hands it every valid point), and scipy's Delaunay for
  the alpha shape's connectivity; the circumradius of every simplex is
  computed batched on the device;
- cropping against a hull is one [N, F] evaluation of the facet planes
  and an all-reduce on the device.

Scores and plane distances are elementwise products summed x, y, z in
that order, so TF32 matmuls cannot move a vertex or a crop decision.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.types import PointCloud
from .search import dot3


def fibonacci_directions(n: int) -> np.ndarray:
    """n approximately uniform unit directions (golden-spiral sphere)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1).astype(np.float32)


def _support_indices(xyz: torch.Tensor, mask: torch.Tensor,
                     dirs: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Index [D] int32 of the valid point maximising x . d for each
    direction, the first index on ties (0 when no point is valid).

    Blockwise running argmax: the [N, D] score matrix never exists whole
    (262k points x 2048 directions would be 2 GB); a later block takes a
    direction only with a strictly larger score.
    """
    d = dirs.shape[0]
    best = torch.full((d,), float("-inf"), device=xyz.device)
    bidx = torch.zeros(d, dtype=torch.int32, device=xyz.device)
    for i in range(0, xyz.shape[0], block):
        s = dot3(xyz[i:i + block, None, :], dirs[None, :, :])  # [block, D]
        s = torch.where(mask[i:i + block, None], s, float("-inf"))
        loc = torch.argmax(s, dim=0).to(torch.int32)         # first max
        val = s.amax(dim=0)
        take = val > best
        best = torch.where(take, val, best)
        bidx = torch.where(take, i + loc, bidx)
    return bidx


@dataclasses.dataclass(frozen=True)
class ConvexHullResult:
    """Host-side hull: pcl::ConvexHull's PolygonMesh plus the qhull facet
    planes that make cropping on the device one evaluation."""

    vertices: np.ndarray    # [H, 3] float32 hull vertex positions
    faces: np.ndarray       # [F, 3] int32 into vertices, outward-wound
    equations: np.ndarray   # [F, 4] outward planes: n.x + d <= 0 inside
    area: float
    volume: float
    vertex_ids: np.ndarray  # [H] indices into the input (padded) cloud


def convex_hull(pc: PointCloud, n_dirs: int = 2048, exact: bool = False,
                block: int = 4096) -> ConvexHullResult:
    """Convex hull of the valid points of a single [N, 3] cloud.

    ``exact=False`` (default): the support points of ``n_dirs`` Fibonacci
    directions on the device, qhull over those candidates. ``exact=True``:
    qhull over every valid point (PCL's output). Raises ValueError when
    fewer than 4 non-degenerate points remain.
    """
    from scipy.spatial import ConvexHull as SciHull
    from scipy.spatial import QhullError

    if pc.xyz.dim() != 2:
        raise ValueError("convex_hull expects an unbatched [N,3] cloud")
    xyz = pc.xyz.cpu().numpy()
    mask = pc.mask.cpu().numpy()
    if exact:
        cand = np.nonzero(mask)[0]
    else:
        dirs = torch.from_numpy(fibonacci_directions(n_dirs)).to(
            pc.xyz.device)
        idx = _support_indices(pc.xyz, pc.mask, dirs, block=block)
        cand = np.unique(idx.cpu().numpy())
        cand = cand[mask[cand]]   # an empty cloud's index 0 drops here
    if cand.size < 4:
        raise ValueError(f"convex_hull needs >= 4 valid points, "
                         f"got {cand.size}")
    try:
        h = SciHull(xyz[cand])
    except QhullError as e:
        raise ValueError(f"degenerate cloud (coplanar/collinear): {e}")

    # qhull's indices point into the candidates: compact to hull-local
    remap = np.full(cand.size, -1, np.int32)
    remap[h.vertices] = np.arange(h.vertices.size, dtype=np.int32)
    faces = remap[h.simplices]
    verts = xyz[cand[h.vertices]]
    # wind each triangle outward (qhull's `equations` normals point out)
    tri = verts[faces]
    wn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", wn, h.equations[:, :3]) < 0
    faces[flip] = faces[flip][:, ::-1]
    return ConvexHullResult(
        vertices=verts, faces=faces.astype(np.int32),
        equations=h.equations.astype(np.float32),
        area=float(h.area), volume=float(h.volume),
        vertex_ids=cand[h.vertices].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class ConcaveHullResult:
    """Alpha-shape boundary (pcl::ConcaveHull role).

    3-D: a boundary triangle mesh over the kept (circumradius < alpha)
    Delaunay tetrahedra, outward-wound, plus their total volume. Planar:
    ``rings`` holds the ordered boundary polygon(s) as indices into
    ``vertices`` (outer ring and any hole rings), faces empty.
    """

    vertices: np.ndarray    # [H, 3] float32 boundary vertex positions
    faces: np.ndarray       # [F, 3] int32 into vertices (3-D mode)
    area: float             # boundary surface area (3-D) / shape area (2-D)
    volume: float           # enclosed volume (3-D; 0.0 in planar mode)
    vertex_ids: np.ndarray  # [H] indices into the input (padded) cloud
    rings: tuple = ()       # planar mode: tuple of [k] int32 ring indices


def _tet_circumradii(tets: torch.Tensor) -> torch.Tensor:
    """Circumradius of each tetrahedron [T, 4, 3]: batched 3x3 solves.

    A flat tetrahedron's system is singular; ``solve_ex`` does not raise
    there (``torch.linalg.solve`` would), and its radius is +inf, so it
    fails every alpha test, as the JAX package's nan/inf does.
    """
    p0 = tets[:, 0]
    a = 2.0 * (tets[:, 1:] - p0[:, None])                        # [T,3,3]
    b = (tets[:, 1:] ** 2 - p0[:, None] ** 2).sum(dim=-1)        # [T,3]
    c, info = torch.linalg.solve_ex(a, b[..., None])
    r = torch.linalg.vector_norm(c[..., 0] - p0, dim=-1)
    return torch.where(info == 0, r, float("inf"))


def _tri_circumradii(tris: torch.Tensor) -> torch.Tensor:
    """Circumradius of each 2-D triangle [T, 3, 2]: r = abc / (4A)."""
    a = torch.linalg.vector_norm(tris[:, 1] - tris[:, 0], dim=-1)
    b = torch.linalg.vector_norm(tris[:, 2] - tris[:, 1], dim=-1)
    c = torch.linalg.vector_norm(tris[:, 0] - tris[:, 2], dim=-1)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    area2 = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()   # 2A
    return a * b * c / torch.clamp(2.0 * area2, min=1e-30)


def _chain_rings(edges: np.ndarray) -> list:
    """Order once-used boundary edges into closed rings (host, O(E))."""
    nxt = {}
    for i, j in edges:
        nxt.setdefault(int(i), []).append(int(j))
        nxt.setdefault(int(j), []).append(int(i))
    seen, rings = set(), []
    for start in nxt:
        if start in seen:
            continue
        ring, prev, cur = [start], -1, start
        seen.add(start)
        while True:
            cand = [v for v in nxt[cur] if v != prev and v not in seen]
            if not cand:
                break
            prev, cur = cur, cand[0]
            ring.append(cur)
            seen.add(cur)
        # a ring must close: at a pinched boundary vertex the greedy walk
        # can stop early, leaving an open chain, which is dropped
        if len(ring) >= 3 and ring[0] in nxt[ring[-1]]:
            rings.append(np.asarray(ring, np.int32))
    return rings


def _radii(fn, simplices: np.ndarray, device) -> np.ndarray:
    return fn(torch.from_numpy(simplices.astype(np.float32)).to(
        device)).cpu().numpy()


def concave_hull(pc: PointCloud, alpha: float,
                 planar: bool = False) -> ConcaveHullResult:
    """Alpha-shape concave hull of the valid points (pcl::ConcaveHull's
    setAlpha: simplices of circumradius below ``alpha`` are kept).

    scipy's Delaunay gives the connectivity on the host; the circumradii
    are computed on the cloud's device. ``planar=True`` projects onto the
    cloud's best-fit plane first and returns ordered boundary ring(s)
    instead of a triangle mesh.
    """
    from scipy.spatial import Delaunay, QhullError

    if pc.xyz.dim() != 2:
        raise ValueError("concave_hull expects an unbatched [N,3] cloud")
    xyz = pc.xyz.cpu().numpy()
    valid = np.nonzero(pc.mask.cpu().numpy())[0]
    if valid.size < (3 if planar else 4):
        raise ValueError(f"concave_hull needs >= 4 valid points, "
                         f"got {valid.size}")
    pts = xyz[valid].astype(np.float64)
    dev = pc.xyz.device

    if planar:
        centered = pts - pts.mean(axis=0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        uv = centered @ vt[:2].T
        try:
            d = Delaunay(uv)
        except QhullError as e:
            raise ValueError(f"degenerate planar cloud: {e}")
        r = _radii(_tri_circumradii, uv[d.simplices], dev)
        keep = d.simplices[r < alpha]
        if keep.size == 0:
            raise ValueError("alpha too small: no triangles survive")
        e1 = uv[keep[:, 1]] - uv[keep[:, 0]]
        e2 = uv[keep[:, 2]] - uv[keep[:, 0]]
        area = float(np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum()
                     / 2.0)
        edges = np.sort(keep[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2),
                        axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        rings_local = _chain_rings(uniq[counts == 1])
        used = np.unique(np.concatenate(rings_local)) if rings_local \
            else np.arange(0)
        remap = np.full(len(pts), -1, np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        return ConcaveHullResult(
            vertices=xyz[valid[used]],
            faces=np.zeros((0, 3), np.int32), area=area, volume=0.0,
            vertex_ids=valid[used].astype(np.int32),
            rings=tuple(remap[r] for r in rings_local))

    try:
        d = Delaunay(pts)
    except QhullError as e:
        raise ValueError(f"degenerate cloud (coplanar/collinear): {e}")
    r = _radii(_tet_circumradii, pts[d.simplices], dev)
    keep = d.simplices[np.nan_to_num(r, nan=np.inf) < alpha]
    if keep.size == 0:
        raise ValueError("alpha too small: no tetrahedra survive")
    # volume of the kept solid
    e = pts[keep[:, 1:]] - pts[keep[:, 0]][:, None]              # [K,3,3]
    volume = float(np.abs(np.linalg.det(e)).sum() / 6.0)
    # boundary = faces of exactly one kept tet; the opposite vertex tells
    # which way each face winds away from its tet
    fidx = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
    faces_all = keep[:, fidx].reshape(-1, 3)                     # [4K,3]
    opp = keep[:, [0, 1, 2, 3]].reshape(-1)                      # [4K]
    key = np.sort(faces_all, axis=1)
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
    on_boundary = counts[inv.reshape(-1)] == 1
    bfaces, bopp = faces_all[on_boundary], opp[on_boundary]
    tri = pts[bfaces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", n, pts[bopp] - tri[:, 0]) > 0
    bfaces[flip] = bfaces[flip][:, ::-1]
    area = float(np.linalg.norm(n, axis=1).sum() / 2.0)
    used = np.unique(bfaces)
    remap = np.full(len(pts), -1, np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    return ConcaveHullResult(
        vertices=xyz[valid[used]], faces=remap[bfaces].astype(np.int32),
        area=area, volume=volume,
        vertex_ids=valid[used].astype(np.int32))


def crop_hull(pc: PointCloud, hull, invert: bool = False,
              eps: float | None = None) -> PointCloud:
    """Keep points inside a convex hull (pcl::CropHull role), mask-only.

    ``hull`` is a ConvexHullResult or a raw [F, 4] plane array (outward
    normals, n.x + d <= 0 inside): the hull is the intersection of its
    half-spaces, so one [N, F] evaluation and an all-reduce decide.

    ``eps`` is an absolute slack on the signed plane distance; the default
    scales with the hull's extent (1e-6 x (1 + max |plane d|)), so the
    hull's own vertices survive float32 rounding at any coordinate
    magnitude.
    """
    planes = getattr(hull, "equations", hull)
    if not torch.is_tensor(planes):
        planes = torch.from_numpy(np.asarray(planes, np.float32))
    planes = planes.to(device=pc.xyz.device, dtype=torch.float32)
    tol = (torch.full((), eps, dtype=torch.float32, device=pc.xyz.device)
           if eps is not None
           else 1e-6 * (1.0 + planes[:, 3].abs().amax()))
    d = dot3(pc.xyz[..., None, :], planes[:, :3]) + planes[:, 3]  # [N, F]
    inside = (d <= tol).all(dim=-1)
    return pc.replace(mask=pc.mask & (inside ^ invert))
