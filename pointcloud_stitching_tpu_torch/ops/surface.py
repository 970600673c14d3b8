"""Isosurface extraction: marching tetrahedra on a dense scalar field.

Port of the parts of ``pointcloud_stitching_tpu/ops/surface.py`` that the
TSDF mesh needs: ``marching_tetrahedra`` (the device extractor) and the
host-side ``soup_triangles`` / ``weld_mesh``. Each grid cell splits into 6
tetrahedra (the Kuhn split around the main diagonal, crack-free across
cells); a tetrahedron has 16 sign cases and at most 2 triangles. Active
cells (corners straddling the iso level, every node valid) are compacted
to a fixed ``cell_capacity``, and every active cell emits a block of 12
triangle slots with a validity mask. The JAX package selects the case
tables' entries with where-chains (a TPU layout choice); here they are
gathers from the same composed tables, which pick the same values.
``field_from_map``, ``map_grid_bounds`` and ``reconstruct_surface`` mesh a
voxel map (``models/voxel_map.py``): its occupancy, densified onto a grid
and box-filtered, at an iso level.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.types import scalar

# cube corners in the classic MC order; c0=(0,0,0) .. c6=(1,1,1)
_CORNER = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# Kuhn 6-tet decomposition: every tet contains the main diagonal c0-c6
_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                  [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int32)

# tet-local edges 0..5 between tet-local vertices 0..3
_EDGE_V = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                   np.int32)

# case -> up to 2 triangles of tet-local edge ids (-1 = unused slot); bit i
# of the case = tet vertex i is inside (value > iso)
_N = -1
_TRI_TABLE = np.array([
    [[_N, _N, _N], [_N, _N, _N]],   # 0000
    [[0, 1, 2],    [_N, _N, _N]],   # 0001
    [[0, 3, 4],    [_N, _N, _N]],   # 0010
    [[1, 3, 4],    [1, 4, 2]],      # 0011
    [[1, 3, 5],    [_N, _N, _N]],   # 0100
    [[0, 3, 5],    [0, 5, 2]],      # 0101
    [[0, 1, 5],    [0, 5, 4]],      # 0110
    [[2, 4, 5],    [_N, _N, _N]],   # 0111
    [[2, 4, 5],    [_N, _N, _N]],   # 1000
    [[0, 4, 5],    [0, 5, 1]],      # 1001
    [[0, 2, 5],    [0, 5, 3]],      # 1010
    [[1, 3, 5],    [_N, _N, _N]],   # 1011
    [[1, 2, 4],    [1, 4, 3]],      # 1100
    [[0, 3, 4],    [_N, _N, _N]],   # 1101
    [[0, 1, 2],    [_N, _N, _N]],   # 1110
    [[_N, _N, _N], [_N, _N, _N]],   # 1111
], np.int32)

# triangles emitted per cell: 6 tets x 2 slots
TRIS_PER_CELL = 12


def _composed_tables():
    """Per output slot n = (t·2+s)·3+v (tet t, triangle slot s, vertex v):
    the cube-corner ids of the slot's edge endpoints for every case
    ([16, 36] each), and which of the 12 triangle slots each case uses."""
    ts = [(n // 6, (n // 3) % 2, n % 3) for n in range(36)]
    a36 = np.zeros((16, 36), np.int64)
    b36 = np.zeros((16, 36), np.int64)
    ok12 = np.zeros((16, 12), bool)
    for c in range(16):
        for n, (t, s, v) in enumerate(ts):
            e = max(int(_TRI_TABLE[c, s, v]), 0)
            a36[c, n] = _TETS[t, _EDGE_V[e, 0]]
            b36[c, n] = _TETS[t, _EDGE_V[e, 1]]
        for m in range(12):
            ok12[c, m] = _TRI_TABLE[c, m % 2, 0] >= 0
    return a36, b36, ok12


_A36, _B36, _OK12 = _composed_tables()


def nonzero_static(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first ``size`` indices of the True entries of a 1-D mask,
    ascending, padded with 0: ``jnp.nonzero(size=...)`` without a host
    sync (the size is known on the host)."""
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (pos < size)
    out = torch.zeros((size + 1,), dtype=torch.int64, device=mask.device)
    out[torch.where(keep, pos, size)] = torch.arange(mask.numel(),
                                                     device=mask.device)
    return out[:size]


def marching_tetrahedra(field: torch.Tensor, iso, cell_capacity: int,
                        origin=None, leaf=1.0, node_valid=None,
                        chunk: int = 65536):
    """Extract the ``field == iso`` surface as a triangle soup.

    Args:
      field: [X, Y, Z] float32 samples at grid nodes; inside is
        ``field > iso``.
      iso: the iso level.
      cell_capacity: bound on active cells (cells whose corners straddle
        iso); check the returned count for saturation.
      origin: world position of node (0,0,0) ([3], default 0).
      leaf: node spacing in meters.
      node_valid: optional [X, Y, Z] bool; cells touching an invalid node
        are skipped (a TSDF passes its observed mask, so occlusion
        boundaries grow no fake walls).
      chunk: active cells processed per step (bounds the temporaries).

    Returns ``(verts, valid, n_active)``: verts [3, 3, cell_capacity·12]
    f32 with ``verts[i, j, t]`` = world coordinate j of corner i of
    triangle t (triangles wound so normals point out of the inside
    region), valid [cell_capacity·12] bool, n_active 0-d int32.
    """
    X, Y, Z = field.shape
    if min(X, Y, Z) < 2:
        raise ValueError("field must be at least 2 nodes per axis")
    dev = field.device
    iso = scalar(iso, field)
    leaf = scalar(leaf, field)
    origin = (torch.zeros((3,), dtype=torch.float32, device=dev)
              if origin is None else
              torch.as_tensor(origin).to(device=dev, dtype=torch.float32))
    cx, cy, cz = X - 1, Y - 1, Z - 1

    # per-cell straddle test: fold max/min over the 8 shifted views
    cmax = cmin = all_ok = None
    for ox, oy, oz in _CORNER:
        s = field[ox:cx + ox, oy:cy + oy, oz:cz + oz]
        cmax = s if cmax is None else torch.maximum(cmax, s)
        cmin = s if cmin is None else torch.minimum(cmin, s)
        if node_valid is not None:
            m = node_valid[ox:cx + ox, oy:cy + oy, oz:cz + oz]
            all_ok = m if all_ok is None else (all_ok & m)
    straddle = (cmax > iso) & (cmin <= iso)
    if all_ok is not None:
        straddle = straddle & all_ok
    active = straddle.reshape(-1)
    n_active = active.sum(dtype=torch.int32)
    sel = nonzero_static(active, cell_capacity)
    cell_ok = torch.arange(cell_capacity, device=dev) < n_active

    fflat = field.reshape(-1)
    a36 = torch.from_numpy(_A36).to(dev)
    b36 = torch.from_numpy(_B36).to(dev)
    ok12 = torch.from_numpy(_OK12).to(dev)
    offf = torch.from_numpy(_CORNER.astype(np.float32)).to(dev)  # [8, 3]
    slot = torch.arange(36, device=dev)[:, None]
    tet_of_slot = [n // 6 for n in range(36)]

    def cell_geom(sel_c, ok_c):
        ci = sel_c // (cy * cz)
        cj = (sel_c // cz) % cy
        ck = sel_c % cz
        cf = [ci.to(torch.float32), cj.to(torch.float32),
              ck.to(torch.float32)]
        # the 8 corner values of every active cell
        v8 = torch.stack([fflat[(ci + int(ox)) * (Y * Z) + (cj + int(oy)) * Z
                                + (ck + int(oz))] for ox, oy, oz in _CORNER])
        inside = v8 > iso                                     # [8, chunk]
        cases = []                        # per tet: bit i = vertex i inside
        for t in range(6):
            c = inside[_TETS[t, 0]].to(torch.int64)
            for bit, tv in enumerate(_TETS[t, 1:4], start=1):
                c = c + inside[tv].to(torch.int64) * (1 << bit)
            cases.append(c)
        case36 = torch.stack([cases[t] for t in tet_of_slot])  # [36, chunk]
        ida = a36[case36, slot]           # endpoint corner ids per slot
        idb = b36[case36, slot]
        va = torch.gather(v8, 0, ida)
        vb = torch.gather(v8, 0, idb)
        # interpolate the crossing; a used edge always straddles iso, but
        # guard the unused slots
        denom = vb - va
        denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        tt = torch.clamp((iso - va) / denom, 0.0, 1.0)
        vx = []
        for ax in range(3):
            oa, ob = offf[ida, ax], offf[idb, ax]
            inner = torch.addcmul(cf[ax][None, :] + oa, tt, ob - oa)
            vx.append(torch.addcmul(origin[ax], leaf, inner))  # [36, chunk]

        # orient: normal away from the tet's inside-corner centroid
        pin = []
        for t6 in range(6):
            w = [inside[_TETS[t6, v]].to(torch.float32) for v in range(4)]
            wsum = torch.clamp(w[0] + w[1] + w[2] + w[3], min=1e-12)
            pin.append([torch.addcmul(origin[ax], leaf, cf[ax] + sum(
                w[v] * float(_CORNER[_TETS[t6, v], ax]) for v in range(4))
                / wsum) for ax in range(3)])
        pinx = [torch.stack([pin[m // 2][ax] for m in range(12)])
                for ax in range(3)]                           # [12, chunk]

        v0 = [vx[ax][0::3] for ax in range(3)]                # [12, chunk]
        v1 = [vx[ax][1::3] for ax in range(3)]
        v2 = [vx[ax][2::3] for ax in range(3)]
        e1 = [v1[ax] - v0[ax] for ax in range(3)]
        e2 = [v2[ax] - v0[ax] for ax in range(3)]
        nx = torch.addcmul(-(e1[2] * e2[1]), e1[1], e2[2])
        ny = torch.addcmul(-(e1[0] * e2[2]), e1[2], e2[0])
        nz = torch.addcmul(-(e1[1] * e2[0]), e1[0], e2[1])
        cen = [(v0[ax] + v1[ax] + v2[ax]) / 3.0 for ax in range(3)]
        d = [cen[ax] - pinx[ax] for ax in range(3)]
        flip = torch.addcmul(torch.addcmul(ny * d[1], nx, d[0]),
                             nz, d[2]) < 0
        v1f = [torch.where(flip, v2[ax], v1[ax]) for ax in range(3)]
        v2f = [torch.where(flip, v1[ax], v2[ax]) for ax in range(3)]

        case12 = torch.stack([cases[m // 2] for m in range(12)])
        tri_valid = ok12[case12, torch.arange(12, device=dev)[:, None]] \
            & ok_c[None, :]
        # (corner, axis)-major; triangle order n = cell·12 + t·2 + s
        corners = (v0, v1f, v2f)
        soa = torch.stack([torch.stack([corners[i][j].T.reshape(-1)
                                        for j in range(3)])
                           for i in range(3)])
        return soa, tri_valid.T.reshape(-1)

    parts = [cell_geom(sel[i:i + chunk], cell_ok[i:i + chunk])
             for i in range(0, cell_capacity, max(1, int(chunk)))]
    verts = torch.cat([p[0] for p in parts], dim=2)
    valid = torch.cat([p[1] for p in parts])
    return verts, valid, n_active


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def soup_triangles(verts, valid=None) -> np.ndarray:
    """Triangle soup → host [n, 3, 3] f32 (triangle-major). Accepts
    ``marching_tetrahedra``'s coordinate-major [3, 3, T] layout or a
    triangle-major [T, 3, 3] array (tensors or numpy); ``valid`` selects
    the real triangles."""
    v = _host(verts).astype(np.float32)
    if v.ndim != 3:
        raise ValueError(f"expected a triangle soup, got shape {v.shape}")
    if v.shape[0] == 3 and v.shape[1] == 3 and v.shape[2] != 3:
        v = np.moveaxis(v, 2, 0)
    if valid is not None:
        v = v[_host(valid).astype(bool)]
    return np.ascontiguousarray(v)


def weld_mesh(verts, valid, decimals: int = 6):
    """Soup → indexed mesh on the host: dedup shared vertices (rounded to
    ``decimals``), drop degenerate triangles. Returns (vertices [V, 3] f32,
    faces [F, 3] int32)."""
    tris = soup_triangles(verts, valid)
    if tris.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return uniq.astype(np.float32), faces[ok]


def field_from_map(ijk: torch.Tensor, weight: torch.Tensor, origin_ijk,
                   shape: tuple[int, int, int], min_weight=0.0,
                   saturate=1.0, smooth_iters: int = 1) -> torch.Tensor:
    """Densify a sparse voxel map into an occupancy field for meshing.

    Args:
      ijk: [cap, 3] absolute biased voxel indices (``VoxelMap.ijk``;
        sentinel rows ignored).
      weight: [cap] evidence weights.
      origin_ijk: [3] absolute biased index of grid node (0, 0, 0)
        (``map_grid_bounds`` picks it).
      shape: (X, Y, Z) node counts.
      min_weight: voxels below this evidence count as empty.
      saturate: weight at which occupancy clips to 1 (occupancy ramps
        linearly up to it).
      smooth_iters: 3³ box-filter passes (one puts the iso-0.5 crossing
        between occupied and empty nodes with sub-voxel interpolation).

    Returns [X, Y, Z] float32 occupancy in [0, 1]; node (i, j, k) sits at
    ``(origin_ijk - BIAS + (i, j, k) + 0.5) * leaf``.
    """
    from ..models.voxel_map import _SENTINEL
    X, Y, Z = shape
    dev = ijk.device
    occ = (ijk[:, 0] != _SENTINEL) & (weight >= scalar(min_weight, weight))
    g = ijk - torch.as_tensor(origin_ijk, dtype=torch.int32).to(dev)[None, :]
    inb = torch.ones_like(occ)
    for a, n in enumerate((X, Y, Z)):
        inb = inb & (g[:, a] >= 0) & (g[:, a] < n)
    keep = occ & inb
    val = torch.where(keep, torch.clamp(weight / scalar(saturate, weight),
                                        0.0, 1.0), 0.0)
    gi = torch.where(keep[:, None], g, 0).long()
    flat = (gi[:, 0] * Y + gi[:, 1]) * Z + gi[:, 2]
    field = torch.zeros((X * Y * Z,), dtype=torch.float32, device=dev)
    field = field.scatter_reduce(0, flat, val, "amax").reshape(X, Y, Z)
    for _ in range(smooth_iters):
        field = _box3(field)
    return field


def _box3(f: torch.Tensor) -> torch.Tensor:
    """Separable 3³ box filter with zero (empty-space) borders; each pass
    is (lo + f + hi) / 3 in that order, as the JAX package writes it (XLA
    on the CPU multiplies by 1/3 and fuses passes into multiply-adds, so
    the two agree to a few float32 ulps)."""
    for ax in range(3):
        n = f.shape[ax]
        z = torch.zeros_like(f.narrow(ax, 0, 1))
        lo = torch.cat([z, f.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([f.narrow(ax, 1, n - 1), z], dim=ax)
        f = (lo + f + hi) / 3.0
    return f


def map_grid_bounds(vmap, min_weight: float = 0.0, pad: int = 2,
                    max_nodes: int = 256):
    """Fit a dense grid to a map's occupied voxels, on the host.

    Returns ``(origin_ijk [3] int32, shape (X, Y, Z), origin_world [3]
    f32)``: the occupied bounding box plus ``pad`` empty layers (so the
    surface closes around the outermost voxels), clamped to ``max_nodes``
    per axis. Reads the map back to the host: an offline step.
    """
    from ..models.voxel_map import _BIAS, _SENTINEL
    ijk = _host(vmap.ijk)
    w = _host(vmap.weight)
    occ = (ijk[:, 0] != _SENTINEL) & (w >= min_weight)
    if not occ.any():
        raise ValueError("map has no occupied voxels at this min_weight")
    lo = ijk[occ].min(0) - pad
    hi = ijk[occ].max(0) + pad
    shape = tuple(int(min(h - l + 2, max_nodes)) for l, h in zip(lo, hi))
    leaf = float(_host(vmap.leaf))
    origin_world = ((lo - np.asarray(_BIAS)).astype(np.float32) + 0.5) * leaf
    return (lo.astype(np.int32), shape,
            np.asarray(origin_world, np.float32))


def reconstruct_surface(vmap, iso: float = 0.5, min_weight: float = 0.0,
                        saturate: float = 1.0, smooth_iters: int = 1,
                        cell_capacity: int | None = None, pad: int = 2,
                        max_nodes: int = 256):
    """Voxel map -> crack-free triangle mesh: ``map_grid_bounds`` ->
    ``field_from_map`` -> ``marching_tetrahedra`` -> ``weld_mesh``.
    Returns ``(verts [V, 3] np.f32, faces [F, 3] np.int32, n_active)``,
    ready for ``io.plyio.save_mesh``."""
    origin_ijk, shape, origin_world = map_grid_bounds(
        vmap, min_weight=min_weight, pad=pad, max_nodes=max_nodes)
    field = field_from_map(vmap.ijk, vmap.weight, origin_ijk, shape,
                           min_weight=min_weight, saturate=saturate,
                           smooth_iters=smooth_iters)
    if cell_capacity is None:
        ncells = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
        # surface shell heuristic: ~n² cells of the n³ grid, padded 8x
        cell_capacity = int(min(ncells, max(4096, 8 * ncells ** (2 / 3))))
    verts, valid, n_active = marching_tetrahedra(
        field, iso, cell_capacity, origin=origin_world, leaf=vmap.leaf)
    n_active = int(n_active)
    if n_active > cell_capacity:
        raise ValueError(
            f"surface has {n_active} active cells > capacity "
            f"{cell_capacity}; pass a larger cell_capacity")
    v, f = weld_mesh(verts, valid)
    return v, f, n_active
