"""PLY point-cloud file IO (ascii + binary_little_endian).

Host-side equivalent of ``pcl::io::savePLYFile`` / ``loadPLYFile`` (reference:
snapshot save in the client render loop and cloud loading in the registration
tool — SURVEY.md §3.2/§3.4). Self-contained: the environment has no PCL or
open3d, so the format is implemented from the public PLY spec.

Only the properties the reference uses are supported: float x/y/z and
uchar red/green/blue.

Copy of ``pointcloud_stitching_tpu/io/plyio.py`` (numpy only);
``save_cloud`` takes the port's tensor clouds and moves them to the host.
"""
from __future__ import annotations

import numpy as np


def save_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
             binary: bool = True,
             normals: np.ndarray | None = None) -> None:
    """Write a PLY. ``normals`` adds the standard nx/ny/nz float properties
    (pcl::PointNormal layout — what savePLYFile writes for normal clouds)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    has_rgb = rgb is not None
    if has_rgb:
        rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8).reshape(-1, 3)
        if len(rgb) != n:
            raise ValueError("rgb length mismatch")
    has_nrm = normals is not None
    if has_nrm:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if len(normals) != n:
            raise ValueError("normals length mismatch")

    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply", f"format {fmt} 1.0",
        "comment pointcloud_stitching_tpu",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if has_nrm:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if has_rgb:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fields = [("xyz", "<f4", 3)]
            if has_nrm:
                fields.append(("nrm", "<f4", 3))
            if has_rgb:
                fields.append(("rgb", "u1", 3))
            rec = np.empty(n, np.dtype(fields))
            rec["xyz"] = xyz
            if has_nrm:
                rec["nrm"] = normals
            if has_rgb:
                rec["rgb"] = rgb
            f.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i, 0]:.6g} {xyz[i, 1]:.6g} {xyz[i, 2]:.6g}"
                if has_nrm:
                    row += (f" {normals[i, 0]:.6g} {normals[i, 1]:.6g}"
                            f" {normals[i, 2]:.6g}")
                if has_rgb:
                    row += f" {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]}"
                f.write((row + "\n").encode("ascii"))


def save_mesh(path: str, xyz: np.ndarray, faces: np.ndarray,
              binary: bool = True) -> None:
    """Write a triangle mesh PLY (vertex list + standard face list
    elements — what pcl::io::savePLYFile writes for a PolygonMesh and
    every mesh viewer reads)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    if faces.size and (faces.min() < 0 or faces.max() >= len(xyz)):
        raise ValueError("face index out of range")
    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply", f"format {fmt} 1.0",
        "comment pointcloud_stitching_tpu mesh",
        f"element vertex {len(xyz)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(xyz.astype("<f4").tobytes())
            rec = np.empty(len(faces),
                           np.dtype([("n", "u1"), ("v", "<i4", 3)]))
            rec["n"] = 3
            rec["v"] = faces
            f.write(rec.tobytes())
        else:
            for p in xyz:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n".encode())
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


def load_ply(path: str):
    """Returns (xyz [N,3] float32, rgb [N,3] uint8 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    n = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            if t[1] == "list":
                raise ValueError("list properties not supported")
            props.append((t[2], t[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "short": "<i2",
                "ushort": "<u2", "int": "<i4", "uint": "<u4"}
    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = body.decode("ascii").split()
        arr = np.array(rows, dtype=np.float64).reshape(n, len(props))
        cols = {nm: arr[:, i] for i, nm in enumerate(names)}
    elif fmt == "binary_little_endian":
        dt = np.dtype([(nm, type_map[ty]) for nm, ty in props])
        rec = np.frombuffer(body[:n * dt.itemsize], dtype=dt, count=n)
        cols = {nm: rec[nm] for nm in names}
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    rgb = None
    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]],
                       axis=-1).astype(np.uint8)
    return xyz, rgb


def save_cloud(path: str, pc, binary: bool = True,
               decode_normals: bool = False) -> None:
    """Save a (device) PointCloud's valid points to PLY.

    decode_normals: the cloud's rgb channel carries encoded normals (a
    cfg.with_normals pipeline output) — write them as nx/ny/nz float
    properties (pcl::PointNormal layout) instead of colors.
    """
    xyz = pc.xyz.detach().cpu().numpy()
    mask = pc.mask.detach().cpu().numpy()
    if decode_normals:
        from ..ops.normals import decode_normals as _dec
        nrm, _ = _dec(pc)
        save_ply(path, xyz[mask], None, binary=binary,
                 normals=nrm.detach().cpu().numpy()[mask])
        return
    rgb = None if pc.rgb is None else pc.rgb.detach().cpu().numpy()[mask]
    save_ply(path, xyz[mask], rgb, binary=binary)
