"""PCD (Point Cloud Data) file IO — PCL's native format.

The reference's registration tool loads .ply/.pcd clouds (SURVEY.md §3.4);
PCL tooling defaults to .pcd, so calibration workflows that started in PCL
land bring these files along. Implemented from the public PCD v0.7 spec:
ascii, binary, and binary_compressed DATA sections, x/y/z float fields
plus either a packed float `rgb` (PCL's PointXYZRGB layout: u8 b,g,r in
the float's low bytes) or separate r/g/b fields.

binary_compressed is PCL's default compact mode: a u32 compressed-size /
u32 uncompressed-size pair followed by an LZF stream of the point data
TRANSPOSED to field-major (all x, then all y, ...) — the SoA layout is
part of the format, chosen upstream for compressibility.

Copy of ``pointcloud_stitching_tpu/io/pcdio.py`` (numpy only); LZF comes
from ``io/lzf.py``, the pure-Python codec of the reference's
``native/lzf.py``.
"""
from __future__ import annotations

import struct

import numpy as np

_TYPE = {("F", 4): "<f4", ("F", 8): "<f8",
         ("U", 1): "u1", ("U", 2): "<u2", ("U", 4): "<u4",
         ("I", 1): "i1", ("I", 2): "<i2", ("I", 4): "<i4"}


def save_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
             binary: bool = True, compressed: bool = False) -> None:
    """Write a PCD v0.7 file. ``compressed=True`` selects PCL's
    ``binary_compressed`` DATA mode (implies binary)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    has_rgb = rgb is not None
    if has_rgb:
        rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8).reshape(-1, 3)
        if len(rgb) != n:
            raise ValueError("rgb length mismatch")
        # PCL packs RGB into a float: uint32 0x00RRGGBB reinterpreted
        packed = (rgb[:, 0].astype(np.uint32) << 16 |
                  rgb[:, 1].astype(np.uint32) << 8 |
                  rgb[:, 2].astype(np.uint32)).view(np.float32)

    fields = "x y z rgb" if has_rgb else "x y z"
    count = "1 1 1 1" if has_rgb else "1 1 1"
    size = "4 4 4 4" if has_rgb else "4 4 4"
    types = "F F F F" if has_rgb else "F F F"
    mode = ("binary_compressed" if compressed
            else "binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {size}\n"
        f"TYPE {types}\n"
        f"COUNT {count}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {mode}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            from .lzf import compress
            # field-major (SoA): all x, all y, all z[, all packed rgb]
            cols = [np.ascontiguousarray(xyz[:, i], "<f4") for i in range(3)]
            if has_rgb:
                cols.append(np.ascontiguousarray(packed, "<f4"))
            raw = b"".join(c.tobytes() for c in cols)
            comp = compress(raw)
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        elif binary:
            if has_rgb:
                rec = np.empty((n, 4), np.float32)
                rec[:, :3] = xyz
                rec[:, 3] = packed
                f.write(rec.astype("<f4").tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i, 0]:.6g} {xyz[i, 1]:.6g} {xyz[i, 2]:.6g}"
                if has_rgb:
                    # PCL prints the packed value losslessly via repr float
                    row += f" {packed[i]:.9g}"
                f.write((row + "\n").encode("ascii"))


def load_pcd(path: str):
    """Returns (xyz [N,3] float32, rgb [N,3] uint8 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    lines = []
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise ValueError("truncated PCD header")
        line = data[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if line.startswith("#") or not line:
            continue
        lines.append(line)
        if line.startswith("DATA"):
            break
    hdr = {}
    for line in lines:
        k, _, v = line.partition(" ")
        hdr[k.upper()] = v.split()
    fields = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    if any(c != 1 for c in counts):
        raise ValueError("multi-count PCD fields not supported")
    npoints = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0]

    if mode == "binary":
        dt = np.dtype([(name, _TYPE[(t, s)])
                       for name, t, s in zip(fields, types, sizes)])
        rec = np.frombuffer(data[pos:pos + npoints * dt.itemsize], dt,
                            count=npoints)
        cols = {name: rec[name] for name in fields}
    elif mode == "binary_compressed":
        from .lzf import decompress
        comp_size, raw_size = struct.unpack_from("<II", data, pos)
        pos += 8
        raw = decompress(data[pos:pos + comp_size], raw_size)
        want = npoints * sum(sizes)
        if raw_size != want:
            raise ValueError(
                f"binary_compressed size mismatch: header implies {want} "
                f"bytes, stream carries {raw_size}")
        # field-major: each field's npoints values are contiguous
        cols, off = {}, 0
        for name, t, s in zip(fields, types, sizes):
            cols[name] = np.frombuffer(raw, _TYPE[(t, s)], count=npoints,
                                       offset=off)
            off += npoints * s
    elif mode == "ascii":
        arr = np.array(data[pos:].split(), dtype=np.float64)
        arr = arr.reshape(npoints, len(fields))
        cols = {name: arr[:, i] for i, name in enumerate(fields)}
    else:
        raise ValueError(f"unsupported PCD DATA mode {mode}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(
        np.float32)
    rgb = None
    if "rgb" in cols:
        packed = np.ascontiguousarray(cols["rgb"], dtype=np.float32).view(
            np.uint32)
        rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                        packed & 0xFF], axis=-1).astype(np.uint8)
    elif all(k in cols for k in ("r", "g", "b")):
        rgb = np.stack([cols["r"], cols["g"], cols["b"]],
                       axis=-1).astype(np.uint8)
    return xyz, rgb
