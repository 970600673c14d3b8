#!/usr/bin/env python
"""Mesh a depth frame, a voxel map or a TSDF checkpoint into a .ply mesh.

Port of ``pointcloud_stitching_tpu/tools/mesh_cli.py``. Three inputs:

  * a depth frame (``.npy``, [H, W] or [T, H, W] uint16, e.g. from a
    ``--record-dir`` capture): deprojected on the device, optionally
    bilateral-smoothed first, triangulated as an organized grid
    (``ops.mesh.organized_mesh``, the ``pcl::OrganizedFastMesh`` role) and
    optionally moved to the world frame with a ``.cal``;
  * a voxel-map checkpoint (``stitch_cli --map-leaf ... --map-out
    scene.npz``): the isosurface of the accumulated scene
    (``ops.surface.reconstruct_surface``, marching tetrahedra, welded);
  * a TSDF checkpoint (``models.tsdf.save_volume`` of either package): its
    zero level set (``models.tsdf.extract_mesh``). The ``.npz`` kind is
    told by its keys.

Usage:
  python -m pointcloud_stitching_tpu_torch.tools.mesh_cli depth.npy out.ply \\
      [--frame 0] [--intr cam0.intr.json] [--cal cam0.cal] \\
      [--max-edge 0.05] [--z-min 0.1] [--z-max 10] [--bilateral 0.03]
  python -m pointcloud_stitching_tpu_torch.tools.mesh_cli scene.npz out.ply \\
      [--iso 0.5] [--min-weight 0] [--saturate 1] [--smooth 1] \\
      [--max-nodes 256]
  python -m pointcloud_stitching_tpu_torch.tools.mesh_cli scene_tsdf.npz \\
      out.ply [--min-weight 1] [--cell-capacity 262144]

The device comes from PCS_PLATFORM: unset or ``cuda`` runs on the first
GPU (and fails without one), ``cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("depth", help="[H,W] or [T,H,W] uint16 depth .npy, or a "
                                  "voxel-map / TSDF checkpoint .npz")
    ap.add_argument("out", help="output mesh .ply")
    ap.add_argument("--frame", type=int, default=0,
                    help="frame index for [T,H,W] inputs")
    ap.add_argument("--intr", default=None,
                    help=".intr.json (default: D435 factory values)")
    ap.add_argument("--cal", default=None,
                    help="4x4 .cal to world frame (default: sensor frame)")
    ap.add_argument("--max-edge", type=float, default=0.05,
                    help="cut triangles with edges past this (meters)")
    ap.add_argument("--z-min", type=float, default=0.1)
    ap.add_argument("--z-max", type=float, default=10.0)
    ap.add_argument("--bilateral", type=float, default=None,
                    metavar="SIGMA_R",
                    help="edge-preserving bilateral smooth of the depth "
                         "before meshing (pcl::FastBilateralFilter role; "
                         "SIGMA_R in meters, e.g. 0.03; spatial sigma 3 px)")
    g = ap.add_argument_group("voxel-map and TSDF inputs (.npz checkpoints)")
    g.add_argument("--iso", type=float, default=0.5,
                   help="occupancy iso level (0..1)")
    g.add_argument("--min-weight", type=float, default=None,
                   help="ignore voxels below this evidence weight (default "
                        "0 for voxel-map checkpoints, 1 for TSDF "
                        "checkpoints; an explicit value, 0 included, is "
                        "used as given)")
    g.add_argument("--saturate", type=float, default=1.0,
                   help="weight at which occupancy clips to 1")
    g.add_argument("--smooth", type=int, default=1,
                   help="3^3 box-filter passes over the field")
    g.add_argument("--max-nodes", type=int, default=256,
                   help="grid cap per axis when fitting the map bounds")
    g.add_argument("--cell-capacity", type=int, default=262144,
                   help="TSDF inputs: surface-cell budget for the "
                        "marching-tetrahedra extraction (raise if the tool "
                        "reports saturation)")
    args = ap.parse_args(argv)

    from pointcloud_stitching_tpu_torch.utils.platform import (
        platform_device, set_full_fp32_matmul)
    dev = platform_device()
    if dev.type == "cuda":
        set_full_fp32_matmul()

    if args.depth.endswith(".npz"):
        import numpy as np
        with np.load(args.depth) as z:
            is_tsdf = "tsdf" in z.files
        return _mesh_tsdf(args, dev) if is_tsdf else _mesh_map(args, dev)
    return _mesh_depth(args, dev)


def _mesh_depth(args, dev):
    """Depth frame -> organized triangle mesh (sensor or world frame)."""
    import numpy as np
    import torch

    from pointcloud_stitching_tpu_torch.io import load_cal, load_intrinsics
    from pointcloud_stitching_tpu_torch.io.plyio import save_mesh
    from pointcloud_stitching_tpu_torch.ops import (bilateral_depth,
                                                    deproject, se3_apply)
    from pointcloud_stitching_tpu_torch.ops.mesh import mesh_cloud_arrays
    from pointcloud_stitching_tpu_torch.utils.types import Intrinsics

    depth = np.load(args.depth)
    if depth.ndim == 3:
        depth = depth[args.frame]
    h, w = depth.shape
    if args.intr:
        intr = load_intrinsics(args.intr, device=dev)
    else:
        intr = Intrinsics.d435_default(width=w, height=h, device=dev)

    depth = torch.from_numpy(np.ascontiguousarray(depth)).to(dev)
    if args.bilateral is not None:
        depth = bilateral_depth(depth, sigma_range=args.bilateral)
    pc = deproject(depth, intr, z_min=args.z_min, z_max=args.z_max)
    xyz = pc.xyz
    if args.cal:
        xyz = se3_apply(torch.from_numpy(load_cal(args.cal)).to(dev), xyz)
    verts, faces = mesh_cloud_arrays(xyz.reshape(h, w, 3),
                                     pc.mask.reshape(h, w),
                                     max_edge=args.max_edge)
    save_mesh(args.out, verts, faces)
    print(f"{args.out}: {len(verts)} vertices, {len(faces)} triangles "
          f"(max edge {args.max_edge} m)", flush=True)
    return len(faces)


def _mesh_tsdf(args, dev):
    """TSDF checkpoint -> zero-level-set mesh."""
    from pointcloud_stitching_tpu_torch.io.plyio import save_mesh
    from pointcloud_stitching_tpu_torch.models.tsdf import (extract_mesh,
                                                            load_volume)
    from pointcloud_stitching_tpu_torch.ops.surface import weld_mesh

    vol = load_volume(args.depth, device=dev)
    mw = 1.0 if args.min_weight is None else args.min_weight
    verts, valid, n_active = extract_mesh(
        vol, cell_capacity=args.cell_capacity, min_weight=mw)
    n_act = int(n_active)
    if n_act > args.cell_capacity:
        print(f"warning: {n_act} surface cells exceed --cell-capacity "
              f"{args.cell_capacity}; the sorted tail was dropped — "
              "re-run with a larger budget", flush=True)
    vw, fw = weld_mesh(verts, valid)
    save_mesh(args.out, vw, fw)
    print(f"{args.out}: {len(vw)} vertices, {len(fw)} triangles "
          f"({n_act} surface cells, tsdf zero level)", flush=True)
    return len(fw)


def _mesh_map(args, dev):
    """Voxel-map checkpoint -> isosurface mesh of the accumulated scene."""
    from pointcloud_stitching_tpu_torch.io.plyio import save_mesh
    from pointcloud_stitching_tpu_torch.models.voxel_map import load_map
    from pointcloud_stitching_tpu_torch.ops.surface import reconstruct_surface

    vmap = load_map(args.depth, device=dev)
    mw = 0.0 if args.min_weight is None else args.min_weight
    verts, faces, n_active = reconstruct_surface(
        vmap, iso=args.iso, min_weight=mw, saturate=args.saturate,
        smooth_iters=args.smooth, max_nodes=args.max_nodes)
    save_mesh(args.out, verts, faces)
    print(f"{args.out}: {len(verts)} vertices, {len(faces)} triangles "
          f"({n_active} surface cells, iso {args.iso})", flush=True)
    return len(faces)


if __name__ == "__main__":
    main()
