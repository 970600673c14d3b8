#!/usr/bin/env python
"""Mesh a TSDF checkpoint: scene_tsdf.npz in, triangle-mesh .ply out.

Port of the TSDF branch of ``pointcloud_stitching_tpu/tools/mesh_cli.py``.
A TSDF checkpoint (``models.tsdf.save_volume`` of either package) is meshed
at its zero level set, the watertight KinectFusion surface
(``models.tsdf.extract_mesh``, welded by ``ops.surface.weld_mesh``). The
other two inputs of the JAX tool are not ported yet and exit with an
error: a depth frame (``.npy``; ``ops/mesh.py``, ROADMAP item 11) and a
voxel-map checkpoint (``.npz`` without a ``tsdf`` key; ``voxel_map`` and
``reconstruct_surface``, ROADMAP item 10).

Usage:
  python -m pointcloud_stitching_tpu_torch.tools.mesh_cli scene_tsdf.npz \\
      out.ply [--min-weight 1] [--cell-capacity 262144]

The device comes from PCS_PLATFORM: unset or ``cuda`` runs on the first
GPU (and fails without one), ``cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("depth", help="TSDF checkpoint .npz (a depth .npy or a "
                                  "voxel-map .npz is not ported yet)")
    ap.add_argument("out", help="output mesh .ply")
    # the JAX tool's flags, kept so that its command lines parse; those of
    # the unported inputs are read by nothing yet
    d = ap.add_argument_group("depth-frame input (not ported yet)")
    d.add_argument("--frame", type=int, default=0)
    d.add_argument("--intr", default=None)
    d.add_argument("--cal", default=None)
    d.add_argument("--max-edge", type=float, default=0.05)
    d.add_argument("--z-min", type=float, default=0.1)
    d.add_argument("--z-max", type=float, default=10.0)
    d.add_argument("--bilateral", type=float, default=None,
                   metavar="SIGMA_R")
    g = ap.add_argument_group(".npz checkpoints")
    g.add_argument("--iso", type=float, default=0.5,
                   help="voxel-map inputs (not ported yet)")
    g.add_argument("--min-weight", type=float, default=None,
                   help="ignore voxels below this evidence weight (default "
                        "1 for TSDF checkpoints; an explicit value, 0 "
                        "included, is used as given)")
    g.add_argument("--saturate", type=float, default=1.0,
                   help="voxel-map inputs (not ported yet)")
    g.add_argument("--smooth", type=int, default=1,
                   help="voxel-map inputs (not ported yet)")
    g.add_argument("--max-nodes", type=int, default=256,
                   help="voxel-map inputs (not ported yet)")
    g.add_argument("--cell-capacity", type=int, default=262144,
                   help="TSDF inputs: surface-cell budget for the "
                        "marching-tetrahedra extraction (raise if the tool "
                        "reports saturation)")
    args = ap.parse_args(argv)

    if not args.depth.endswith(".npz"):
        sys.exit(f"{args.depth}: meshing a depth frame (ops/mesh.py) is not "
                 "ported yet (ROADMAP item 11)")
    import numpy as np
    with np.load(args.depth) as z:
        is_tsdf = "tsdf" in z.files
    if not is_tsdf:
        sys.exit(f"{args.depth}: meshing a voxel-map checkpoint (voxel_map, "
                 "reconstruct_surface) is not ported yet (ROADMAP item 10)")
    return _mesh_tsdf(args)


def _mesh_tsdf(args):
    """TSDF checkpoint -> zero-level-set mesh."""
    from pointcloud_stitching_tpu_torch.io.plyio import save_mesh
    from pointcloud_stitching_tpu_torch.models.tsdf import (extract_mesh,
                                                            load_volume)
    from pointcloud_stitching_tpu_torch.ops.surface import weld_mesh
    from pointcloud_stitching_tpu_torch.utils.platform import (
        platform_device, set_full_fp32_matmul)

    dev = platform_device()
    if dev.type == "cuda":
        set_full_fp32_matmul()
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


if __name__ == "__main__":
    main()
