#!/usr/bin/env python
"""Scene analysis CLI: plane removal + Euclidean clustering on a cloud file.

Port of ``pointcloud_stitching_tpu/tools/segment_cli.py``. The
shell-level counterpart of the PCL tool idiom this class of rig uses
downstream of stitching (pcl::SACSegmentation → ExtractIndices →
EuclideanClusterExtraction): take a .ply/.pcd (e.g. a saved stitched
frame, a viewer snapshot, or an accumulated scene map), optionally remove
the dominant plane(s), split the rest into objects, and write one .ply
per cluster plus a summary table.

Usage:
  python -m pointcloud_stitching_tpu_torch.tools.segment_cli scene.ply \
      out_dir [--drop-plane 0.02 [--planes 1]] [--tolerance 0.05] \
      [--min-size 30] [--max-clusters 16] [--exact] \
      [--smooth-angle 20 [--max-curvature 0.02]] [--obb] [--hull]

The device comes from PCS_PLATFORM: unset or ``cuda`` runs on the first
GPU (and fails without one), ``cpu`` runs on the CPU. ``--seed`` seeds the
``torch.Generator`` the planes draw from, one plane after another, so a
run is deterministic per seed and device (the JAX CLI splits a key: the
draws differ between the two).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cloud", help="input .ply/.pcd")
    ap.add_argument("out_dir", help="output directory (cluster_%%02d.ply)")
    ap.add_argument("--drop-plane", type=float, default=None, metavar="DIST",
                    help="remove dominant plane inliers within DIST meters "
                         "before clustering (floor/walls)")
    ap.add_argument("--planes", type=int, default=1,
                    help="how many planes to remove successively")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="cluster distance (meters)")
    ap.add_argument("--min-size", type=int, default=30,
                    help="drop clusters below this many points")
    ap.add_argument("--max-clusters", type=int, default=16)
    ap.add_argument("--exact", action="store_true",
                    help="exact-radius connectivity (PCL's precise "
                         "semantics; O(N^2) per round — for analysis-"
                         "scale clouds) instead of voxel adjacency")
    ap.add_argument("--smooth-angle", type=float, default=None,
                    metavar="DEG",
                    help="segment into smooth surface patches instead "
                         "(pcl::RegionGrowing role): points join a region "
                         "only when their estimated normals agree within "
                         "DEG degrees (implies exact-radius connectivity)")
    ap.add_argument("--normal-radius", type=float, default=None,
                    help="--smooth-angle normal/curvature estimation "
                         "radius (default 2x tolerance)")
    ap.add_argument("--max-curvature", type=float, default=None,
                    help="--smooth-angle: exclude points with surface "
                         "variation above this (creases/edges; "
                         "PCL's curvature test)")
    ap.add_argument("--mls", type=float, default=None, metavar="RADIUS",
                    help="moving-least-squares smooth the cloud first "
                         "(plane-projection MLS, pcl::MovingLeastSquares "
                         "role; RADIUS in meters)")
    ap.add_argument("--changed-vs", default=None, metavar="REF",
                    help="segment only what CHANGED vs a baseline "
                         "(pcl::OctreePointCloudChangeDetector role): a "
                         ".ply/.pcd cloud or a .npz voxel-map checkpoint; "
                         "points in voxels the baseline occupies are "
                         "dropped before analysis")
    ap.add_argument("--change-leaf", type=float, default=0.05,
                    help="--changed-vs voxel resolution in meters "
                         "(ignored for .npz baselines: the map's own "
                         "leaf applies)")
    ap.add_argument("--obb", action="store_true",
                    help="also print each cluster's oriented bounding "
                         "box (pcl::MomentOfInertiaEstimation getOBB "
                         "role: covariance-eigenvector axes)")
    ap.add_argument("--hull", action="store_true",
                    help="also write each cluster's convex hull mesh "
                         "(pcl::ConvexHull role, exact qhull over the "
                         "cluster) as cluster_%%02d_hull.ply and print "
                         "its area/volume")
    ap.add_argument("--hull-alpha", type=float, default=None,
                    metavar="ALPHA",
                    help="alpha-shape concave hull instead of convex "
                         "(pcl::ConcaveHull setAlpha role; ALPHA = "
                         "circumradius bound in meters); implies --hull")
    ap.add_argument("--seed", type=int, default=0,
                    help="plane-RANSAC generator seed (deterministic per "
                         "seed)")
    args = ap.parse_args(argv)
    if args.hull_alpha is not None:
        args.hull = True

    import numpy as np
    import torch

    from ..io import load_pcd, load_ply
    from ..io.plyio import save_mesh, save_ply
    from ..ops import (cluster_stats, concave_hull, convex_hull,
                       euclidean_clusters, euclidean_clusters_exact,
                       extract_plane, oriented_bboxes, segment_plane)
    from ..utils.platform import platform_device, set_full_fp32_matmul
    from ..utils.types import PointCloud, round_up

    set_full_fp32_matmul()
    dev = platform_device()

    def load(path):
        return load_pcd(path) if path.endswith(".pcd") else load_ply(path)

    xyz, rgb = load(args.cloud)
    pc = PointCloud.from_points(xyz, capacity=round_up(len(xyz), 1024),
                                device=dev)
    print(f"{args.cloud}: {int(pc.count())} points", flush=True)

    if args.changed_vs is not None:
        from ..ops.change import detect_changes, detect_changes_map
        if args.changed_vs.endswith(".npz"):
            from ..models.voxel_map import load_map
            vmap = load_map(args.changed_vs, device=dev)
            changed = detect_changes_map(vmap, pc)
            leaf_used = float(vmap.leaf)
        else:
            rxyz, _ = load(args.changed_vs)
            ref = PointCloud.from_points(rxyz,
                                         capacity=round_up(len(rxyz), 1024),
                                         device=dev)
            changed = detect_changes(ref, pc, args.change_leaf)
            leaf_used = args.change_leaf
        pc = pc.replace(mask=pc.mask & changed)
        print(f"changed vs {args.changed_vs} (leaf {leaf_used} m): "
              f"{int(pc.count())} points remain", flush=True)

    if args.mls is not None:
        from ..ops import mls_smooth
        pc = mls_smooth(pc, args.mls)
        print(f"MLS-smoothed (radius {args.mls} m)", flush=True)

    if args.drop_plane is not None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for i in range(args.planes):
            model, _, count = segment_plane(pc, args.drop_plane, gen)
            c = int(count)
            if c == 0:
                print(f"plane {i}: none found, stopping", flush=True)
                break
            m = model.cpu().numpy()
            print(f"plane {i}: n=({m[0]:+.3f}, {m[1]:+.3f}, {m[2]:+.3f}) "
                  f"d={m[3]:+.3f}, {c} inliers removed", flush=True)
            pc = extract_plane(pc, model, args.drop_plane)

    if args.smooth_angle is not None:
        from ..ops import estimate_curvature, estimate_normals, region_growing
        nr = (2.0 * args.tolerance if args.normal_radius is None
              else args.normal_radius)
        nrm, okn = estimate_normals(pc, nr)
        curv = None
        if args.max_curvature is not None:
            curv, okc = estimate_curvature(pc, nr)
            okn = okn & okc    # unsupported points carry curv 0: gate them
        labels, num, _ = region_growing(
            pc, nrm, args.tolerance, float(np.deg2rad(args.smooth_angle)),
            normals_valid=okn, curvature=curv,
            curvature_threshold=args.max_curvature,
            min_size=args.min_size, max_clusters=args.max_clusters)
        print(f"region growing: smoothness {args.smooth_angle} deg, "
              f"normal radius {nr} m", flush=True)
    else:
        cluster_fn = euclidean_clusters_exact if args.exact \
            else euclidean_clusters
        labels, num, _ = cluster_fn(
            pc, args.tolerance, min_size=args.min_size,
            max_clusters=args.max_clusters)
    cent, lo, hi, cnt = (t.cpu().numpy() for t in cluster_stats(
        pc, labels, max_clusters=args.max_clusters))
    obb = None
    if args.obb:
        obb = [t.cpu().numpy() for t in oriented_bboxes(
            pc, labels, max_clusters=args.max_clusters)]
    n = int(num)
    print(f"{n} clusters (tolerance {args.tolerance} m, "
          f"min size {args.min_size}):", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    labels_np = labels.cpu().numpy()
    xyz_np = pc.xyz.cpu().numpy()
    for k in range(n):
        sel = labels_np == k
        ck, lk, hk = cent[k], lo[k], hi[k]
        path = os.path.join(args.out_dir, f"cluster_{k:02d}.ply")
        save_ply(path, xyz_np[sel],
                 None if rgb is None else np.asarray(rgb)[sel[:len(rgb)]])
        print(f"  #{k}: {int(cnt[k])} pts  "
              f"centroid ({ck[0]:+.3f}, {ck[1]:+.3f}, {ck[2]:+.3f})  "
              f"size ({hk[0]-lk[0]:.3f} x {hk[1]-lk[1]:.3f} x "
              f"{hk[2]-lk[2]:.3f}) m -> {path}", flush=True)
        if args.hull:
            try:
                cpc = PointCloud.from_points(xyz_np[sel], device=dev)
                h = (concave_hull(cpc, args.hull_alpha)
                     if args.hull_alpha is not None
                     else convex_hull(cpc, exact=True))
                hp = os.path.join(args.out_dir,
                                  f"cluster_{k:02d}_hull.ply")
                save_mesh(hp, h.vertices, h.faces)
                print(f"       hull {len(h.vertices)} verts, "
                      f"area {h.area:.4f} m^2, "
                      f"volume {h.volume * 1000:.2f} L -> {hp}",
                      flush=True)
            except ValueError as e:
                print(f"       hull: skipped ({e})", flush=True)
        if obb is not None:
            hf, ax = obb[2][k], obb[1][k]
            yaw = np.degrees(np.arctan2(ax[0, 1], ax[0, 0]))
            print(f"       obb {2*hf[0]:.3f} x {2*hf[1]:.3f} x "
                  f"{2*hf[2]:.3f} m (major-axis yaw {yaw:+.1f} deg)",
                  flush=True)
    return n


if __name__ == "__main__":
    main()
