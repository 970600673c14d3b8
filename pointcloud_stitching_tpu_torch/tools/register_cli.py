#!/usr/bin/env python
"""Pairwise registration CLI: two clouds in, one .cal out.

Port of ``pointcloud_stitching_tpu/tools/register_cli.py`` (the
reference's registration tool, adapted from PCL's manual_registration —
SURVEY.md §3.4). Picks come from a correspondence file (or pure-ICP
alignment with --no-picks, or none at all with --global, optionally with
FPFH-seeded starts); --gicp finishes with plane-to-plane Generalized ICP:

  picks file: one "src_idx dst_idx" pair per line, >=3 lines.

Usage:
  python -m pointcloud_stitching_tpu_torch.tools.register_cli \\
      src.ply dst.ply out.cal [--picks picks.txt] [--max-corr-dist 0.25] \\
      [--max-iter 50] [--no-refine] [--prune] [--global [--fpfh-starts N]] \
      [--gicp [--gicp-normal-radius 0.05]]

The device comes from PCS_PLATFORM: unset or ``cuda`` runs on the first
GPU (and fails without one), ``cpu`` runs the kernels' plain versions on
the CPU.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="source cloud (.ply or .pcd)")
    ap.add_argument("dst", help="target cloud (.ply or .pcd)")
    ap.add_argument("out", help="output .cal path")
    ap.add_argument("--picks", help="correspondence file (src_idx dst_idx)")
    ap.add_argument("--no-picks", action="store_true",
                    help="pure ICP from identity (clouds must be roughly "
                         "aligned already)")
    ap.add_argument("--global", dest="global_init", action="store_true",
                    help="automatic registration with NO picks and NO "
                         "rough alignment: parallel multi-start ICP "
                         "(identity + 24 PCA-basis alignments + random "
                         "rotations, all batched), winner refined")
    ap.add_argument("--starts", type=int, default=64,
                    help="--global hypothesis count")
    ap.add_argument("--fpfh-starts", type=int, default=0,
                    help="--global: extra hypotheses seeded from FPFH "
                         "descriptor correspondences (SAC-IA role) — for "
                         "scenes whose geometry alone is ambiguous")
    ap.add_argument("--coarse-leaf", type=float, default=0.05,
                    help="--global skeleton resolution (auto-coarsens "
                         "to fit)")
    ap.add_argument("--no-refine", action="store_true",
                    help="skip ICP refinement (picked-pair SVD only)")
    ap.add_argument("--max-corr-dist", type=float, default=0.25)
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--epsilon", type=float, default=1e-8)
    ap.add_argument("--trim", type=float, default=0.0,
                    help="trimmed-ICP rejection fraction (partial overlap)")
    ap.add_argument("--prune", action="store_true",
                    help="key-range-pruned NN (exact; pays off on large "
                         "voxel-sorted clouds)")
    ap.add_argument("--voxel", type=float, default=None,
                    help="pre-downsample both clouds (meters)")
    ap.add_argument("--gicp", action="store_true",
                    help="finish with plane-to-plane Generalized ICP "
                         "(pcl::GeneralizedICP role): registers the "
                         "surfaces rather than the sample positions")
    ap.add_argument("--gicp-normal-radius", type=float, default=0.05,
                    help="--gicp normal-estimation radius (meters)")
    args = ap.parse_args(argv)

    import numpy as np

    from pointcloud_stitching_tpu_torch.io import load_pcd, load_ply
    from pointcloud_stitching_tpu_torch.models import (register_global,
                                                       register_pair,
                                                       write_cal)
    from pointcloud_stitching_tpu_torch.ops import voxel_downsample
    from pointcloud_stitching_tpu_torch.utils import prng
    from pointcloud_stitching_tpu_torch.utils.platform import (
        platform_device, set_full_fp32_matmul)
    from pointcloud_stitching_tpu_torch.utils.types import PointCloud, round_up

    dev = platform_device()
    set_full_fp32_matmul()

    def load(path):
        xyz, _ = (load_pcd(path) if path.endswith(".pcd")
                  else load_ply(path))
        pc = PointCloud.from_points(xyz, capacity=round_up(len(xyz), 1024),
                                    device=dev)
        if args.voxel:
            pc = voxel_downsample(pc, args.voxel, capacity=pc.capacity)
        return pc

    src, dst = load(args.src), load(args.dst)
    print(f"src: {int(src.count())} pts, dst: {int(dst.count())} pts",
          flush=True)

    if args.global_init:
        res = register_global(src, dst, prng.key(0, device=dev),
                              num_starts=args.starts,
                              fpfh_starts=args.fpfh_starts,
                              coarse_leaf=args.coarse_leaf,
                              refine=not args.no_refine,
                              max_iterations=args.max_iter,
                              transformation_epsilon=args.epsilon,
                              max_corr_dist=args.max_corr_dist,
                              trim_fraction=args.trim, prune=args.prune)
    else:
        src_idx = dst_idx = None
        if args.picks:
            pairs = np.loadtxt(args.picks, dtype=np.int64).reshape(-1, 2)
            if len(pairs) < 3:
                sys.exit("need >=3 correspondence pairs")
            src_idx, dst_idx = pairs[:, 0], pairs[:, 1]
        elif not args.no_picks:
            sys.exit("provide --picks FILE, --no-picks, or --global")
        res = register_pair(src, dst, src_idx=src_idx, dst_idx=dst_idx,
                            refine=not args.no_refine,
                            max_iterations=args.max_iter,
                            transformation_epsilon=args.epsilon,
                            max_corr_dist=args.max_corr_dist,
                            trim_fraction=args.trim, prune=args.prune)
    if args.gicp:
        # plane-to-plane polish on top of whichever initialisation ran
        # (picks / identity / --global winner): the two scans never share
        # sample sites exactly, their surfaces do
        from pointcloud_stitching_tpu_torch.ops import (estimate_normals,
                                                        gicp)
        nr = args.gicp_normal_radius
        ns, oks = estimate_normals(src, nr)
        nd, okd = estimate_normals(dst, nr)
        g = gicp(src, dst, ns, nd, oks, okd, init_T=res.T,
                 max_iterations=args.max_iter,
                 transformation_epsilon=args.epsilon,
                 max_corr_dist=args.max_corr_dist,
                 trim_fraction=args.trim)
        print(f"GICP: {int(g.iterations)} iterations, "
              f"mahalanobis={float(g.mean_error):.3e}, "
              f"inliers={int(g.num_inliers)}", flush=True)
        # res.icp keeps the first stage's stats (metres^2); the GICP
        # residual above is Mahalanobis and prints under its own name
        res = res._replace(T=g.T)
    if res.icp is not None:
        print(f"ICP: {int(res.icp.iterations)} iterations, "
              f"mean_error={float(res.icp.mean_error):.3e}, "
              f"inliers={int(res.icp.num_inliers)}", flush=True)
    write_cal(args.out, res)
    print(f"wrote {args.out}")
    print(res.T.cpu().numpy())


if __name__ == "__main__":
    main()
