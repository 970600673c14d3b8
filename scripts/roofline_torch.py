#!/usr/bin/env python3
"""Per-stage roofline of the flagship 8-camera frame on one NVIDIA GPU.

The port's counterpart of scripts/roofline.py. Each stage of the port's
stitch step runs alone at the flagship shapes (8 x 848x480, bench.py's
config, ``kernel_impl='auto'``: K1, K2 and K3 on the card). Its device
time per call (``ms``) is the card's busy time: the summed durations of
the kernels and copies that ``torch.profiler`` records over back-to-back
calls, so neither the host's launch gaps nor its syncs count, however
many launches a call makes. The device operations per call
(``launches``) and the host time per call (the same calls unprofiled,
closed by a synchronize, ``host_ms``) go beside it.

Two bounds per stage, both from ``bench_card.bound`` (the one that
chip_smoke.py's kernels line uses): the larger of bytes over 3.35 TB/s and
operations over 132 x 128 x 1.98e9 float32 instructions a second.

  * SoL: the stage's function, every input read once and every output
    written once; bytes only.
  * ALG: the algorithm the port runs. ``torch.sort`` on CUDA is a radix
    sort (CUB), taken here as one 8-bit digit pass per key byte, each pass
    reading and writing the keys and the int64 permutation; a segment sum
    (K1, K2) reads its rows (values and flag or id) and writes its slots
    once; the NN (K3) issues 9 operations a pair (3 subtractions, 3
    multiplications, 2 additions, a compare), as PERF.md's kernel table
    counts it.

x_sol and x_alg are the measured ms over the bound.

Run on the card: ``python3 scripts/roofline_torch.py`` (about 10 s after
the build on an H100).
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from bench_card import (F32_INSTR_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                        _flagship, bound)
from pointcloud_stitching_tpu_torch import stitch_step  # noqa: E402
from pointcloud_stitching_tpu_torch.ops import (  # noqa: E402
    deproject, fuse_batched, grid_normals, icp_point_to_plane_batched,
    voxel_downsample)
from pointcloud_stitching_tpu_torch.utils.platform import (  # noqa: E402
    platform_device, set_full_fp32_matmul)
from pointcloud_stitching_tpu_torch.utils.types import (  # noqa: E402
    PointCloud)

XYZ_MASK = 13        # bytes of a point: float32 xyz + bool mask
DEPROJECT_OPS = 11   # per pixel: convert, scale, 2 range tests, and, 2 x
#                      (subtract, divide), 2 multiplies
NN_OPS = 9           # per query-reference pair (PERF.md's kernel table)
PERM_BYTES = 8       # torch.sort's int64 permutation


def sort_bytes(rows: int, key_bytes: int) -> int:
    """Bytes a radix sort of ``rows`` keys of ``key_bytes`` moves: one
    8-bit digit pass per key byte, each reading and writing the keys and
    the int64 permutation."""
    return key_bytes * rows * (key_bytes + PERM_BYTES) * 2


def voxel_alg_bytes(rows: int, key_bytes: int, channels: int, slots: int,
                    id_bytes: int, row_bytes: int = XYZ_MASK,
                    out_bytes: int = XYZ_MASK) -> int:
    """Bytes of one voxel pass as the port runs it: read the points, sort
    the keys, the segment sum reading ``channels`` float32 values and an
    id (K2: int32) or flag (K1: bool) a row and writing its slots, then
    the centroids written."""
    return (rows * row_bytes + sort_bytes(rows, key_bytes)
            + rows * (channels * 4 + id_bytes) + slots * channels * 4
            + slots * out_bytes)


def icp_work(pairs: int, iterations: int, cap: int):
    """(ALG bytes, operations) of ``iterations`` batched point-to-plane
    ICP iterations over ``pairs`` clouds of ``cap`` slots: each iteration
    reads source, destination and normals once; the NN issues NN_OPS a
    pair."""
    per_iter = pairs * cap * (XYZ_MASK * 2 + 12)
    return iterations * per_iter, pairs * iterations * cap * cap * NN_OPS


def _row(stage: str, timed: tuple, sol_bytes: float, alg_bytes: float,
         alg_ops: float = 0.0, note: str = "") -> dict:
    """A stage's row from ``timed`` = (device ms, host ms, launches) per
    call and its bytes and operations."""
    ms, host_ms, launches = timed
    sol_ms, _ = bound(sol_bytes, 0.0)
    alg_ms, alg_by = bound(alg_bytes, alg_ops)
    return {"stage": stage, "ms": ms, "host_ms": host_ms,
            "launches": launches, "sol_mb": sol_bytes / 1e6,
            "sol_ms": sol_ms,
            "alg_ms": alg_ms, "alg_by": alg_by,
            "x_sol": ms / sol_ms, "x_alg": ms / alg_ms, "note": note}


def _time(fn, iters: int):
    """(device ms, host ms, device operations) per call of ``fn``: the
    host's calls closed by a synchronize, then the same calls under
    ``torch.profiler``, whose device records give the card's busy time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in dev_ops)
    launches = sum(e.count for e in dev_ops) / iters
    if busy_us <= 0 or launches < 1:
        raise RuntimeError("torch.profiler recorded no device operation")
    return busy_us / 1e3 / iters, host_ms, launches


def collect(iters: int = 30) -> dict:
    """Time every stage on the card and return the roofline dict."""
    dev = platform_device()
    if dev.type != "cuda":
        raise RuntimeError("roofline_torch times the card; it has no CPU "
                           "mode")
    set_full_fp32_matmul()
    ncam, h, w = 8, 480, 848
    cfg, intr, ext_np, depths_np = _flagship(ncam, h, w, dev)
    depths = torch.from_numpy(depths_np).to(dev)
    ext = torch.from_numpy(ext_np).to(dev)
    npx = ncam * h * w
    impl = cfg.kernel_impl
    rows = []

    # ---- deproject + validity (elementwise, one pass) ------------------
    def dj():
        return deproject(depths, intr, depth_scale=cfg.depth_scale,
                         z_min=cfg.z_min, z_max=cfg.z_max)
    raw = dj()
    timed = _time(dj, iters)
    dep_bytes = npx * 2 + npx * XYZ_MASK      # u16 in; xyz + mask out
    rows.append(_row("deproject+mask", timed, dep_bytes, dep_bytes,
                     npx * DEPROJECT_OPS, note="elementwise: ALG = SoL"))

    # ---- per-camera voxel pass (sort + K2), packed int32 key -----------
    def vj():
        return voxel_downsample(raw, cfg.cam_voxel_leaf,
                                capacity=cfg.cam_capacity, impl=impl)
    cam_clouds = vj()
    timed = _time(vj, iters)
    cap_c = ncam * cfg.cam_capacity
    rows.append(_row(
        "cam_voxel (sort+K2)", timed, (npx + cap_c) * XYZ_MASK,
        voxel_alg_bytes(npx, 4, 7, ncam * (cfg.cam_capacity + 1), 4),
        note=f"radix sort of {ncam} x {h * w} int32 keys: 4 digit passes "
             f"of {sort_bytes(npx, 4) / 4e6:.1f} MB; K2 7 channels; 1 host "
             "sync; not run by the flagship frame (cam_voxel_enabled "
             "False)"))

    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, 2 ** 30, (ncam, h * w), generator=gen,
                         device=dev, dtype=torch.int32)
    timed = _time(lambda: torch.sort(keys, dim=-1), iters)
    rows.append(_row(
        f"  sort alone (int32, {ncam} x {h * w})", timed,
        npx * 4 + npx * (4 + PERM_BYTES), sort_bytes(npx, 4),
        note="cam_voxel's key shape, random keys below 2^30: 4 digit "
             "passes"))

    # ---- ring ICP drift: 7 pairs x 5 iterations at 2048^2 (K3) ---------
    s = cfg.icp_stride
    sub_xyz = raw.xyz.reshape(ncam, h, w, 3)[:, ::s, ::s]
    sub_mask = raw.mask.reshape(ncam, h, w)[:, ::s, ::s]
    nrm, nvalid = grid_normals(sub_xyz, sub_mask)
    sub = PointCloud(xyz=sub_xyz.reshape(ncam, -1, 3),
                     mask=(sub_mask & nvalid).reshape(ncam, -1),
                     rgb=nrm.reshape(ncam, -1, 3))

    def ivj():
        return voxel_downsample(sub, cfg.icp_voxel_leaf,
                                capacity=cfg.icp_capacity, impl=impl)
    icp_clouds = ivj()
    src = PointCloud(xyz=icp_clouds.xyz[1:], mask=icp_clouds.mask[1:])
    dst = PointCloud(xyz=icp_clouds.xyz[:-1], mask=icp_clouds.mask[:-1])
    dn = icp_clouds.rgb[:-1]

    def ij():
        return icp_point_to_plane_batched(
            src, dst, dn, iterations=cfg.icp_iterations,
            max_corr_dist=cfg.icp_max_corr_dist, nn_impl=impl).T
    timed = _time(ij, iters)
    npair, cap = ncam - 1, cfg.icp_capacity
    alg_b, ops = icp_work(npair, cfg.icp_iterations, cap)
    rows.append(_row(
        f"icp drift ({npair} pairs x {cfg.icp_iterations} iters, "
        f"{cap}^2 NN)", timed,
        npair * cap * (XYZ_MASK * 2 + 12) + npair * 64, alg_b, ops,
        note=f"{ops / 1e9:.2f} G NN operations: {cfg.icp_iterations} K3 "
             f"calls at {npair}/8 of the frame's 8-pair K3 bound"))

    n_sub = sub.xyz.shape[0] * sub.xyz.shape[1]
    icp_voxel = voxel_alg_bytes(n_sub, 8, 7, ncam * (cap + 1), 4,
                                row_bytes=XYZ_MASK + 12,
                                out_bytes=XYZ_MASK + 12)
    timed = _time(ivj, iters)
    rows.append(_row(
        f"  icp_voxel (stride-{s} sub -> {cap}/cam)", timed,
        n_sub * (XYZ_MASK + 12) + ncam * cap * (XYZ_MASK + 12),
        icp_voxel,
        note=f"exact branch ({cfg.icp_voxel_leaf} m > 0.03 m): int64 "
             f"keys, 8 digit passes over {n_sub} rows; K2 7 channels"))

    # ---- fuse + output voxel pass (sort + K1), packed int32 key --------
    fused = fuse_batched(cam_clouds)
    n_f = fused.xyz.shape[0]

    def oj():
        return voxel_downsample(fused, cfg.out_voxel_leaf,
                                capacity=cfg.out_capacity, impl=impl)
    timed = _time(oj, iters)
    cap_o = cfg.out_capacity
    rows.append(_row(
        f"out_voxel ({n_f} fused -> {cap_o})", timed,
        (n_f + cap_o) * XYZ_MASK, voxel_alg_bytes(n_f, 4, 7, cap_o, 1),
        note=f"radix sort of {n_f} int32 keys: 4 digit passes; K1 "
             "counted as PERF.md "
             f"counts it with every row read ({n_f} x 29 B + {cap_o} x "
             "28 B); PERF.md's K1 row is the frame's own 3,256,320-row "
             "pass; 1 host sync"))

    # ---- the full frame -------------------------------------------------
    def fj():
        return stitch_step(cfg, intr, ext, depths)
    ms, host, launches = _time(fj, iters)
    stages = [r for r in rows if not r["stage"].startswith("  ")]
    # the frame's own work: deproject, the ICP voxel pass, 8 ring pairs
    # (closure on), the global pass over every pixel; no camera pass
    ring_b, ring_ops = icp_work(ncam, cfg.icp_iterations, cap)
    parts = [bound(dep_bytes, npx * DEPROJECT_OPS)[0],
             bound(icp_voxel, 0.0)[0], bound(ring_b, ring_ops)[0],
             bound(voxel_alg_bytes(npx, 4, 7, cap_o, 1), 0.0)[0]]
    sol_ms, _ = bound(npx * 2 + cap_o * XYZ_MASK + ncam * 64 * 2, 0.0)
    alg_ms = sum(parts)
    rows.append({
        "stage": f"FULL FRAME (stitch_step, {ncam} cam)", "ms": ms,
        "host_ms": host, "launches": launches,
        "idle_share": max(0.0, 1.0 - ms / host),
        "sum_of_stages_ms": sum(r["ms"] for r in stages),
        "sol_ms": sol_ms, "alg_ms": alg_ms, "x_sol": ms / sol_ms,
        "x_alg": ms / alg_ms,
        "note": "SoL: depth in, cloud and extrinsics out; ALG: the sum of "
                "the frame's own stages at its shapes (deproject, the ICP "
                "voxel pass (8 digit passes), 8 ring pairs, the global "
                "pass over every pixel (4 digit passes); no camera pass); "
                "2 host syncs"})
    return {"device": torch.cuda.get_device_name(dev),
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "f32_instr_per_s": F32_INSTR_PER_S, "iters": iters,
            "rows": rows}


def main() -> int:
    print(json.dumps(collect(), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
