#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``pointcloud_stitching_tpu_torch.StitchingPipeline`` at the flagship
configuration (8 cameras of 848x480 u16 depth, ring point-to-plane ICP with
5 iterations, a 262144-slot 1 cm output grid) and the registration path
(``register_pair`` / ``register_global`` / the register CLI) at 131k x 131k
points, and checks the four hand-written CUDA kernels on those paths:

  1. device and settings: the card's name and power limit; full float32
     matmuls (no TF32) once a pipeline exists;
  2. build the kernels from csrc/ (nvcc, sm_90a) and print ptxas' report;
  3. each kernel against its plain PyTorch version at the shapes the main
     path gives it, on the card, then timed in turns with CUDA events;
  4. the slice: 10 frames in 'track' mode with kernel_impl='auto' and with
     'torch', at the saturated 1 cm leaf and at an unsaturated 6 cm leaf;
     outputs must agree and the kernels' launch counts must show that the
     'auto' run went through them (5 NN, 1 K1 and 1 K2 launch per frame at
     the flagship config);
  5. an independent check of the no-ICP step against the numpy oracle in
     tests/oracle.py;
  6. steady-state ms/frame and points/s, host syncs per frame, peak memory;
  7. the registration (calibration) path at the scale users run: two
     voxel-sorted clouds of >= 100k points (one 848x480 frame in 131072
     slots, and a moved copy with 1 mm noise). K4 against its plain version
     with the ranges block_ranges gives and with ranges narrowed on
     purpose, the pruned NN against brute-force K3, register_pair with
     pruned icp_converge ('auto' against 'torch', with one K3 and one K4
     launch per iteration), register_global against a ~2-rad misalignment,
     the register CLI as a subprocess, and timings.

Any failed check raises and the script exits non-zero. Run from the repo
root with no arguments: ``python3 chip_smoke.py``. It imports nothing of
JAX. The last line of its output is one JSON object with "ok": true.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NCAM, H, W = 8, 480, 848
FRAMES = 10
RTOL_F32 = 1e-6     # f32 centroids, kernel vs plain (see phase 3)
ATOL_F32 = 1e-6     # meters; keeps rtol meaningful for centroids near 0
ATOL_SLICE = 1e-4   # extrinsics and sorted clouds, 'auto' vs 'torch'
ATOL_ORACLE = 1e-4  # meters, centroids against the numpy oracle
REG_CAP = 131072    # registration cloud slots (docs/KERNELS.md's 131k case)
ATOL_REG = 1e-6     # registration T, 'auto' vs 'torch'
MAX_REG_ERR = 0.005  # meters, registered points against the true pose


def say(msg: str) -> None:
    print(msg, flush=True)


def flagship_scene():
    """The flagship scene of __graft_entry__._flagship, made with numpy."""
    rng = np.random.default_rng(0)
    ext = np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1))
    ext[:, :3, 3] = rng.uniform(-0.3, 0.3, (NCAM, 3)).astype(np.float32)
    depths = rng.integers(200, 4000, size=(NCAM, H, W), dtype=np.uint16)
    depths[rng.random((NCAM, H, W)) < 0.07] = 0
    return ext, depths


def flagship_cfg(StitchConfig, **kw):
    """bench.py's and __graft_entry__.py's flagship config (+ overrides)."""
    base = dict(num_cameras=NCAM, height=H, width=W,
                cam_voxel_leaf=0.01, cam_capacity=131072,
                out_voxel_leaf=0.01, out_capacity=262144,
                icp_enabled=True, icp_stride=6, icp_voxel_leaf=0.07,
                icp_capacity=2048, icp_iterations=5, icp_max_corr_dist=0.1,
                icp_query_tile=1024, icp_ref_tile=4096)
    return StitchConfig(**{**base, **kw})


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(kernel_fn, plain_fn, reps: int = 20):
    """(kernel ms, plain ms): warm up, then plain, kernel, kernel, plain."""
    import torch
    for _ in range(3):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                                StitchingPipeline)
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        nn_batched_prepared, prepare_ref_batched)
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        segment_sum_from_flags, segment_sum_sorted)
    from pointcloud_stitching_tpu_torch.ops import (deproject, fuse_batched,
                                                    grid_normals, se3_apply)
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    from pointcloud_stitching_tpu_torch.utils.types import PointCloud

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    say(f"[1/7 device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    info = kb.build()
    kb.library()
    say(f"[2/7 build] {info.path.name}: nvcc {info.seconds:.2f} s "
        f"({'cached' if info.cached else 'built'}), load "
        f"{time.perf_counter() - t0:.2f} s; ptxas:")
    for line in info.log.splitlines():
        if "ptxas info" in line or "bytes stack frame" in line:
            say("    " + line.strip())

    # --- phase 3: kernels vs plain versions at main-path shapes ---------
    ext_np, depths_np = flagship_scene()
    ext = torch.from_numpy(ext_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    raw = deproject(depths, intr, depth_scale=0.001, z_min=0.1, z_max=10.0)
    fused = fuse_batched(raw.replace(xyz=se3_apply(ext, raw.xyz)))
    kernels = {}

    def report(name, source, replaces, err, ms, plain_ms):
        kernels[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0,
                             max_abs_err=float(err), ms=ms, plain_ms=plain_ms)
        say(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"max |kernel - plain| {float(err):.3g}")

    # K1, packed branch: integer channels, must match bit for bit
    ijk = V.voxel_indices(fused.xyz, fused.mask, 0.01)
    flags, vals, _ = V._sorted_segments_packed(fused, 0.01, ijk)
    cap = 262144
    got = segment_sum_from_flags(vals, flags, cap, impl="cuda")
    want = segment_sum_from_flags(vals, flags, cap, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 packed sums differ from plain")
    err_k1 = (got - want).abs().max().item()
    say(f"[3/7 kernels] K1 packed {tuple(vals.shape)} cap {cap}: bitwise "
        f"equal ({int((want[:, 6] > 0).sum())} segments)")
    # K1, exact branch at the 6 cm leaf: float channels
    flags6, vals6 = V._sorted_segments(fused, 0.06)
    g6 = segment_sum_from_flags(vals6, flags6, cap, impl="cuda")
    w6 = segment_sum_from_flags(vals6, flags6, cap, impl="torch")
    n6 = torch.clamp(w6[:, 3:4], min=1.0)
    torch.testing.assert_close(g6[:, :3] / n6, w6[:, :3] / n6,
                               rtol=RTOL_F32, atol=ATOL_F32)
    err_k1 = max(err_k1, (g6 - w6).abs().max().item())
    say(f"    K1 exact {tuple(vals6.shape)}: centroids within rtol "
        f"{RTOL_F32}; bitwise equal: {torch.equal(g6, w6)}")
    ms, pms = time_in_turns(
        lambda: segment_sum_from_flags(vals, flags, cap, impl="cuda"),
        lambda: segment_sum_from_flags(vals, flags, cap, impl="torch"))
    report("segment_sum_from_flags",
           "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
           "pointcloud_stitching_tpu/kernels/segment_reduce.py:161",
           err_k1, ms, pms)

    # K2: the batched ICP voxel pass (exact branch, normals in rgb)
    s = 6
    sub_xyz = raw.xyz.reshape(NCAM, H, W, 3)[:, ::s, ::s]
    sub_mask = raw.mask.reshape(NCAM, H, W)[:, ::s, ::s]
    nrm, nvalid = grid_normals(sub_xyz, sub_mask)
    sub = PointCloud(xyz=sub_xyz.reshape(NCAM, -1, 3),
                     mask=(sub_mask & nvalid).reshape(NCAM, -1),
                     rgb=nrm.reshape(NCAM, -1, 3))
    flags2, vals2 = V._sorted_segments(sub, 0.07)
    icap = 2048
    seg2 = (V._flags_to_seg(flags2, icap)
            + torch.arange(NCAM, dtype=torch.int32, device=dev)[:, None]
            * (icap + 1)).reshape(-1)
    vals2 = vals2.reshape(-1, vals2.shape[-1])
    cap2 = NCAM * (icap + 1)
    g2 = segment_sum_sorted(vals2, seg2, cap2, impl="cuda")
    w2 = segment_sum_sorted(vals2, seg2, cap2, impl="torch")
    check(torch.equal(g2[:, 3], w2[:, 3]), "K2 counts differ from plain")
    n2 = torch.clamp(w2[:, 3:4], min=1.0)
    torch.testing.assert_close(g2 / n2, w2 / n2, rtol=RTOL_F32,
                               atol=ATOL_F32)
    say(f"    K2 {tuple(vals2.shape)} cap {cap2}: counts equal, centroids "
        f"within rtol {RTOL_F32}; bitwise equal: {torch.equal(g2, w2)}")
    ms, pms = time_in_turns(
        lambda: segment_sum_sorted(vals2, seg2, cap2, impl="cuda"),
        lambda: segment_sum_sorted(vals2, seg2, cap2, impl="torch"))
    report("segment_sum_sorted",
           "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
           "pointcloud_stitching_tpu/kernels/segment_reduce.py:219",
           (g2 - w2).abs().max().item(), ms, pms)

    # K3: ring ICP NN, 8 pairs of 2048 x 2048, ~10% of refs masked, ties
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-2, 2, (NCAM, 2048, 3)).astype(
        np.float32)).to(dev)
    r_np = rng.uniform(-2, 2, (NCAM, 2048, 3)).astype(np.float32)
    r_np[:, 1500] = r_np[:, 700]           # an exact tie: 700 must win
    r = torch.from_numpy(r_np).to(dev)
    rmask = torch.from_numpy(rng.random((NCAM, 2048)) > 0.1).to(dev)
    rmask[:, 700] = True
    rmask[:, 1500] = True
    q[:, 0] = r[:, 700]
    refT = prepare_ref_batched(r, rmask)
    gi, gd = nn_batched_prepared(q, refT, impl="cuda")
    wi, wd = nn_batched_prepared(q, refT, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(gi, wi), "K3 idx differs from plain")
    check(torch.equal(gd, wd), "K3 d2 not bitwise equal to plain")
    check(bool((gi[:, 0] == 700).all()), "K3 tie did not go to the first")
    check(not bool(rmask.gather(1, gi.long()).logical_not().any()),
          "K3 matched a masked reference")
    say(f"    K3 {tuple(q.shape)} vs {tuple(r.shape)}: idx equal, d2 bitwise "
        f"equal, first index wins the tie")
    ms, pms = time_in_turns(
        lambda: nn_batched_prepared(q, refT, impl="cuda"),
        lambda: nn_batched_prepared(q, refT, impl="torch"))
    report("nn_batched_prepared",
           "pointcloud_stitching_tpu_torch/csrc/nn.cu",
           "pointcloud_stitching_tpu/kernels/nn_pallas.py:172",
           (gd - wd).abs().max().item(), ms, pms)
    del fused, vals, flags, vals6, flags6, g6, w6, got, want

    # --- phase 4: the slice, 'auto' against 'torch' ----------------------
    def run(impl: str, **overrides):
        cfg = flagship_cfg(StitchConfig, kernel_impl=impl, **overrides)
        pipe = StitchingPipeline(cfg, intr, ext_np, device=dev,
                                 update_mode="track")
        check(torch.backends.cuda.matmul.allow_tf32 is False
              and torch.backends.cudnn.allow_tf32 is False
              and torch.get_float32_matmul_precision() == "highest",
              "TF32 is on after building StitchingPipeline")
        metrics = []
        kb.reset_launches()
        for _ in range(FRAMES):
            out = pipe(depths)
            metrics.append((out.metrics.points_in, out.metrics.points_out))
        torch.cuda.synchronize()
        launches = dict(kb.LAUNCHES)
        m = [(int(a), int(b)) for a, b in metrics]
        cloud = out.cloud.xyz[out.cloud.mask].cpu().numpy()
        return m, out.extrinsics.cpu().numpy(), cloud, launches

    # The flagship scene fills the 1 cm grid (262144 slots) by construction,
    # so equal point counts there say little; the second run coarsens the
    # output leaf to 6 cm with the per-camera 1 cm pass on, as
    # __graft_entry__.dryrun_multichip's flagship phase does, which keeps the
    # grid unsaturated. 6 cm > 3 cm sends that global pass down the exact
    # branch (K1 on float channels), and the per-camera pass adds one K2
    # launch per frame on the packed branch.
    for tag, overrides in (("1 cm", {}),
                           ("6 cm + cam pass", dict(out_voxel_leaf=0.06,
                                                    cam_voxel_enabled=True))):
        ma, ea, ca, la = run("auto", **overrides)
        mt, et, ct, lt = run("torch", **overrides)
        check(ma == mt, f"{tag}: points_in/out differ {ma} vs {mt}")
        d_ext = float(np.abs(ea - et).max())
        check(d_ext <= ATOL_SLICE, f"{tag}: extrinsics differ {d_ext}")
        check(ca.shape == ct.shape, f"{tag}: cloud shapes differ")
        d_cloud = float(np.abs(np.sort(ca, 0) - np.sort(ct, 0)).max())
        check(d_cloud <= ATOL_SLICE, f"{tag}: clouds differ {d_cloud}")
        per_frame = {"nn_batched_prepared": 5, "segment_sum_from_flags": 1,
                     "segment_sum_sorted": 1 + int(bool(overrides))}
        for name, k in per_frame.items():
            check(la.get(name, 0) == k * FRAMES,
                  f"{tag}: {name} launched {la.get(name, 0)} times in "
                  f"{FRAMES} frames, want {k * FRAMES}")
        check(not lt, f"{tag}: 'torch' run launched kernels {lt}")
        pts_out = [b for _, b in ma]
        if not overrides:
            for name in per_frame:
                kernels[name]["launches"] = la[name]
        else:
            check(max(pts_out) < 262144,
                  f"{tag} run saturated the grid: {max(pts_out)}")
        say(f"[4/7 slice] {tag}: {FRAMES} frames track mode, points_in "
            f"{ma[-1][0]} points_out {pts_out[0]}..{pts_out[-1]} "
            f"(capacity 262144); auto vs torch: metrics equal, |d ext| "
            f"{d_ext:.3g}, |d sorted cloud| {d_cloud:.3g}; launches {la}")

    # --- phase 5: independent check against the numpy oracle ------------
    # a grid of 2^21 slots holds every occupied 6 cm voxel of the scene, so
    # the oracle (which has no capacity) sees the same set
    cfg = flagship_cfg(StitchConfig, out_voxel_leaf=0.06, icp_enabled=False,
                       out_capacity=2 ** 21)
    out = StitchingPipeline(cfg, intr, ext_np, device=dev)(depths)
    got = out.cloud.xyz[out.cloud.mask].cpu().numpy()
    check(got.shape[0] < cfg.out_capacity, "oracle run saturated the grid")
    pts = []
    for c in range(NCAM):
        xyz, mask = oracle.deproject_np(depths_np[c], 421.5, 421.1, W / 2.0,
                                        H / 2.0, z_min=cfg.z_min,
                                        z_max=cfg.z_max)
        pts.append(oracle.transform_np(ext_np[c], xyz[mask]))
    want, _ = oracle.voxel_downsample_np(np.concatenate(pts), 0.06)
    check(got.shape == want.shape,
          f"oracle: {got.shape[0]} voxels vs {want.shape[0]}")
    d_or = float(np.abs(got - want).max())
    check(d_or <= ATOL_ORACLE, f"oracle: centroids differ by {d_or}")
    say(f"[5/7 oracle] icp off, 6 cm leaf: {got.shape[0]} voxels == oracle, "
        f"max |centroid - oracle| {d_or:.3g} m")

    # --- phase 6: timings -------------------------------------------------
    def frame_ms(impl: str, frames: int = 20) -> float:
        cfg = flagship_cfg(StitchConfig, kernel_impl=impl)
        pipe = StitchingPipeline(cfg, intr, ext_np, device=dev,
                                 update_mode="track")
        for _ in range(3):
            pipe(depths)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(frames):
            pipe(depths)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / frames

    def syncs_per_frame(impl: str) -> int:
        cfg = flagship_cfg(StitchConfig, kernel_impl=impl)
        pipe = StitchingPipeline(cfg, intr, ext_np, device=dev,
                                 update_mode="track")
        pipe(depths)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pipe(depths)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in caught)

    t_plain1 = frame_ms("torch")
    t_auto1 = frame_ms("auto")
    t_auto2 = frame_ms("auto")
    t_plain2 = frame_ms("torch")
    t_auto, t_plain = (t_auto1 + t_auto2) / 2, (t_plain1 + t_plain2) / 2
    pix = NCAM * H * W
    torch.cuda.reset_peak_memory_stats()
    frame_ms("auto", frames=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    s_auto, s_plain = syncs_per_frame("auto"), syncs_per_frame("torch")
    say(f"[6/7 timing] {card}: ms/frame auto {t_auto:.3f} "
        f"({t_auto1:.3f}, {t_auto2:.3f}) torch {t_plain:.3f} "
        f"({t_plain1:.3f}, {t_plain2:.3f}); points/s auto "
        f"{pix / t_auto * 1e3:.4g} torch {pix / t_plain * 1e3:.4g}; "
        f"host syncs/frame auto {s_auto} torch {s_plain}; peak memory "
        f"{peak:.1f} MiB")

    registration_phase(dev, kb, report, kernels, card)

    say(json.dumps({"kernels": list(kernels.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def registration_phase(dev, kb, report, kernels, card) -> None:
    """Phase 7: the calibration path (K4, with K1 and K3) at 131k points."""
    import tempfile

    import torch
    import oracle
    from pointcloud_stitching_tpu_torch import Intrinsics, PointCloud
    from pointcloud_stitching_tpu_torch.io import load_cal, save_ply
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        block_ranges, nearest_neighbors_pallas_batched,
        nearest_neighbors_pruned, nn_batched_prepared,
        nn_batched_prepared_ranged, prepare_ref_batched)
    from pointcloud_stitching_tpu_torch.models import (
        register_from_correspondences, register_global, register_pair)
    from pointcloud_stitching_tpu_torch.ops import (deproject, icp,
                                                    icp_converge, se3_apply,
                                                    voxel_downsample)

    # src: one frame at the flagship intrinsics, voxel-sorted into 131072
    # slots; the leaf starts at 1 cm and coarsens until the slots are not
    # all used (a saturated pass keeps a crop of the scene)
    depth = torch.from_numpy(oracle.synth_depth_frame(H, W, 0)).to(dev)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    raw = deproject(depth, i0, depth_scale=0.001, z_min=0.1, z_max=10.0)
    leaf = 0.01
    while True:
        src = voxel_downsample(raw, leaf, capacity=REG_CAP)
        n_src = int(src.count())
        if n_src < REG_CAP:
            break
        leaf *= 1.1
    check(n_src >= 100_000, f"registration cloud has only {n_src} points")
    valid = src.xyz[src.mask].cpu().numpy()
    noise = torch.from_numpy(np.random.default_rng(2).normal(
        0.0, 0.001, (REG_CAP, 3)).astype(np.float32)).to(dev)

    def moved(T_np):
        """src under T_np plus 1 mm noise, in src's (voxel) order."""
        xyz = se3_apply(torch.from_numpy(T_np).to(dev), src.xyz) + noise
        return PointCloud(xyz=torch.where(src.mask[:, None], xyz, 0.0),
                          mask=src.mask)

    def point_err(T, T_ref) -> float:
        """Largest distance between src's points under T and under T_ref."""
        got = oracle.transform_np(T.cpu().numpy(), valid)
        return float(np.linalg.norm(got - oracle.transform_np(T_ref, valid),
                                    axis=-1).max())

    T_true = oracle.random_se3(seed=3, max_angle=0.05, max_trans=0.05)
    dst = moved(T_true)
    picks = np.linspace(0, n_src - 1, 4).astype(np.int64)
    say(f"[7/7 registration] src {n_src} points at a {leaf:.4f} m leaf "
        f"({REG_CAP} slots), dst = src moved by a 0.05 rad / 5 cm pose + "
        f"1 mm noise")

    # (a)-(c): K4 at the first ICP iteration's shapes, 131072 x 131072
    T0 = register_from_correspondences(src, dst, picks, picks)
    q, qm = se3_apply(T0, src.xyz)[None], src.mask[None]
    r, rm = dst.xyz[None], dst.mask[None]
    _, ub = nearest_neighbors_pallas_batched(q, r[:, ::16], rm[:, ::16],
                                             impl="cuda")
    jlo, jhi = block_ranges(q, qm, r, rm, ub, query_tile=1024,
                            ref_block=2048)
    refT = prepare_ref_batched(r, rm)

    def k4(lo, hi, impl):
        return nn_batched_prepared_ranged(q, refT, lo, hi, query_tile=1024,
                                          ref_block=2048, impl=impl)

    gi, gd = k4(jlo, jhi, "cuda")
    wi, wd = k4(jlo, jhi, "torch")
    torch.cuda.synchronize()
    check(torch.equal(gi, wi), "K4 idx differs from plain")
    check(torch.equal(gd, wd), "K4 d2 not bitwise equal to plain")
    nq, nm = jlo.shape[1], -(-REG_CAP // 2048)
    share = float((jhi - jlo + 1).sum()) / (nq * nm)
    bi, bd = nn_batched_prepared(q, refT, impl="cuda")
    pi, pd = nearest_neighbors_pruned(q, r, rm, qm, impl="cuda")
    check(torch.equal(pi[qm], bi[qm]) and torch.equal(pd[qm], bd[qm]),
          "pruned NN differs from brute force on valid queries")
    ni, nd = k4(jlo, jlo, "cuda")
    nwi, nwd = k4(jlo, jlo, "torch")
    check(torch.equal(ni, nwi) and torch.equal(nd, nwd),
          "K4 with narrowed ranges differs from plain")
    n_diff = int((ni != bi)[qm].sum())
    check(n_diff > 0, "narrowed ranges gave the brute-force answer")
    say(f"    (a) K4 {tuple(q.shape)} vs {tuple(r.shape)}, ranges of "
        f"block_ranges: idx equal, d2 bitwise equal; blocks swept "
        f"{share:.4f} of {nq} x {nm}")
    say(f"    (b) pruned NN (K3 coarse + K4) == brute-force K3 on "
        f"{int(qm.sum())} valid queries")
    say(f"    (c) K4 with ranges cut to one block: equal to plain, "
        f"{n_diff} valid queries differ from brute force")
    ms, pms = time_in_turns(lambda: k4(jlo, jhi, "cuda"),
                            lambda: k4(jlo, jhi, "torch"), reps=5)
    report("nn_batched_prepared_ranged",
           "pointcloud_stitching_tpu_torch/csrc/nn.cu",
           "pointcloud_stitching_tpu/kernels/nn_pallas.py:300",
           (gd - wd).abs().max().item(), ms, pms)
    del gi, gd, wi, wd, bi, bd, pi, pd, ni, nd, nwi, nwd

    # (d): the main path, register_pair + pruned icp_converge
    runs = {}
    for impl in ("auto", "torch"):
        torch.cuda.reset_peak_memory_stats()
        kb.reset_launches()
        res = register_pair(src, dst, picks, picks, prune=True,
                            kernel_impl=impl)
        torch.cuda.synchronize()
        runs[impl] = (res, dict(kb.LAUNCHES),
                      torch.cuda.max_memory_allocated() / 2 ** 20)
    (ra, la, peak_a), (rt, lt, peak_t) = runs["auto"], runs["torch"]
    it = int(ra.icp.iterations)
    check(it == int(rt.icp.iterations), "auto/torch iteration counts differ")
    d_T = float((ra.T - rt.T).abs().max())
    check(d_T <= ATOL_REG, f"register_pair T differs auto vs torch: {d_T}")
    want = {"nn_batched_prepared": it, "nn_batched_prepared_ranged": it}
    check(la == want, f"register_pair launches {la}, want {want}")
    check(not lt, f"'torch' register_pair launched kernels {lt}")
    kernels["nn_batched_prepared_ranged"]["launches"] = \
        la.get("nn_batched_prepared_ranged", 0)
    err_d = point_err(ra.T, T_true)
    check(err_d < MAX_REG_ERR, f"register_pair error {err_d} m")
    say(f"    (d) register_pair, 4 picks + icp_converge(prune=True): {it} "
        f"iterations, |T auto - T torch| {d_T:.3g}, max point error "
        f"{err_d * 1e3:.4f} mm, mean_error {float(ra.icp.mean_error):.4g}, "
        f"inliers {int(ra.icp.num_inliers)}; launches {la}")

    # (e): register_global against a ~2-rad misalignment
    T_glob = oracle.random_se3(seed=0, max_angle=2.0, max_trans=0.3)
    dst_g = moved(T_glob)
    kb.reset_launches()
    rg = register_global(src, dst_g, torch.Generator().manual_seed(0),
                         num_starts=64, prune=True)
    torch.cuda.synchronize()
    lg = dict(kb.LAUNCHES)
    itg = int(rg.icp.iterations)
    check(lg.get("segment_sum_from_flags", 0) >= 2
          and lg.get("nn_batched_prepared") == 15 + itg
          and lg.get("nn_batched_prepared_ranged") == itg,
          f"register_global launches {lg} ({itg} refine iterations)")
    err_g = point_err(rg.T, T_glob)
    check(err_g < MAX_REG_ERR, f"register_global error {err_g} m")
    angle = np.degrees(np.arccos((np.trace(T_glob[:3, :3]) - 1) / 2))
    say(f"    (e) register_global, 64 starts, {angle:.1f} deg misalignment: "
        f"max point error {err_g * 1e3:.4f} mm, {itg} refine iterations; "
        f"launches {lg}")

    # (f): the CLI, as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        sp, dp, out = (os.path.join(tmp, f) for f in ("s.ply", "d.ply",
                                                       "pair.cal"))
        save_ply(sp, valid)
        save_ply(dp, dst_g.xyz[dst_g.mask].cpu().numpy())
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "pointcloud_stitching_tpu_torch.tools.register_cli", sp, dp, out,
             "--global", "--prune"], cwd=REPO, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PCS_PLATFORM="cuda"))
        t_cli = time.perf_counter() - t
        check(proc.returncode == 0, f"register_cli failed:\n{proc.stderr}")
        err_f = point_err(torch.from_numpy(load_cal(out)), T_glob)
    check(err_f < MAX_REG_ERR, f"register_cli .cal error {err_f} m")
    cli = [ln for ln in proc.stdout.splitlines()
           if ln.startswith(("src", "ICP"))]
    say(f"    (f) register_cli --global --prune: {' | '.join(cli)}; .cal max "
        f"point error {err_f * 1e3:.4f} mm; {t_cli:.1f} s as a subprocess")

    # timings: ms per ICP iteration, host syncs, peak memory
    k = 5

    def iteration_ms(impl, prune, reps):
        fn = lambda: icp(src, dst, init_T=T0, iterations=k,  # noqa: E731
                         max_corr_dist=0.25, nn_impl=impl, prune=prune)
        fn()
        torch.cuda.synchronize()
        return cuda_ms(fn, reps) / k

    t_pruned = iteration_ms("auto", True, 4)
    t_brute = iteration_ms("auto", False, 2)
    t_plain = iteration_ms("torch", True, 1)
    t_pruned2 = iteration_ms("auto", True, 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rs = icp_converge(src, dst, init_T=T0, prune=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    syncs = sum(sites.values())
    say(f"    timing {card}: ms per ICP iteration at {REG_CAP} x {REG_CAP}: "
        f"pruned (K3 coarse + K4) {t_pruned:.3f} / {t_pruned2:.3f}, "
        f"unpruned K3 {t_brute:.3f}, plain pruned {t_plain:.3f}; K4 alone "
        f"{ms:.4f} ms vs plain {pms:.4f} ms; blocks swept {share:.4f}; host "
        f"syncs {syncs} in {int(rs.iterations)} icp_converge iterations "
        f"{dict(sites)}; "
        f"peak memory register_pair auto {peak_a:.1f} MiB, torch "
        f"{peak_t:.1f} MiB")


if __name__ == "__main__":
    sys.exit(main())
