#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``pointcloud_stitching_tpu_torch.StitchingPipeline`` at the flagship
configuration (8 cameras of 848x480 u16 depth, ring point-to-plane ICP with
5 iterations, a 262144-slot 1 cm output grid) and the registration path
(``register_pair`` / ``register_global`` / the register CLI) at 131k x 131k
points and the TSDF scene model (``models.tsdf``: integrate, extract,
save/load, raycast, track and the mesh CLI) at 4 x 848x480 into a 256^3
volume, the streaming runtime (``runtime/``: fake camera servers, the
pipelined client, the stitch CLI and the camera test) at 8 x 848x480, the
temporal voxel map (``models.voxel_map``) at 2^20 slots with change
detection, localization and the meshers, the registration extras and the
analysis ops (plane RANSAC, filters, clusters, hulls, ``segment_cli`` and
the stitch CLI's publisher, viewer and trace) and the sharded port
(``parallel/``) in worlds of 1 and 4 ranks and the port's own commands
(the loopback-cluster launcher, the ``pcs-torch-*`` targets, the JAX
package's positional order) and the random draws (``utils/prng.py``, JAX's
threefry2x32 key stream), and checks the seven hand-written CUDA kernels
on those paths:

  1. device and settings: the card's name and power limit; full float32
     matmuls (no TF32) once a pipeline exists;
  2. build the kernels from csrc/ (nvcc, sm_90a) and print ptxas' report;
  3. each kernel against its plain PyTorch version at the shapes the main
     path gives it, on the card, then timed in turns with CUDA events
     (device time, the queue held by a spinning kernel while the calls are
     enqueued; the time per call back to back beside it): K1 bit for bit on
     the packed branch of the global pass (and whether the exact branch is
     bitwise too), two launches equal, its one launch's grid printed, and
     at 10 channels on the coloured global pass (its own kernels entry); K2
     bit for bit at the ring-ICP shape and at the per-camera 1 cm pass, two launches equal,
     faster than index_add_, its launch configuration printed; K3 bit for
     bit at the ring shape (a tie across two reference slices goes to the
     lower index; S and the grid printed), there at every split count S
     of 1..8 (the sweep behind ``nn_splits``), and at the registration
     coarse pass;
  4. the slice: 10 frames in 'track' mode with kernel_impl='auto' and with
     'torch', at the saturated 1 cm leaf and at an unsaturated 6 cm leaf;
     outputs must agree and the kernels' launch counts must show that the
     'auto' run went through them (5 NN, 1 K1 and 1 K2 launch per frame at
     the flagship config); then the coloured step (uint8 colour from seed
     1, 10 channels through K1): 'auto' = 'torch' bit for bit, the same
     launches, and mapped colour with the depth intrinsics and identity
     depth->colour extrinsics equal to depth-aligned colour;
  5. an independent check of the no-ICP step against the numpy oracle in
     tests/oracle.py;
  6. steady-state ms/frame and points/s, host syncs per frame, peak memory;
  7. the registration (calibration) path at the scale users run: two
     voxel-sorted clouds of >= 100k points (one 848x480 frame in 131072
     slots, and a moved copy with 1 mm noise). K4 against its plain version
     with the ranges block_ranges gives and with ranges narrowed on
     purpose, two launches equal, its work items counted on the device and
     in Python, its grid printed, and timed at other chunk sizes and grid
     depths; the pruned NN against brute-force K3, register_pair with
     pruned icp_converge ('auto' against 'torch', with one K3 and one K4
     launch per iteration), register_global against a ~2-rad misalignment,
     the register CLI as a subprocess, and timings;
  8. the TSDF scene model at bench.py's design point (4 x 848x480 u16 depth
     of an analytic scene into a 256^3 volume at 1 cm, uint8 colour from
     seed 2): K5 against its plain version on camera 0's REFINE bricks and
     on windows made to hit the clamp, alignment and out-of-window cases;
     integrate 'auto' (the pruned path through K5) against 'dense' bit for
     bit, with and without colour, and K5's launches (one per gathered
     plane per camera); five keyframes, then extract_mesh + weld_mesh
     against the analytic surface, save_volume and the mesh CLI as a
     subprocess; raycast and track against the analytic scene; timings;
  9. the streaming runtime: 8 fake camera servers on loopback (848x480,
     snappy from the port's native codec, one static frame each) feeding
     ``MulticameraClient`` on the flagship config, anchored, from pinned
     staging buffers: 30 frames at sync_every=1 and 30 at sync_every=4,
     then again with depth-aligned colour; every streamed output equal to
     a direct ``StitchingPipeline`` call bit for bit, host syncs per frame
     at most the direct call's + 1, the kernels' launches per frame; fps,
     p50/p99 latency, points/s, the stage table, peak memory; then the
     stitch CLI (20 frames, --save-dir, --tsdf-leaf, --map-leaf 0.01
     --map-out scene.npz) and ``camera_test --deproject`` as subprocesses
     against the servers, and the mesh CLI on the CLI's map checkpoint and
     on one 848x480 depth frame (--bilateral) as subprocesses;
 10. the temporal voxel map: the flagship stitch of phase 9's rig frames
     into ``TemporalAccumulator(capacity=2**20, leaf=0.01)``, without and
     with colour, 10 updates at decay 1 and 10 at decay 0.5 (4 of the rig,
     then 6 of the rig moved 5 cm, so evictions happen inside the run):
     'auto' equal to 'torch' bit for bit after every update, one K1 launch
     per update, no host sync in an update, ms per update, peak memory; K1
     at the map's shape (2^20 + 262144 rows, 7 and 10 channels) against
     its plain version and timed (its own kernels entries); then
     ``detect_changes_map`` of the mapped and of the moved frame,
     ``localize`` of a moved cloud against the map and
     ``reconstruct_surface`` of the map;
 11. the registration extras on phase 7's clouds: ``estimate_normals``
     against the frame's disc planes, the register CLI with
     ``--fpfh-starts`` (also alone) and ``--gicp``, GICP per iteration,
     ``ndt`` (K2 held bit for bit against its plain version on the map
     build's own inputs, and the whole call against ``impl="torch"``),
     ``graph_cli --ply-dir`` over the stream rig's 8 poses, each camera
     with its own 1 mm noise (K2 held likewise on the batched voxel pass),
     ``pick_cli --pairs`` into ``register_cli --picks``, ISS and VFH; K2's
     library call (``index_add_``) timed beside it at both shapes;
 12. the analysis ops on phase 7's 113k-point cloud and the flagship's
     262,144-slot output of phase 9's rig: (a) ``segment_plane`` (1024
     hypotheses, 1 cm) on both, CUDA against CPU on key 0, ms and
     host syncs per call, and the plane of a window around the largest
     disc against the disc; (b) ``stitch_cli --drop-plane 0.01`` (30
     frames, in this process) against a run without the flag: every saved
     cloud equal to a direct call, fps, p50/p99, K1/K3 launches; (g) one
     ``stitch_cli --publish-port --view --trace-dir`` run with a
     subscriber that must get every frame; (c) passthrough,
     ``frustum_cull``, ROR and SOR timed at full size, held against a
     numpy recount of sampled points there and against the CPU on a crop;
     (d) ``euclidean_clusters`` CUDA against CPU, cluster boxes, and the
     exact clusterers on a 2 cm skeleton against scipy's components of the
     same graph (and the CPU on a crop); (e) support points, convex,
     concave and crop hulls; (f) ``segment_cli --drop-plane --obb --hull``
     on the card against the CPU, file for file;
 13. ``parallel/`` (the sharded stitch, the ring NN, the Z-slab TSDF) in
     spawned worlds of ranks: one over NCCL on the card, and four over
     gloo sharing it (NCCL refuses two ranks on one device; the
     collectives stage through host memory). (a)/(b) both sharded
     stitches at the flagship configurations, 10 frames in track mode:
     each rank's K1/K2/K3 launches counted, 'auto' equal to 'torch' bit for
     bit, the cloud equal to the unsharded step's fed the same extrinsics,
     the extrinsics within 1e-4 of the unsharded step's, every rank's
     output identical, the 4-rank world within 1e-4 of the 1-rank one;
     (c) the ring NN on phase 7's clouds, d2 bit for bit unsharded K3's;
     (d) the Z-slab integrate ('auto', K5 per slab) bit for bit the
     unsharded 'dense' at a 2^-7 m leaf, and the sharded raycast; (e) ms
     per sharded frame, the bytes crossing ranks and the collectives'
     share of a frame, ms per sharded integrate and raycast;
 14. the port's commands: (a) ``scripts/local_cluster_torch.py`` with 8
     cameras of 848x480 and 30 frames (8 fake-server processes and the
     stitch CLI as a process on loopback), once with ``--save-dir`` and
     ``--trace-dir`` (30 frames stitched, a cloud saved, K1/K2/K3 launched
     1/1/5 times a frame by the trace's kernel events) and once untraced
     with snappy (fps, p50/p99); (b) every entry point whose parameters
     once sat at other positions than the JAX package's, called on the card
     in the JAX order and held bit for bit against the call with the JAX
     package's keywords (K1-K4 launched); (c) every ``pcs-torch-*`` target
     of pyproject.toml imported in a process where jax cannot be imported;
 15. the random draws (``utils/prng.py``): threefry2x32 and scan16 bit for
     bit their plain versions (1, 3,072 and 262,144 counters; the scan of
     the flagship's 262,144-slot mask), the card's bits, split, uniform,
     randint and choice equal to JAX's values written in as literals
     (``JAX_DRAWS``), its uniform on a range, normal and categorical equal
     to the CPU's on the same key, a CPU key with a cloud on the card
     drawing on the card, both kernels timed in turns with their plain
     versions (their launches: phase 12 (b)'s ``--drop-plane`` run, one
     each a frame), and ms and device operations per draw of ``choice`` over
     262,144 slots, ``normal(39, 4)`` and ``categorical``.

The kernels' line carries, for each kernel, its time beside its bound: the
larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its operations over the H100 SXM's
float32 instruction rate (132 SMs x 128 lanes x 1.98 GHz: the NN kernels'
contract rounds every multiply and add on its own, so each operation is
one issued instruction and no fused multiply-add counts twice), and the
time of one PyTorch call that computes the same function where there is
one. For K5 there is none: its library time is that of the PyTorch calls
that compute its whole function (window arithmetic, window test, gather,
zero fill), and the time of ``torch.take`` alone on indices worked out
beforehand is printed beside it.

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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA's data sheet)
# H100 SXM float32 instructions per second outside the tensor cores:
# 132 SMs x 128 lanes x 1.98 GHz boost (67 TFLOP/s counts an FMA as two)
F32_INSTR_PER_S = 132 * 128 * 1.98e9


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


PREFILL_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at 1.98 GHz


def cuda_ms(fn, reps: int, prefill: bool = True) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls, by CUDA events.

    With ``prefill`` a spinning kernel holds the card while the host
    enqueues the calls, so the events time the device work back to back
    and not the wrapper's Python; without it the time per call is the
    larger of the two (what a host-bound caller sees)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(PREFILL_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(kernel_fn, plain_fn, reps: int = 20):
    """(kernel ms, plain ms, kernel ms per call): warm up, then plain,
    kernel, kernel, plain with the queue prefilled (device time), then the
    kernel's calls back to back without it (as PR 1-3 timed them)."""
    import torch
    for _ in range(3):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    call = cuda_ms(kernel_fn, reps, prefill=False)
    return (k1 + k2) / 2, (p1 + p2) / 2, call


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, ops: float, rate: float = F32_INSTR_PER_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and issue ``ops`` instructions at ``rate`` a second
    (float32 by default)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_inputs(dev):
    """The flagship scene and phase 3's inputs at the shapes the main path
    gives each kernel, made by the ``pointcloud_stitching_tpu_torch`` that
    comes first on ``sys.path`` (scripts/profile_tree.py times another
    tree's kernels on them)."""
    import types

    import torch
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        prepare_ref_batched)
    from pointcloud_stitching_tpu_torch.ops import (deproject, fuse_batched,
                                                    grid_normals, se3_apply)
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    from pointcloud_stitching_tpu_torch.utils.types import PointCloud

    ext_np, depths_np = flagship_scene()
    depths = torch.from_numpy(depths_np).to(dev)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    raw = deproject(depths, intr, depth_scale=0.001, z_min=0.1, z_max=10.0)
    fused = fuse_batched(raw.replace(xyz=se3_apply(
        torch.from_numpy(ext_np).to(dev), raw.xyz)))
    # K1: the global pass, packed branch at 1 cm and exact branch at 6 cm
    ijk = V.voxel_indices(fused.xyz, fused.mask, 0.01)
    flags, vals, _ = V._sorted_segments_packed(fused, 0.01, ijk)
    flags6, vals6 = V._sorted_segments(fused, 0.06)
    # K1 at 10 channels: the coloured global pass (bench.py's coloured
    # cell: uint8 colours from seed 1), packed branch at 1 cm
    colors = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (NCAM, H, W, 3), dtype=np.uint8)).to(dev)
    fused_c = fused.replace(rgb=torch.where(
        fused.mask[:, None], colors.reshape(-1, 3).to(torch.float32), 0.0))
    flags_c, vals_c, _ = V._sorted_segments_packed(fused_c, 0.01, ijk)
    del fused_c

    # K2: the batched ICP voxel pass (exact branch, normals in rgb), and
    # the per-camera 1 cm pass of phase 4's second run (packed branch), in
    # _reduce_batched's flat layout: camera c owns ids
    # [c * (cap + 1), c * (cap + 1) + cap], the last its discard
    def flat_segments(flags_b, vals_b, cap_cam):
        seg_b = (V._flags_to_seg(flags_b, cap_cam)
                 + torch.arange(NCAM, dtype=torch.int32, device=dev)[:, None]
                 * (cap_cam + 1)).reshape(-1)
        return (vals_b.reshape(-1, vals_b.shape[-1]), seg_b,
                NCAM * (cap_cam + 1))

    s = 6
    sub_xyz = raw.xyz.reshape(NCAM, H, W, 3)[:, ::s, ::s]
    sub_mask = raw.mask.reshape(NCAM, H, W)[:, ::s, ::s]
    nrm, nvalid = grid_normals(sub_xyz, sub_mask)
    sub = PointCloud(xyz=sub_xyz.reshape(NCAM, -1, 3),
                     mask=(sub_mask & nvalid).reshape(NCAM, -1),
                     rgb=nrm.reshape(NCAM, -1, 3))
    k2 = [("ring ICP", *flat_segments(*V._sorted_segments(sub, 0.07), 2048))]
    ijkc = V.voxel_indices(raw.xyz, raw.mask, 0.01)
    flagsc, valsc, _ = V._sorted_segments_packed(raw, 0.01, ijkc)
    k2.append(("1 cm camera pass", *flat_segments(flagsc, valsc, 131072)))

    # K3: ring ICP NN, 8 pairs of 2048 x 2048, ~10% of refs masked, and an
    # exact tie (refs 700 and 1500; query 0 sits on them: 700 must win)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-2, 2, (NCAM, 2048, 3)).astype(
        np.float32)).to(dev)
    r_np = rng.uniform(-2, 2, (NCAM, 2048, 3)).astype(np.float32)
    r_np[:, 1500] = r_np[:, 700]
    r = torch.from_numpy(r_np).to(dev)
    rmask = torch.from_numpy(rng.random((NCAM, 2048)) > 0.1).to(dev)
    rmask[:, 700] = True
    rmask[:, 1500] = True
    q[:, 0] = r[:, 700]
    return types.SimpleNamespace(
        ext_np=ext_np, depths_np=depths_np, depths=depths, intr=intr,
        colors=colors, k1=(vals, flags), k1_exact=(vals6, flags6),
        k1_rgb=(vals_c, flags_c), k2=k2,
        k3=(q, r, rmask, prepare_ref_batched(r, rmask)), rng=rng)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    from pointcloud_stitching_tpu_torch import StitchConfig, StitchingPipeline
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        NN_QUERY_TILE, nn_batched_prepared, nn_splits, prepare_ref_batched)
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        K2_TILE_ROWS, k1_grid, segment_sum_from_flags, segment_sum_sorted)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    say(f"[1/15 device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    t_start = t0 = time.perf_counter()
    info = kb.build()
    kb.library()
    say(f"[2/15 build] {info.path.name}: nvcc {info.seconds:.2f} s "
        f"({'cached' if info.cached else 'built'}), load "
        f"{time.perf_counter() - t0:.2f} s; ptxas:")
    for line in info.log.splitlines():
        if "ptxas info" in line or "bytes stack frame" in line:
            say("    " + line.strip())

    # --- phase 3: kernels vs plain versions at main-path shapes ---------
    ki = kernel_inputs(dev)
    ext_np, depths_np, depths, intr = ki.ext_np, ki.depths_np, ki.depths, \
        ki.intr
    colors = ki.colors
    kernels = {}

    def report(name, source, replaces, err, times, moved, ops,
               library_ms=None, rate=F32_INSTR_PER_S):
        ms, plain_ms, call_ms = times
        bound_ms, bound_by = bound(moved, ops, rate)
        kernels[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0,
                             max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        say(f"    {name}: kernel {ms:.4f} ms (per call back to back "
            f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
            f"{ops / 1e6:.2f} M ops), library call {lib}, max |kernel - "
            f"plain| {float(err):.3g}")

    # K1, packed branch: integer channels, must match bit for bit
    vals, flags = ki.k1
    cap = 262144
    lib = kb.library()
    got = segment_sum_from_flags(vals, flags, cap, impl="cuda")
    got_again = segment_sum_from_flags(vals, flags, cap, impl="cuda")
    want = segment_sum_from_flags(vals, flags, cap, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 packed sums differ from plain")
    check(torch.equal(got, got_again), "K1 packed: two launches differ")
    err_k1 = (got - want).abs().max().item()
    k1_blocks = k1_grid(vals.shape[0], vals.shape[1], cap)
    check(lib.pcs_segsum_flags_grid(vals.shape[0], vals.shape[1], cap)
          == sum(k1_blocks), "K1's grid differs between "
          "csrc/segment_reduce.cu and segment_reduce.py")
    check(lib.pcs_segsum_flags_tile_rows() == K2_TILE_ROWS,
          "K1's tile differs between csrc/segment_reduce.cu and "
          "segment_reduce.py")

    def k1_launch(ch_):
        return (f"{lib.pcs_segsum_flags_threads(ch_)} threads, "
                f"{K2_TILE_ROWS} rows per tile, "
                f"{lib.pcs_segsum_flags_smem(ch_)} B dynamic smem")

    say(f"[3/15 kernels] K1 packed {tuple(vals.shape)} cap {cap}: bitwise "
        f"equal ({int((want[:, 6] > 0).sum())} segments), two launches "
        f"bitwise equal; 1 launch of {k1_blocks[0]} tiles + {k1_blocks[1]} "
        f"zero-only blocks x {k1_launch(vals.shape[1])}, no memset")
    # K1, exact branch at the 6 cm leaf: float channels
    vals6, flags6 = ki.k1_exact
    g6 = segment_sum_from_flags(vals6, flags6, cap, impl="cuda")
    g6_again = segment_sum_from_flags(vals6, flags6, cap, impl="cuda")
    w6 = segment_sum_from_flags(vals6, flags6, cap, impl="torch")
    check(torch.equal(g6, g6_again), "K1 exact: two launches differ")
    n6 = torch.clamp(w6[:, 3:4], min=1.0)
    torch.testing.assert_close(g6[:, :3] / n6, w6[:, :3] / n6,
                               rtol=RTOL_F32, atol=ATOL_F32)
    err_k1 = max(err_k1, (g6 - w6).abs().max().item())
    say(f"    K1 exact {tuple(vals6.shape)}: centroids within rtol "
        f"{RTOL_F32}; bitwise equal: {torch.equal(g6, w6)}; two launches "
        f"bitwise equal; {int((w6[:, 3] > 0).sum())} segments, grid "
        f"{k1_grid(vals6.shape[0], vals6.shape[1], cap)} x "
        f"{k1_launch(vals6.shape[1])}")
    times = time_in_turns(
        lambda: segment_sum_from_flags(vals, flags, cap, impl="cuda"),
        lambda: segment_sum_from_flags(vals, flags, cap, impl="torch"))
    # What this run's data needs: every flag, the rows whose id is below
    # the capacity (ids never decrease, so they are the rows before the
    # flag that starts id `cap`; the kernel stops reading where a tile's
    # first id is past it), and the output. Beside it, the bound with every
    # row read.
    seg_ids = torch.cumsum(flags.to(torch.int32), 0)       # id + 1
    rows_kept = int((seg_ids <= cap).sum())
    ch1 = vals.shape[1]
    needed = nbytes(flags, got) + rows_kept * ch1 * vals.element_size()
    all_ms, _ = bound(nbytes(vals, flags, got), vals.numel())
    say(f"    K1 packed: {rows_kept} of {vals.shape[0]} rows have an id "
        f"below the capacity; bound with every row read {all_ms:.4f} ms")
    # no one PyTorch call: the segment ids need a cumsum of the flags first
    report("segment_sum_from_flags",
           "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
           "pointcloud_stitching_tpu/kernels/segment_reduce.py:161",
           err_k1, times, needed, rows_kept * ch1)
    # the same rows into 2^21 slots, which hold every 6 cm voxel of the
    # scene (phase 5's grid): no id is past the capacity, every row is read
    cap_all = 2 ** 21
    ga = segment_sum_from_flags(vals6, flags6, cap_all, impl="cuda")
    wa = segment_sum_from_flags(vals6, flags6, cap_all, impl="torch")
    check(int(flags6.sum()) < cap_all, "2^21 slots do not hold the scene")
    check(torch.equal(ga, wa), "K1 exact into 2^21 slots differs from plain")
    t6 = time_in_turns(
        lambda: segment_sum_from_flags(vals6, flags6, cap_all, impl="cuda"),
        lambda: segment_sum_from_flags(vals6, flags6, cap_all, impl="torch"))
    b6, _ = bound(nbytes(vals6, flags6, ga), vals6.numel())
    say(f"    K1 exact into {cap_all} slots ({int(flags6.sum())} segments, "
        f"every row kept, grid {k1_grid(*vals6.shape, cap_all)}): bitwise "
        f"equal; kernel {t6[0]:.4f} ms (per call back to back {t6[2]:.4f} "
        f"ms), plain {t6[1]:.4f} ms, bound {b6:.4f} ms")
    del vals, flags, vals6, flags6, g6, g6_again, w6, got, got_again, want
    del seg_ids, ga, wa

    # K1 at 10 channels: the coloured global pass (packed branch: integer
    # channels, bit for bit)
    vals_c, flags_c = ki.k1_rgb
    gc = segment_sum_from_flags(vals_c, flags_c, cap, impl="cuda")
    gc_again = segment_sum_from_flags(vals_c, flags_c, cap, impl="cuda")
    wc = segment_sum_from_flags(vals_c, flags_c, cap, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(gc, wc), "K1 at 10 channels differs from plain")
    check(torch.equal(gc, gc_again), "K1 at 10 channels: two launches differ")
    kc = k1_grid(vals_c.shape[0], vals_c.shape[1], cap)
    check(lib.pcs_segsum_flags_grid(vals_c.shape[0], vals_c.shape[1], cap)
          == sum(kc), "K1's 10-channel grid differs between "
          "csrc/segment_reduce.cu and segment_reduce.py")
    tc = time_in_turns(
        lambda: segment_sum_from_flags(vals_c, flags_c, cap, impl="cuda"),
        lambda: segment_sum_from_flags(vals_c, flags_c, cap, impl="torch"))
    rows_c = int((torch.cumsum(flags_c.to(torch.int32), 0) <= cap).sum())
    ch_c = vals_c.shape[1]
    all_c, _ = bound(nbytes(vals_c, flags_c, gc), vals_c.numel())
    say(f"    K1 coloured {tuple(vals_c.shape)} cap {cap}: bitwise equal "
        f"({int((wc[:, 6] > 0).sum())} segments, rgb sums "
        f"{float(wc[:, 7:10].sum()):.6g}), two launches bitwise equal; 1 "
        f"launch of {kc[0]} tiles + {kc[1]} zero-only blocks x "
        f"{k1_launch(ch_c)}; {rows_c} rows have an id below the capacity; "
        f"bound with every row read {all_c:.4f} ms")
    report("segment_sum_from_flags (10 channels)",
           "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
           "pointcloud_stitching_tpu/kernels/segment_reduce.py:161",
           (gc - wc).abs().max().item(), tc,
           nbytes(flags_c, gc) + rows_c * ch_c * vals_c.element_size(),
           rows_c * ch_c)
    del vals_c, flags_c, gc, gc_again, wc

    # K2 at the ring-ICP shape and at the per-camera 1 cm pass
    check(lib.pcs_nn_query_tile() == NN_QUERY_TILE,
          "K3's query tile differs between csrc/nn.cu and nn_pallas.py")
    check(lib.pcs_segsum_sorted_tile_rows() == K2_TILE_ROWS,
          "K2's tile differs between csrc/segment_reduce.cu and "
          "segment_reduce.py")
    k2_cases = []
    for tag, v_, s_, c_ in ki.k2:
        g = segment_sum_sorted(v_, s_, c_, impl="cuda")
        g_again = segment_sum_sorted(v_, s_, c_, impl="cuda")
        w = segment_sum_sorted(v_, s_, c_, impl="torch")
        torch.cuda.synchronize()
        check(torch.equal(g, w), f"K2 {tag}: sums differ from plain")
        check(torch.equal(g, g_again), f"K2 {tag}: two launches differ")
        n_, ch_ = v_.shape
        tiles = max(1, -(-n_ // K2_TILE_ROWS))
        times = time_in_turns(
            lambda: segment_sum_sorted(v_, s_, c_, impl="cuda"),
            lambda: segment_sum_sorted(v_, s_, c_, impl="torch"))
        ms, pms, call_ms = times
        # the library call: index_add_ into capacity + 1 rows (the discard
        # id is the capacity), float32 like the kernel's output
        lib_out = torch.zeros((c_ + 1, ch_), dtype=torch.float32, device=dev)
        lib_ms = cuda_ms(lambda: lib_out.zero_().index_add_(0, s_, v_), 20)
        k2_cases.append((v_, s_, g, (g - w).abs().max().item(), times,
                         lib_ms))
        b_ms, _ = bound(nbytes(v_, s_, g), v_.numel())
        say(f"    K2 {tag} {tuple(v_.shape)} into {c_} slots: bitwise equal to "
            f"plain, two launches bitwise equal; 1 launch of {tiles} blocks x "
            f"{lib.pcs_segsum_sorted_threads()} threads, {K2_TILE_ROWS} rows "
            f"per block, {lib.pcs_segsum_sorted_smem(ch_)} B dynamic smem; "
            f"kernel {ms:.4f} ms (per call back to back {call_ms:.4f} ms), "
            f"plain {pms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms")
    v_, s_, g, err_k2, times, lib_ms = k2_cases[0]
    check(times[0] < lib_ms, f"K2 at the ring-ICP shape ({times[0]:.4f} ms)"
                             f" is not faster than index_add_ ({lib_ms:.4f}"
                             f" ms)")
    report("segment_sum_sorted",
           "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
           "pointcloud_stitching_tpu/kernels/segment_reduce.py:219",
           err_k2, times, nbytes(v_, s_, g), v_.numel(), lib_ms)
    del k2_cases, ki.k2, g, g_again, w

    # K3: ring ICP NN, 8 pairs of 2048 x 2048
    q, r, rmask, refT = ki.k3
    gi, gd = nn_batched_prepared(q, refT, impl="cuda")
    wi, wd = nn_batched_prepared(q, refT, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(gi, wi), "K3 idx differs from plain")
    check(torch.equal(gd, wd), "K3 d2 not bitwise equal to plain")
    check(bool((gi[:, 0] == 700).all()), "K3 tie did not go to the first")
    check(not bool(rmask.gather(1, gi.long()).logical_not().any()),
          "K3 matched a masked reference")

    def nn_grid(b_, n_, m_):
        sp = nn_splits(b_, n_, m_)
        grid = (sp, -(-n_ // NN_QUERY_TILE), b_)
        return sp, grid, grid[0] * grid[1] * grid[2]

    def slice_of(ref, sp_, m_=2048):
        """The slice [m k / S, m (k + 1) / S) that holds reference ``ref``."""
        return sum(m_ * k // sp_ <= ref for k in range(1, sp_))

    sp, grid, blocks = nn_grid(*q.shape[:2], refT.shape[-1])
    check(slice_of(700, sp) < slice_of(1500, sp),
          "the tied references lie in one slice")
    check(blocks > 64, f"K3 launches only {blocks} blocks at the ring shape")
    say(f"    K3 {tuple(q.shape)} vs {tuple(r.shape)}: idx equal, d2 bitwise "
        f"equal, first index wins the tie (refs 700 and 1500 lie in slices "
        f"{slice_of(700, sp)} and {slice_of(1500, sp)}); S = {sp} splits, grid "
        f"{grid} = {blocks} blocks of 128 threads in clusters of {sp}")
    times = time_in_turns(
        lambda: nn_batched_prepared(q, refT, impl="cuda"),
        lambda: nn_batched_prepared(q, refT, impl="torch"))
    # 9 operations per pair (3 subtractions, 3 multiplies, 2 adds, 1
    # compare); no one PyTorch call returns the first-index argmin NN
    report("nn_batched_prepared",
           "pointcloud_stitching_tpu_torch/csrc/nn.cu",
           "pointcloud_stitching_tpu/kernels/nn_pallas.py:172",
           (gd - wd).abs().max().item(), times, nbytes(q, refT, gi, gd),
           9 * q.shape[0] * q.shape[1] * refT.shape[-1])
    # the split count behind nn_splits' choice: the kernel at every S the
    # cluster allows, launched directly (launches not counted)
    b3, n3, m3 = q.shape[0], q.shape[1], refT.shape[-1]
    sweep = []
    for s_k in range(1, 9):
        def launch(s_k=s_k):
            kb.check(lib.pcs_nn_batched(
                q.data_ptr(), refT.data_ptr(), b3, n3, m3, s_k,
                gi.data_ptr(), gd.data_ptr(), kb.stream_handle(q)),
                "K3 sweep")
        launch()
        torch.cuda.synchronize()
        check(torch.equal(gi, wi) and torch.equal(gd, wd),
              f"K3 at S = {s_k} differs from plain")
        launch()
        sweep.append(f"{s_k}: {cuda_ms(launch, 20):.4f}")
    say(f"    K3 by split count S (ms, device, {b3 * -(-n3 // NN_QUERY_TILE)}"
        f" query tiles; nn_splits picks {sp}), each equal to plain: "
        f"{', '.join(sweep)}")
    # K3 at the registration coarse pass: 131072 queries x 8192 references
    rng = ki.rng
    qc = torch.from_numpy(rng.uniform(-2, 2, (1, REG_CAP, 3)).astype(
        np.float32)).to(dev)
    rc = torch.from_numpy(rng.uniform(-2, 2, (1, 8192, 3)).astype(
        np.float32)).to(dev)
    refTc = prepare_ref_batched(rc, torch.from_numpy(
        rng.random((1, 8192)) > 0.1).to(dev))
    ci, cd = nn_batched_prepared(qc, refTc, impl="cuda")
    wci, wcd = nn_batched_prepared(qc, refTc, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(ci, wci) and torch.equal(cd, wcd),
          "K3 at the coarse shape differs from plain")
    c_ms, c_pms, c_call = time_in_turns(
        lambda: nn_batched_prepared(qc, refTc, impl="cuda"),
        lambda: nn_batched_prepared(qc, refTc, impl="torch"), reps=5)
    spc, gridc, blocksc = nn_grid(1, REG_CAP, 8192)
    c_bound, _ = bound(nbytes(qc, refTc, ci, cd), 9 * REG_CAP * 8192)
    say(f"    K3 coarse {tuple(qc.shape)} vs {tuple(rc.shape)}: idx equal, d2 "
        f"bitwise equal; S = {spc}, grid {gridc} = {blocksc} blocks; kernel "
        f"{c_ms:.4f} ms (per call back to back {c_call:.4f} ms), plain "
        f"{c_pms:.4f} ms, bound {c_bound:.4f} ms")
    del qc, rc, refTc, ci, cd, wci, wcd, ki

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
        say(f"[4/15 slice] {tag}: {FRAMES} frames track mode, points_in "
            f"{ma[-1][0]} points_out {pts_out[0]}..{pts_out[-1]} "
            f"(capacity 262144); auto vs torch: metrics equal, |d ext| "
            f"{d_ext:.3g}, |d sorted cloud| {d_cloud:.3g}; launches {la}")

    # the coloured step (bench.py's coloured cell): 'auto' against 'torch'
    # bit for bit, 10 channels through K1 on the global pass
    def run_colour(impl: str):
        cfg = flagship_cfg(StitchConfig, kernel_impl=impl, with_color=True)
        pipe = StitchingPipeline(cfg, intr, ext_np, device=dev,
                                 update_mode="track")
        kb.reset_launches()
        for _ in range(FRAMES):
            out = pipe(depths, colors)
        torch.cuda.synchronize()
        return out, dict(kb.LAUNCHES)

    ca, la = run_colour("auto")
    ct, lt = run_colour("torch")
    for name in ("xyz", "mask", "rgb"):
        check(torch.equal(getattr(ca.cloud, name), getattr(ct.cloud, name)),
              f"coloured step: cloud {name} differs, 'auto' vs 'torch'")
    check(torch.equal(ca.extrinsics, ct.extrinsics),
          "coloured step: extrinsics differ, 'auto' vs 'torch'")
    check(not lt, f"coloured 'torch' run launched kernels {lt}")
    per_frame = {"nn_batched_prepared": 5, "segment_sum_from_flags": 1,
                 "segment_sum_sorted": 1}
    for name, k in per_frame.items():
        check(la.get(name, 0) == k * FRAMES,
              f"coloured: {name} launched {la.get(name, 0)} times in "
              f"{FRAMES} frames, want {k * FRAMES}")
    kernels["segment_sum_from_flags (10 channels)"]["launches"] = \
        la["segment_sum_from_flags"]
    n_c = int(ca.metrics.points_out)
    rgb_c = ca.cloud.rgb[ca.cloud.mask]
    check(n_c > 0 and bool((rgb_c > 0).any()), "coloured step: no colour")
    del ct
    # mapped colour with the depth intrinsics and identity depth->colour
    # extrinsics must equal depth-aligned colour
    acfg = flagship_cfg(StitchConfig, with_color=True)
    mcfg = flagship_cfg(StitchConfig, with_color=True, color_height=H,
                        color_width=W)
    aligned = StitchingPipeline(acfg, intr, ext_np, device=dev)(depths,
                                                                colors)
    mapped = StitchingPipeline(mcfg, intr, ext_np, device=dev,
                               color_intr=intr)(depths, colors)
    for name in ("xyz", "mask", "rgb"):
        check(torch.equal(getattr(aligned.cloud, name),
                          getattr(mapped.cloud, name)),
              f"mapped colour differs from aligned colour in {name}")
    say(f"[4/15 slice] coloured: {FRAMES} frames track mode, points_out "
        f"{n_c}, mean rgb {[round(float(v), 3) for v in rgb_c.mean(0)]}; "
        f"auto vs torch bitwise equal (cloud, rgb, extrinsics); launches "
        f"{la}; mapped colour (identity depth->colour, depth intrinsics) "
        f"== aligned colour bit for bit")
    del ca, aligned, mapped, rgb_c, colors

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
    say(f"[5/15 oracle] icp off, 6 cm leaf: {got.shape[0]} voxels == oracle, "
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
        return count_syncs(lambda: pipe(depths))

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
    say(f"[6/15 timing] {card}: ms/frame auto {t_auto:.3f} "
        f"({t_auto1:.3f}, {t_auto2:.3f}) torch {t_plain:.3f} "
        f"({t_plain1:.3f}, {t_plain2:.3f}); points/s auto "
        f"{pix / t_auto * 1e3:.4g} torch {pix / t_plain * 1e3:.4g}; "
        f"host syncs/frame auto {s_auto} torch {s_plain}; peak memory "
        f"{peak:.1f} MiB")

    registration_phase(dev, kb, report, kernels, card)
    tsdf_phase(dev, kb, report, kernels, card)
    stream_phase(dev, kb, card)
    map_phase(dev, kb, report, kernels, card)
    extras_phase(dev, kb, card)
    drop_launches, flag = analysis_phase(dev, kb, card)
    parallel_phase(dev, card, t_auto)
    commands_phase(dev, kb, card)
    prng_phase(dev, kb, report, kernels, card, drop_launches, flag)
    say(f"chip_smoke took {time.perf_counter() - t_start:.1f} s after the "
        "device check")

    say(json.dumps({"kernels": list(kernels.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


K4_QUERY_TILE, K4_REF_BLOCK = 1024, 2048   # nearest_neighbors_pruned's


def registration_scene(dev):
    """The calibration path's clouds, made by the
    ``pointcloud_stitching_tpu_torch`` that comes first on ``sys.path``:
    src, one frame at the flagship intrinsics voxel-sorted into REG_CAP
    slots (the leaf starts at 1 cm and coarsens until the slots are not all
    used: a saturated pass keeps a crop of the scene), and dst, src moved
    by a 0.05 rad / 5 cm pose plus 1 mm noise."""
    import types

    import torch
    import oracle
    from pointcloud_stitching_tpu_torch import Intrinsics, PointCloud
    from pointcloud_stitching_tpu_torch.ops import (deproject, se3_apply,
                                                    voxel_downsample)

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
    noise = torch.from_numpy(np.random.default_rng(2).normal(
        0.0, 0.001, (REG_CAP, 3)).astype(np.float32)).to(dev)

    def moved(T_np):
        """src under T_np plus 1 mm noise, in src's (voxel) order."""
        xyz = se3_apply(torch.from_numpy(T_np).to(dev), src.xyz) + noise
        return PointCloud(xyz=torch.where(src.mask[:, None], xyz, 0.0),
                          mask=src.mask)

    T_true = oracle.random_se3(seed=3, max_angle=0.05, max_trans=0.05)
    return types.SimpleNamespace(
        src=src, n_src=n_src, leaf=leaf, moved=moved, T_true=T_true,
        dst=moved(T_true),
        picks=np.linspace(0, n_src - 1, 4).astype(np.int64))


def k4_inputs(dev, scene=None):
    """K4's inputs at the first ICP iteration of ``register_pair`` on
    ``registration_scene``: REG_CAP queries against REG_CAP references,
    with the ranges ``block_ranges`` gives from the K3 coarse pass."""
    import types

    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        block_ranges, nearest_neighbors_pallas_batched, prepare_ref_batched)
    from pointcloud_stitching_tpu_torch.models import (
        register_from_correspondences)
    from pointcloud_stitching_tpu_torch.ops import se3_apply

    sc = scene or registration_scene(dev)
    T0 = register_from_correspondences(sc.src, sc.dst, sc.picks, sc.picks)
    q, qm = se3_apply(T0, sc.src.xyz)[None], sc.src.mask[None]
    r, rm = sc.dst.xyz[None], sc.dst.mask[None]
    _, ub = nearest_neighbors_pallas_batched(q, r[:, ::16], rm[:, ::16],
                                             impl="cuda")
    jlo, jhi = block_ranges(q, qm, r, rm, ub, query_tile=K4_QUERY_TILE,
                            ref_block=K4_REF_BLOCK)
    return types.SimpleNamespace(T0=T0, q=q, qm=qm, r=r, rm=rm, jlo=jlo,
                                 jhi=jhi, refT=prepare_ref_batched(r, rm))


def registration_phase(dev, kb, report, kernels, card) -> None:
    """Phase 7: the calibration path (K4, with K1 and K3) at 131k points."""
    import tempfile

    import torch
    import oracle
    from pointcloud_stitching_tpu_torch.io import load_cal, save_ply
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        NN_QUERY_TILE, NN_RANGED_BLOCKS_PER_SM, NN_RANGED_CHUNK,
        nearest_neighbors_pruned, nn_batched_prepared,
        nn_batched_prepared_ranged, nn_ranged_chunks,
        nn_ranged_scratch_sizes)
    from pointcloud_stitching_tpu_torch.models import (register_global,
                                                       register_pair)
    from pointcloud_stitching_tpu_torch.ops import icp, icp_converge
    from pointcloud_stitching_tpu_torch.utils import prng

    sc = registration_scene(dev)
    src, dst, picks, n_src, T_true = (sc.src, sc.dst, sc.picks, sc.n_src,
                                      sc.T_true)
    moved = sc.moved
    valid = src.xyz[src.mask].cpu().numpy()

    def point_err(T, T_ref) -> float:
        """Largest distance between src's points under T and under T_ref."""
        got = oracle.transform_np(T.cpu().numpy(), valid)
        return float(np.linalg.norm(got - oracle.transform_np(T_ref, valid),
                                    axis=-1).max())

    say(f"[7/15 registration] src {n_src} points at a {sc.leaf:.4f} m leaf "
        f"({REG_CAP} slots), dst = src moved by a 0.05 rad / 5 cm pose + "
        f"1 mm noise")

    # (a)-(c): K4 at the first ICP iteration's shapes, 131072 x 131072
    ki = k4_inputs(dev, sc)
    T0, q, qm, r, rm, jlo, jhi, refT = (ki.T0, ki.q, ki.qm, ki.r, ki.rm,
                                        ki.jlo, ki.jhi, ki.refT)

    def k4(lo, hi, impl):
        return nn_batched_prepared_ranged(
            q, refT, lo, hi, query_tile=K4_QUERY_TILE,
            ref_block=K4_REF_BLOCK, impl=impl)

    gi, gd = k4(jlo, jhi, "cuda")
    ai, ad = k4(jlo, jhi, "cuda")
    wi, wd = k4(jlo, jhi, "torch")
    torch.cuda.synchronize()
    check(torch.equal(gi, wi), "K4 idx differs from plain")
    check(torch.equal(gd, wd), "K4 d2 not bitwise equal to plain")
    check(torch.equal(gi, ai) and torch.equal(gd, ad),
          "K4: two launches differ")
    nq, nm = jlo.shape[1], -(-REG_CAP // K4_REF_BLOCK)
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
    lib = kb.library()
    check(lib.pcs_nn_query_tile() == NN_QUERY_TILE,
          "K4's sub-tile differs between csrc/nn.cu and nn_pallas.py")
    n_q, m_r = q.shape[1], r.shape[1]
    n_keys, n_meta = nn_ranged_scratch_sizes(1, n_q)
    keys = torch.empty((n_keys,), dtype=torch.int64, device=dev)
    meta = torch.empty((n_meta,), dtype=torch.int32, device=dev)
    di, dd = torch.empty_like(gi), torch.empty_like(gd)

    def k4_direct(chunk, blocks_per_sm):
        """The kernel with a chunk size and grid depth of the caller's
        choosing, launched directly (launches not counted)."""
        kb.check(lib.pcs_nn_batched_ranged(
            q.data_ptr(), refT.data_ptr(), jlo.data_ptr(), jhi.data_ptr(), 1,
            n_q, m_r, K4_QUERY_TILE, K4_REF_BLOCK, chunk, blocks_per_sm,
            di.data_ptr(), dd.data_ptr(), keys.data_ptr(), meta.data_ptr(),
            kb.stream_handle(q)), "K4 sweep")

    k4_direct(NN_RANGED_CHUNK, NN_RANGED_BLOCKS_PER_SM)
    torch.cuda.synchronize()
    check(torch.equal(di, wi) and torch.equal(dd, wd),
          "K4 launched directly differs from plain")
    chunks = nn_ranged_chunks(jlo, jhi, n_q, m_r, K4_QUERY_TILE,
                              K4_REF_BLOCK)
    items, n_sub = int(chunks.sum()), chunks.numel()
    check(int(meta[n_sub]) == items and int(meta[n_sub + 1]) >= items,
          f"K4 counted {int(meta[n_sub])} items on the device, "
          f"nn_ranged_chunks {items}")
    grid = lib.pcs_nn_ranged_grid(NN_RANGED_BLOCKS_PER_SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(grid >= sms and grid % sms == 0, f"K4's grid is {grid} blocks")
    say(f"    (a) K4 {tuple(q.shape)} vs {tuple(r.shape)}, ranges of "
        f"block_ranges: idx equal, d2 bitwise equal, two launches equal; "
        f"blocks swept {share:.4f} of {nq} x {nm}; {items} items of "
        f"{NN_QUERY_TILE} queries x {NN_RANGED_CHUNK} references in {n_sub} "
        f"sub-tiles (1 to {int(chunks.max())} each, counted on the device "
        f"and in Python), 2 launches: set-up, then a persistent grid of "
        f"{grid} blocks x 128 threads ({grid // sms} per SM)")
    say(f"    (b) pruned NN (K3 coarse + K4) == brute-force K3 on "
        f"{int(qm.sum())} valid queries")
    say(f"    (c) K4 with ranges cut to one block: equal to plain, "
        f"{n_diff} valid queries differ from brute force")
    times = time_in_turns(lambda: k4(jlo, jhi, "cuda"),
                          lambda: k4(jlo, jhi, "torch"), reps=5)
    ms, pms, _ = times
    # the chunk size and grid depth behind NN_RANGED_CHUNK and
    # NN_RANGED_BLOCKS_PER_SM: the kernel at others, each equal to plain
    sweep = []
    for chunk, bps in ((1024, 0), (2048, 0), (4096, 0), (8192, 0),
                       (2048, 2), (2048, 4)):
        k4_direct(chunk, bps)
        torch.cuda.synchronize()
        check(torch.equal(di, wi) and torch.equal(dd, wd),
              f"K4 at chunk {chunk}, {bps} blocks per SM differs from plain")
        t_sw = cuda_ms(lambda: k4_direct(chunk, bps), 10)
        sweep.append(f"{chunk}/{lib.pcs_nn_ranged_grid(bps) // sms}: "
                     f"{t_sw:.4f}")
    say(f"    K4 by chunk / blocks per SM (ms, device), each equal to "
        f"plain: {', '.join(sweep)}")
    # the pairs this run's ranges sweep, 9 operations each (as K3)
    qt, rb = K4_QUERY_TILE, K4_REF_BLOCK
    t_idx = torch.arange(jlo.shape[1], device=dev)
    q_in_tile = torch.clamp(n_q - t_idx * qt, max=qt)
    refs = (torch.clamp((jhi.long() + 1) * rb, max=m_r) - jlo.long() * rb)
    pairs = int((torch.clamp(refs, min=0) * q_in_tile).sum())
    report("nn_batched_prepared_ranged",
           "pointcloud_stitching_tpu_torch/csrc/nn.cu",
           "pointcloud_stitching_tpu/kernels/nn_pallas.py:300",
           (gd - wd).abs().max().item(), times,
           nbytes(q, refT, jlo, jhi, gi, gd), 9 * pairs)
    del gi, gd, ai, ad, wi, wd, bi, bd, pi, pd, ni, nd, nwi, nwd, di, dd
    del keys, meta

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
    rg = register_global(src, dst_g, prng.key(0, device=dev),
                         num_starts=64, prune=True)
    torch.cuda.synchronize()
    lg = dict(kb.LAUNCHES)
    itg = int(rg.icp.iterations)
    check(lg.get("segment_sum_from_flags", 0) >= 2
          and lg.get("threefry2x32") == 1
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
        return cuda_ms(fn, reps, prefill=False) / k

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


# --- phase 8: the TSDF scene model ------------------------------------------
# bench.py's TSDF design point: the scene of its _tsdf_bench (three spheres
# and two planes, the surface at n . p = off), rendered here with numpy
TSDF_SCENE = dict(
    spheres=[((-0.4, 0.1, 1.4), 0.35), ((0.5, -0.2, 1.8), 0.3),
             ((0.0, 0.45, 1.1), 0.2)],
    planes=[((0.0, 0.0, -1.0), -2.4), ((0.0, -1.0, 0.0), -0.8)])
TSDF_NCAM, TSDF_GRID, TSDF_LEAF = 4, (256, 256, 256), 0.01
TSDF_ORIGIN = (-1.28, -0.6, 0.2)
TSDF_FX, TSDF_FY = 421.5, 421.1
KEYFRAMES = 5
CELL_CAPACITY = 1 << 19


def render_depth(fx, fy, ppx, ppy, w, h, T, spheres=(), planes=(),
                 z_clip=(0.05, 50.0)) -> np.ndarray:
    """Analytic z-depth [h, w] float32 of the nearest surface along each
    pixel ray of a pinhole camera at camera-to-world pose T (0 = no hit):
    the renderer of tests/test_tsdf.py, in float64."""
    T = np.asarray(T, np.float64)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    rays = np.stack([(u - ppx) / fx, (v - ppy) / fy, np.ones_like(u)], -1)
    d = rays @ T[:3, :3].T                  # world directions, z_cam = 1
    o = T[:3, 3]
    best = np.full(d.shape[:2], np.inf)
    for c, r in spheres:
        c = np.asarray(c, np.float64)
        a = np.sum(d * d, -1)
        b = 2.0 * np.sum(d * (o - c), -1)
        disc = b * b - 4 * a * (np.sum((o - c) ** 2) - r * r)
        z = np.where(disc >= 0,
                     (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), np.inf)
        best = np.minimum(best, np.where(z > z_clip[0], z, np.inf))
    for n, off in planes:
        n = np.asarray(n, np.float64)
        den = d @ n
        with np.errstate(divide="ignore"):
            z = np.where(np.abs(den) > 1e-12, (off - o @ n) / den, np.inf)
        best = np.minimum(best, np.where(z > z_clip[0], z, np.inf))
    return np.where(np.isfinite(best) & (best < z_clip[1]), best,
                    0.0).astype(np.float32)


def surface_distance(p: np.ndarray) -> np.ndarray:
    """Distance of points [N, 3] from the nearest analytic surface."""
    ds = [np.abs(np.linalg.norm(p - np.asarray(c), axis=-1) - r)
          for c, r in TSDF_SCENE["spheres"]]
    ds += [np.abs(p @ np.asarray(n) - off) for n, off in TSDF_SCENE["planes"]]
    return np.min(np.stack(ds), axis=0)


def tsdf_rig(k: int):
    """Keyframe k of the rig: bench.py's four camera poses, the whole rig
    moved 2 cm along x and 0.5 degrees about y per keyframe, and one dead
    rectangle per camera. Returns (extrinsics [4, 4, 4] float32, depth
    [4, H, W] uint16 in mm)."""
    a = np.radians(0.5 * k)
    rig = np.eye(4)
    rig[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]]
    rig[:3, 3] = [0.02 * k, 0.0, 0.0]
    exts, ds = [], []
    for i in range(TSDF_NCAM):
        ang = 0.12 * (i - 1.5)
        T = np.eye(4)
        T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]]
        T[:3, 3] = [0.25 * (i - 1.5), 0.0, -0.05 * i]
        T = (rig @ T).astype(np.float32)
        d = render_depth(TSDF_FX, TSDF_FY, W / 2.0, H / 2.0, W, H, T,
                         **TSDF_SCENE)
        d[140 + 30 * i:220 + 30 * i, 280:420] = 0.0   # dead rectangle
        exts.append(T)
        ds.append(d)
    return np.stack(exts), (np.stack(ds) * 1000.0).astype(np.uint16)


def pose_error(T, T_ref):
    """(translation m, rotation degrees) between two poses."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    c = (np.trace(T[:3, :3].T @ T_ref[:3, :3]) - 1.0) / 2.0
    return (float(np.linalg.norm(T[:3, 3] - T_ref[:3, 3])),
            float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))


def count_syncs(fn) -> int:
    """Host syncs that one call of ``fn`` makes."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def median_ms(fn, n: int) -> float:
    """Median ms of ``n`` synced calls of ``fn`` (after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def tsdf_phase(dev, kb, report, kernels, card) -> None:
    """Phase 8: the TSDF scene model (K5) at bench.py's design point."""
    import tempfile

    import torch
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.kernels.patch_gather import (
        patch_gather)
    from pointcloud_stitching_tpu_torch.models import tsdf as TM
    from pointcloud_stitching_tpu_torch.ops.se3 import se3_inverse
    from pointcloud_stitching_tpu_torch.ops.surface import weld_mesh

    i1 = Intrinsics.create(fx=TSDF_FX, fy=TSDF_FY, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i1.stack([i1] * (TSDF_NCAM - 1))
    frames = [tsdf_rig(k) for k in range(KEYFRAMES)]
    ext_np, depth_np = frames[0]
    ext = torch.from_numpy(ext_np).to(dev)
    depth = torch.from_numpy(depth_np).to(dev)
    color = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (TSDF_NCAM, H, W, 3), dtype=np.uint8)).to(dev)

    def volume(with_rgb=False):
        return TM.TSDFVolume.create(TSDF_GRID, TSDF_LEAF, origin=TSDF_ORIGIN,
                                    with_rgb=with_rgb, device=dev)

    # (a) K5 on camera 0's REFINE bricks, with the windows integrate plans
    vol = volume()
    depth_raw = depth.to(torch.float32)
    inv = se3_inverse(ext)
    shape = TSDF_GRID
    zero, inf = torch.zeros((), device=dev), torch.full((), np.inf,
                                                        device=dev)
    refine = [TM._classify_bricks(depth_raw[c] * 0.001, TM._cam_slice(
        intr, c), inv[c], shape, vol.origin, vol.leaf, vol.trunc, zero,
        inf)[2] for c in range(TSDF_NCAM)]
    n_refine = [int(r.sum()) for r in refine]
    bsel = torch.nonzero(refine[0])[:, 0]
    _, pix_ok, uib, vib = TM._brick_pixels(bsel, shape, vol.origin, vol.leaf,
                                           inv[0], TM._cam_slice(intr, 0),
                                           W, H)
    v0, u0, fits = TM._plan_windows(uib, vib, pix_ok.reshape(uib.shape))
    iv, iu = vib - v0[:, None], uib - u0[:, None]
    img = depth_raw[0]
    got = patch_gather(img, v0, u0, iv, iu, impl="cuda")
    want = patch_gather(img, v0, u0, iv, iu, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K5 differs from plain on REFINE bricks")
    flat = (vib * W + uib).long()
    fit_ok = fits[:, None] & pix_ok.reshape(uib.shape)
    check(torch.equal(got[fit_ok], img.reshape(-1)[flat][fit_ok]),
          "K5 misses the pixel of a voxel in a fitting window")
    # hand-made windows: negative, unaligned and clamped starts; local
    # indices in the window, in the alignment slop and outside it
    rng = np.random.default_rng(8)
    nh = 4096
    hv0 = rng.integers(-20, H + 20, nh).astype(np.int32)
    hu0 = rng.integers(-200, W + 200, nh).astype(np.int32)
    hv0[:4], hu0[:4] = [-3, H - 2, H - 129, 7], [-130, W - 5, W - 257, 127]
    hand = [torch.from_numpy(a).to(dev) for a in (
        hv0, hu0, rng.integers(-10, 140, (nh, 512)).astype(np.int32),
        rng.integers(-140, 270, (nh, 512)).astype(np.int32))]
    hg = patch_gather(img, *hand, impl="cuda")
    hw = patch_gather(img, *hand, impl="torch")
    torch.cuda.synchronize()
    check(torch.equal(hg, hw), "K5 differs from plain on hand-made windows")
    check(bool((hw == 0).any()) and bool((hw != 0).any()),
          "hand-made windows missed a case")
    say(f"[8/15 tsdf] {TSDF_NCAM} x {H}x{W} u16 into {TSDF_GRID} at "
        f"{TSDF_LEAF} m; REFINE bricks per camera {n_refine} of "
        f"{refine[0].numel()}")
    say(f"    (a) K5 bitwise equal to plain on camera 0's {bsel.numel()} "
        f"REFINE bricks ({int((~fits).sum())} not fitting a window) and on "
        f"{nh} hand-made windows")
    times = time_in_turns(
        lambda: patch_gather(img, v0, u0, iv, iu, impl="cuda"),
        lambda: patch_gather(img, v0, u0, iv, iu, impl="torch"))
    # no one PyTorch call computes K5's function. Like for like: the calls
    # that compute all of it from (v0, u0, iv, iu): the window's aligned
    # and clamped start, the window and image tests, the gather, the zero
    # fill. Beside it, torch.take alone on flat indices worked out
    # beforehand (the gather without K5's arithmetic).
    flat_img = img.reshape(-1)
    hp, wp = max(512, -(-H // 8) * 8), max(1024, -(-W // 128) * 128)

    def k5_in_torch_calls():
        v0a = torch.clamp(v0 - torch.remainder(v0, 8), 0, hp - 128)
        u0a = torch.clamp(u0 - torch.remainder(u0, 128), 0, wp - 256)
        ivl, iul = iv + (v0 - v0a)[:, None], iu + (u0 - u0a)[:, None]
        rr, cc = v0a[:, None] + ivl, u0a[:, None] + iul
        ok = ((ivl >= 0) & (ivl < 128) & (iul >= 0) & (iul < 256)
              & (rr < H) & (cc < W))
        at = torch.clamp(rr, 0, H - 1) * W + torch.clamp(cc, 0, W - 1)
        return torch.where(ok, torch.take(flat_img, at.long()), 0.0)

    check(torch.equal(k5_in_torch_calls(), got),
          "K5 differs from its function in PyTorch calls")
    take_ms = cuda_ms(lambda: torch.take(flat_img, flat), 20)
    lib_ms = cuda_ms(k5_in_torch_calls, 20)
    say(f"    K5 beside PyTorch: the whole function in PyTorch calls "
        f"{lib_ms:.4f} ms (the library time below), torch.take alone on "
        f"ready-made int64 indices {take_ms:.4f} ms")
    report("patch_gather",
           "pointcloud_stitching_tpu_torch/csrc/patch_gather.cu",
           "pointcloud_stitching_tpu/kernels/patch_gather.py:118",
           (got - want).abs().max().item(), times,
           nbytes(img, v0, u0, iv, iu, got), 0, lib_ms)

    # (b) integrate: 'auto' (the pruned path through K5) against 'dense'
    for with_rgb in (False, True):
        col = color if with_rgb else None
        runs = {}
        for method, impl in (("dense", "auto"), ("auto", "auto"),
                             ("auto", "torch")):
            kb.reset_launches()
            v = TM.integrate(volume(with_rgb), depth, intr, ext, color=col,
                             method=method, kernel_impl=impl)
            torch.cuda.synchronize()
            runs[(method, impl)] = (v, dict(kb.LAUNCHES))
        dense = runs[("dense", "auto")][0]
        for key in (("auto", "auto"), ("auto", "torch")):
            v = runs[key][0]
            same = (torch.equal(v.tsdf, dense.tsdf)
                    and torch.equal(v.weight, dense.weight)
                    and (not with_rgb or torch.equal(v.rgb, dense.rgb)))
            check(same, f"integrate {key} differs from dense "
                        f"(colour {with_rgb})")
        want_l = {"patch_gather": TSDF_NCAM * (2 if with_rgb else 1)}
        check(runs[("auto", "auto")][1] == want_l,
              f"integrate launches {runs[('auto', 'auto')][1]}, want "
              f"{want_l}")
        check(not runs[("auto", "torch")][1] and not runs[("dense",
                                                           "auto")][1],
              "integrate launched K5 under kernel_impl='torch' or 'dense'")
        say(f"    (b) integrate auto == dense bit for bit (tsdf, weight"
            f"{', rgb' if with_rgb else ''}), also with kernel_impl='torch';"
            f" K5 launches {want_l['patch_gather']} (colour {with_rgb}); "
            f"observed voxels {int((dense.weight > 0).sum())}")
    del runs, dense, v

    # (c) five keyframes with colour, mesh, save, the mesh CLI
    vol = volume(with_rgb=True)
    kb.reset_launches()
    for ext_k, depth_k in frames:
        vol = TM.integrate(vol, torch.from_numpy(depth_k).to(dev), intr,
                           torch.from_numpy(ext_k).to(dev), color=color)
    torch.cuda.synchronize()
    launches = kb.LAUNCHES.get("patch_gather", 0)
    check(dict(kb.LAUNCHES) == {"patch_gather": KEYFRAMES * TSDF_NCAM * 2},
          f"keyframe launches {dict(kb.LAUNCHES)}")
    kernels["patch_gather"]["launches"] = launches
    verts, valid, n_active = TM.extract_mesh(vol, CELL_CAPACITY)
    n_act = int(n_active)
    check(0 < n_act <= CELL_CAPACITY, f"{n_act} surface cells")
    vw, fw = weld_mesh(verts, valid)
    dist = surface_distance(vw.astype(np.float64))
    p99 = float(np.quantile(dist, 0.99))
    check(len(fw) > 0 and p99 < TSDF_LEAF,
          f"mesh vertices p99 {p99} m from the surface")
    say(f"    (c) {KEYFRAMES} keyframes (K5 launches {launches}): "
        f"n_active {n_act}, welded mesh {len(vw)} vertices {len(fw)} "
        f"triangles; vertex distance from the analytic surface median "
        f"{np.median(dist) * 1e3:.4f} mm p99 {p99 * 1e3:.4f} mm")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "scene_tsdf.npz"), os.path.join(
            tmp, "scene.ply")
        TM.save_volume(src, vol)
        back = TM.load_volume(src, device=dev)
        check(torch.equal(back.tsdf, vol.tsdf) and torch.equal(back.rgb,
                                                               vol.rgb),
              "load_volume differs from the saved volume")
        env = {k: v for k, v in os.environ.items() if k != "PCS_PLATFORM"}
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "pointcloud_stitching_tpu_torch.tools.mesh_cli", src, out,
             "--cell-capacity", str(CELL_CAPACITY)], cwd=REPO,
            capture_output=True, text=True, timeout=300, env=env)
        t_cli = time.perf_counter() - t
        check(proc.returncode == 0, f"mesh_cli failed:\n{proc.stderr}")
        check(os.path.getsize(out) > 0, "mesh_cli wrote no .ply")
        cli_line = proc.stdout.strip().splitlines()[-1]
    check(f" {len(fw)} triangles" in cli_line,
          f"mesh_cli: {cli_line}, in process {len(fw)} triangles")
    say(f"    (c) save_volume/load_volume equal; mesh_cli (default device) "
        f"{t_cli:.1f} s as a subprocess: {cli_line.split(': ', 1)[1]}")

    # (d) raycast from camera 0 at stride 2, full and with the prior depth
    T0 = ext[0]
    i0 = TM._cam_slice(intr, 0)
    truth = render_depth(TSDF_FX, TSDF_FY, W / 2.0, H / 2.0, W, H,
                         ext_np[0], **TSDF_SCENE)[::2, ::2]
    rc = {}
    for tag, prior in (("full", None), ("prior", depth[0])):
        r = TM.raycast(vol, i0, T0, stride=2, prior_depth=prior)
        ok = r.valid.cpu().numpy() & (truth > 0)
        err = np.abs(r.depth.cpu().numpy()[ok] - truth[ok])
        med = float(np.median(err))
        # the 2.56 m volume fills about a third of camera 0's view
        check(ok.mean() > 0.25 and med < TSDF_LEAF,
              f"raycast {tag}: {ok.mean():.3f} valid, median {med} m")
        rc[tag] = (float(ok.mean()), med)
    # track from a pose 1 degree and 1 cm off camera 0's (in its frame)
    a = np.radians(1.0)
    dT = np.eye(4, dtype=np.float32)
    dT[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]]
    dT[:3, 3] = [0.006, -0.006, 0.005]
    T_init = torch.from_numpy(ext_np[0] @ dT).to(dev)
    res = TM.track(vol, depth[0], i0, T_init, prior_window=0.3)
    e0 = pose_error(T_init.cpu().numpy(), ext_np[0])
    e1 = pose_error(res.T.cpu().numpy(), ext_np[0])
    check(e1[0] < 0.005 and e1[1] < 0.2,
          f"track error {e1[0] * 1e3:.3f} mm {e1[1]:.4f} deg")
    say(f"    (d) raycast stride 2: valid share / median |depth - analytic| "
        f"full {rc['full'][0]:.4f} / {rc['full'][1] * 1e3:.4f} mm, prior "
        f"{rc['prior'][0]:.4f} / {rc['prior'][1] * 1e3:.4f} mm; track from "
        f"{e0[0] * 1e3:.2f} mm {e0[1]:.3f} deg off to {e1[0] * 1e3:.4f} mm "
        f"{e1[1]:.4f} deg ({int(res.n_matched)} matched, rms "
        f"{float(res.rms) * 1e3:.4f} mm)")

    # (e) timings: medians of synced calls
    def integ(method, with_rgb):
        state = {"v": volume(with_rgb)}

        def step():
            state["v"] = TM.integrate(state["v"], depth, intr, ext,
                                      color=color if with_rgb else None,
                                      method=method)
        return step

    t_auto = median_ms(integ("auto", False), 7)
    t_dense = median_ms(integ("dense", False), 5)
    t_rgb = median_ms(integ("auto", True), 5)
    t_auto2 = median_ms(integ("auto", False), 7)
    t_rc_full = median_ms(lambda: TM.raycast(vol, i0, T0, stride=2), 5)
    t_rc_prior = median_ms(lambda: TM.raycast(vol, i0, T0, stride=2,
                                              prior_depth=depth[0]), 5)
    t_track = median_ms(lambda: TM.track(vol, depth[0], i0, T_init,
                                         prior_window=0.3), 3)
    s_auto = count_syncs(integ("auto", False))
    s_rgb = count_syncs(integ("auto", True))
    s_dense = count_syncs(integ("dense", False))
    peaks = {}
    for tag, method, with_rgb in (("auto", "auto", False),
                                  ("dense", "dense", False),
                                  ("auto rgb", "auto", True)):
        step = integ(method, with_rgb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peaks[tag] = torch.cuda.max_memory_allocated() / 2 ** 20
    say(f"    (e) timing {card}: ms per integrate auto {t_auto:.3f} / "
        f"{t_auto2:.3f}, dense {t_dense:.3f}, auto with colour "
        f"{t_rgb:.3f}; raycast stride 2 full {t_rc_full:.3f} prior "
        f"{t_rc_prior:.3f}; track {t_track:.3f}; host syncs per integrate "
        f"auto {s_auto} auto+colour {s_rgb} dense {s_dense}; peak memory "
        f"MiB {', '.join(f'{k} {v:.1f}' for k, v in peaks.items())}")


# --- phase 9: the streaming runtime ------------------------------------------
STREAM_FRAMES = 30       # per run
CLI_FRAMES = 20


def stream_rig():
    """bench.py's loopback rig (_make_stream_rig): one synthetic_frames
    frame per camera and cameras 10 cm apart on a line."""
    from pointcloud_stitching_tpu_torch.runtime import synthetic_frames
    frames = [synthetic_frames(1, H, W, seed=s) for s in range(NCAM)]
    ext = np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1))
    for i in range(NCAM):
        ext[i, :3, 3] = np.array([0.1 * i, -0.05 * i, 0.02 * i], np.float32)
    return frames, ext


def same_output(a, b) -> bool:
    return (all(torch_equal(getattr(a.cloud, k), getattr(b.cloud, k))
                for k in ("xyz", "mask", "rgb"))
            and torch_equal(a.extrinsics, b.extrinsics)
            and torch_equal(a.metrics.points_in, b.metrics.points_in)
            and torch_equal(a.metrics.points_out, b.metrics.points_out))


def torch_equal(x, y) -> bool:
    import torch
    if x is None or y is None:
        return x is None and y is None
    return bool(torch.equal(x, y))


def stream_phase(dev, kb, card) -> None:
    """Phase 9: 8 fake camera servers -> the pipelined client -> the
    flagship pipeline; then the stitch CLI and the camera test as
    subprocesses."""
    import tempfile

    import torch
    from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                                StitchingPipeline, native)
    from pointcloud_stitching_tpu_torch.io import load_ply
    from pointcloud_stitching_tpu_torch.models.tsdf import load_volume
    from pointcloud_stitching_tpu_torch.models.voxel_map import load_map
    from pointcloud_stitching_tpu_torch.runtime import (
        Codec, FakeCameraServer, MulticameraClient)

    t_phase = time.perf_counter()
    check(native.available(), "the port's native codec library did not "
                              "build: no snappy stream")
    frames, ext = stream_rig()
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    servers = []
    try:
        for color in (False, True):
            for srv in servers:
                srv.stop()
            servers = [FakeCameraServer(f, codec=Codec.SNAPPY,
                                        color=color).start() for f in frames]
            pipe = StitchingPipeline(flagship_cfg(StitchConfig,
                                                  with_color=color),
                                     intr, ext, device=dev)
            d = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
            c = (torch.from_numpy(np.stack([s.colors[0] for s in servers]))
                 .to(dev) if color else None)
            want = pipe(d, c)
            direct_ms = median_ms(lambda: pipe(d, c), 10)
            s_direct = count_syncs(lambda: pipe(d, c))
            client = MulticameraClient([("127.0.0.1", s.port)
                                        for s in servers], pipe).start()
            try:
                check(client.wait_for_first_frames(timeout=30),
                      f"no frames from the loopback servers: "
                      f"{client.camera_errors()}")
                client.run(num_frames=3)
                s_stream = count_syncs(lambda: client.run(num_frames=10))
                check(s_stream <= 10 * (s_direct + 1),
                      f"{s_stream} host syncs in 10 streamed frames, the "
                      f"direct call makes {s_direct}")
                pinned = [t.is_pinned() for st in client._stage_ring
                          for t in st.host.values() if t is not None]
                check(pinned and all(pinned), "staging buffers not pinned")
                for sync_every in (1, 4):
                    client.metrics.reset()
                    client.stages.reset()
                    outs = []
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    kb.reset_launches()
                    m = client.run(num_frames=STREAM_FRAMES,
                                   sync_every=sync_every,
                                   on_frame=lambda i, o: outs.append(o))
                    torch.cuda.synchronize()
                    launches = dict(kb.LAUNCHES)
                    peak = torch.cuda.max_memory_allocated() / 2 ** 20
                    check(len(outs) == STREAM_FRAMES == m.total_frames,
                          f"{len(outs)} frames streamed")
                    bad = [i for i, o in enumerate(outs)
                           if not same_output(o, want)]
                    check(not bad, f"streamed frames {bad} differ from the "
                                   "direct call")
                    want_l = {"nn_batched_prepared": 5 * STREAM_FRAMES,
                              "segment_sum_from_flags": STREAM_FRAMES,
                              "segment_sum_sorted": STREAM_FRAMES}
                    check(launches == want_l, f"stream launches {launches}")
                    st = client.stages.summary()
                    say(f"[9/15 stream] {card}: {NCAM} x {H}x{W} snappy, "
                        f"{'DEPTH16_COLOR' if color else 'DEPTH16'}, "
                        f"sync_every={sync_every}: {STREAM_FRAMES} frames "
                        f"bitwise equal to the direct call "
                        f"(points_out {int(want.metrics.points_out)}); fps "
                        f"{m.fps:.2f}, latency p50 {m.latency_ms(50):.2f} "
                        f"p99 {m.latency_ms(99):.2f} ms, points/s "
                        f"{m.points_per_sec:.4g}; stage means ms {st}; "
                        f"launches {launches}; peak memory {peak:.1f} MiB")
                # the snapshot alone, with the ingest threads idle (no
                # pull is woken): the copy's own cost, without the GIL
                # contention of a running stream
                t = time.perf_counter()
                for _ in range(10):
                    client._snapshot(wake=False)
                snap_ms = (time.perf_counter() - t) * 100
                say(f"    direct StitchingPipeline on the same frames "
                    f"{direct_ms:.3f} ms/frame (median of 10 synced calls); "
                    f"host syncs per frame: direct {s_direct}, streamed "
                    f"{s_stream / 10:.2f}; staging ring "
                    f"{len(client._stage_ring)} pinned slots; snapshot "
                    f"alone (ingest idle) {snap_ms:.3f} ms")
            finally:
                client.stop()
            del want, outs, d, c, pipe

        # the stitch CLI (colour, TSDF keyframes) and the camera test as
        # subprocesses on the default device, against these servers
        cam_srv = FakeCameraServer(frames[0], codec=Codec.SNAPPY).start()
        servers.append(cam_srv)
        env = {k: v for k, v in os.environ.items() if k != "PCS_PLATFORM"}
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "scene_tsdf.npz")
            cli = [sys.executable, "-m",
                   "pointcloud_stitching_tpu_torch.runtime.stitch_cli"]
            for srv in servers[:NCAM]:
                cli += ["--camera", f"127.0.0.1:{srv.port}"]
            scene = os.path.join(tmp, "scene.npz")
            cli += ["--height", str(H), "--width", str(W),
                    "--frames", str(CLI_FRAMES), "--color", "--save-dir",
                    tmp, "--save-every", "10", "--tsdf-leaf", "0.02",
                    "--tsdf-every", "5", "--tsdf-out", npz,
                    "--map-leaf", "0.01", "--map-out", scene,
                    "--print-every", "10", "--timing"]
            cam = [sys.executable, "-m",
                   "pointcloud_stitching_tpu_torch.runtime.camera_test",
                   "--port", str(cam_srv.port), "--frames", "30",
                   "--deproject"]
            t = time.perf_counter()
            procs = [subprocess.Popen(a, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
                     for a in (cli, cam)]
            try:
                res = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            t_sub = time.perf_counter() - t
            for p, (out, err), tag in zip(procs, res, ("stitch_cli",
                                                       "camera_test")):
                check(p.returncode == 0, f"{tag} failed:\n{err[-3000:]}")
            plys = sorted(f for f in os.listdir(tmp) if f.endswith(".ply"))
            check(plys == ["cloud_000000.ply", "cloud_000010.ply"],
                  f"stitch_cli wrote {plys}")
            xyz, rgb = load_ply(os.path.join(tmp, plys[-1]))
            check(len(xyz) > 0 and rgb is not None, "empty PLY from the CLI")
            vol = load_volume(npz, device=dev)
            occ = int((vol.weight > 0).sum())
            check(occ > 0 and vol.rgb is not None, "TSDF without weights")
            vmap = load_map(scene, device=dev)
            n_vox = int(vmap.count())
            check(n_vox > 0 and vmap.rgb_sums is not None
                  and vmap.capacity == 2 ** 20,
                  "stitch_cli's voxel map is empty or has no colour")
            cli_out = res[0][0].strip().splitlines()
            say(f"    stitch_cli ({CLI_FRAMES} frames, --color, TSDF every "
                f"5 at 2 cm, voxel map at 1 cm) and camera_test --deproject "
                f"together {t_sub:.1f} s as subprocesses: {len(xyz)} points "
                f"in {plys[-1]}, {occ} observed voxels in the TSDF "
                f"checkpoint, {n_vox} in the map's; cli: {cli_out[-3]} | "
                f"{cli_out[-1]}; camera_test: "
                f"{res[1][0].strip().splitlines()[-1]}")
            # the mesh CLI on the CLI's map checkpoint and on one 848x480
            # depth frame (bilateral-smoothed), as subprocesses
            depth_npy = os.path.join(tmp, "depth.npy")
            np.save(depth_npy, frames[0])
            mesh = [sys.executable, "-m",
                    "pointcloud_stitching_tpu_torch.tools.mesh_cli"]
            # 128 nodes a side (phase 10 meshes a map at the default 256)
            jobs = [mesh + [scene, os.path.join(tmp, "scene_mesh.ply"),
                            "--max-nodes", "128"],
                    mesh + [depth_npy, os.path.join(tmp, "depth_mesh.ply"),
                            "--bilateral", "0.03"]]
            t = time.perf_counter()
            procs = [subprocess.Popen(a, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE) for a in jobs]
            try:
                res = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            lines = []
            for p, (out, err), tag in zip(procs, res, ("map", "depth")):
                check(p.returncode == 0, f"mesh_cli ({tag}) failed:\n"
                                         f"{err[-3000:]}")
                lines.append(out.strip().splitlines()[-1])
                n_tri = int(lines[-1].split(" triangles")[0].split()[-1])
                check(n_tri > 1000, f"mesh_cli ({tag}): {lines[-1]}")
            say(f"    mesh_cli on the map checkpoint (--max-nodes 128) and "
                f"on a {H}x{W} depth "
                f"frame (--bilateral 0.03) together "
                f"{time.perf_counter() - t:.1f} s as subprocesses: "
                f"{' | '.join(os.path.basename(l) for l in lines)}")
    finally:
        for srv in servers:
            srv.stop()
    say(f"    phase 9 took {time.perf_counter() - t_phase:.1f} s")

# --- phase 10: the temporal voxel map ----------------------------------------
MAP_CAPACITY = 2 ** 20   # TemporalAccumulator's documented sizing
MAP_LEAF = 0.01
MAP_UPDATES = 10
MAP_SHIFT = 0.05         # meters: the rig's second pose in the eviction runs
MAP_DECAY = 0.5          # 1.875 * 0.5^6 < 0.05: pose A's own voxels evict at
                         # the 6th update of pose B (4 of A, then 6 of B)


def stream_colors(frames) -> np.ndarray:
    """FakeCameraServer's synthetic depth-aligned colour of the rig's
    frames ([NCAM, H, W, 3] uint8)."""
    d = np.stack([f[0] for f in frames]).astype(np.float32)
    return np.stack([np.clip(d / 16.0, 0, 255), np.clip(255 - d / 16.0, 0, 255),
                     np.full_like(d, 128.0)], axis=-1).astype(np.uint8)


def same_map(a, b) -> bool:
    return all(torch_equal(getattr(a, k), getattr(b, k))
               for k in ("ijk", "sums", "weight", "leaf", "rgb_sums"))


def device_profile(fn, calls: int = 5):
    """``torch.profiler`` over ``calls`` synced calls of ``fn``: (wall ms,
    device busy ms, kernel launches, [(device ms, launches, kernel)] by
    device time), all per call."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    kern = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e3 / calls
            kern[ev.name][1] += 1
    top = sorted(((t_, n / calls, name) for name, (t_, n) in kern.items()),
                 reverse=True)
    return (wall, sum(v[0] for v in kern.values()),
            sum(v[1] for v in kern.values()) / calls, top)


def timed_calls(module, names, timings):
    """Wrap ``module``'s functions ``names`` so that each call adds its
    synced host ms to ``timings[name]``; returns a function that undoes
    it."""
    import torch
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[name] = timings.get(name, 0.0) + (
                time.perf_counter() - t) * 1e3
            return out
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def map_phase(dev, kb, report, kernels, card) -> None:
    """Phase 10: the flagship stitch of phase 9's rig into a
    TemporalAccumulator of 2^20 slots at 1 cm, with and without colour, at
    decay 1 and with evictions; K1 at the map's shape; then change
    detection, localization and the isosurface of the map."""
    import torch
    from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                                StitchingPipeline)
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        k1_grid, segment_sum_from_flags)
    from pointcloud_stitching_tpu_torch.models import voxel_map as VM
    from pointcloud_stitching_tpu_torch.ops import (
        detect_changes_map, reconstruct_surface, se3_apply, se3_from_rt,
        se3_inverse, so3_exp)
    from pointcloud_stitching_tpu_torch.ops import surface as surface_mod

    t_phase = time.perf_counter()
    k1 = "segment_sum_from_flags"
    frames, ext = stream_rig()
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    d = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    c = torch.from_numpy(stream_colors(frames)).to(dev)
    ext_b = ext.copy()
    ext_b[:, 0, 3] += MAP_SHIFT
    clouds = {}
    for color in (False, True):
        pipes = [StitchingPipeline(flagship_cfg(StitchConfig,
                                                with_color=color),
                                   intr, e, device=dev) for e in (ext, ext_b)]
        tag = "colour" if color else "depth"
        map_launches = 0
        for decay in (1.0, MAP_DECAY):
            plan = ([0] * MAP_UPDATES if decay == 1.0
                    else [0] * 4 + [1] * (MAP_UPDATES - 4))
            acc, ref = (VM.TemporalAccumulator(
                capacity=MAP_CAPACITY, leaf=MAP_LEAF, decay=decay,
                with_rgb=color, impl=impl, device=dev)
                for impl in ("auto", "torch"))
            counts = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kb.reset_launches()
            for p in plan:
                out = pipes[p](d, c if color else None)
                before = kb.LAUNCHES[k1]
                acc.update(out.cloud)
                check(kb.LAUNCHES[k1] == before + 1,
                      f"map update ({tag}, decay {decay}) did not launch K1 "
                      "once")
                map_launches += 1
                ref.update(out.cloud)
                check(same_map(acc.state, ref.state),
                      f"map ({tag}, decay {decay}) after update "
                      f"{len(counts) + 1}: 'auto' differs from 'torch'")
                counts.append(int(acc.state.count()))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches = dict(kb.LAUNCHES)
            n = len(plan)
            want_l = {"nn_batched_prepared": 5 * n, k1: 2 * n,
                      "segment_sum_sorted": n}
            check(launches == want_l, f"map run launches {launches}, want "
                                      f"{want_l}")
            check(counts[-1] < MAP_CAPACITY, "the map saturated")
            if decay == 1.0:
                check(len(set(counts)) == 1, f"static frames changed the "
                                             f"voxel set: {counts}")
                clouds[color] = (acc.state, out.cloud,
                                 pipes[1](d, c if color else None).cloud)
            else:
                check(counts[-1] < counts[-2], f"no eviction: {counts}")
            cloud = out.cloud
            ms_update = median_ms(lambda: acc.update(cloud), 10)
            # device time per update, the queue held while 3 are enqueued
            dev_update = cuda_ms(lambda: acc.update(cloud), 3)
            syncs = count_syncs(lambda: acc.update(cloud))
            check(syncs == 0, f"{syncs} host syncs in one map update")
            if decay == 1.0:
                wall, busy, n_k, top = device_profile(
                    lambda: acc.update(cloud))
                say(f"    one map update ({tag}) under torch.profiler: "
                    f"{wall:.3f} ms wall, device busy {busy:.3f} ms (idle "
                    f"share {1 - busy / wall:.3f}), {n_k:.0f} kernel "
                    f"launches; most device time: " + "; ".join(
                        f"{t_:.4f} ms x{n_:.0f} {name[:60]}"
                        for t_, n_, name in top[:4]))
            say(f"[10/15 map] {card}: {NCAM} x {H}x{W} stitched ({tag}) "
                f"into {MAP_CAPACITY} slots at {MAP_LEAF} m, decay {decay}: "
                f"{n} updates, 'auto' == 'torch' bit for bit after each; "
                f"voxels per update {counts}; launches {launches} (1 K1 per "
                f"map update); ms per update {ms_update:.3f} (median of 10 "
                f"synced), device ms per update {dev_update:.3f}; host syncs "
                f"per update {syncs}; peak memory "
                f"{peak:.1f} MiB")

        # K1 at the map's shape: the rows of the last update's merge
        flags, vals = VM._merge_rows(acc.state, cloud, MAP_DECAY, 0.05)
        n_rows, ch = vals.shape
        junk = [torch.full((MAP_CAPACITY, ch), float("nan"), device=dev)
                for _ in range(2)]
        del junk
        got = segment_sum_from_flags(vals, flags, MAP_CAPACITY, impl="cuda")
        again = segment_sum_from_flags(vals, flags, MAP_CAPACITY, impl="cuda")
        want = segment_sum_from_flags(vals, flags, MAP_CAPACITY, impl="torch")
        torch.cuda.synchronize()
        bad = (got != want).any(dim=1).nonzero().flatten()
        check(bad.numel() == 0,
              f"K1 at the map's shape ({tag}) differs from plain in "
              f"{bad.numel()} slots, first {bad[:5].tolist()}: "
              f"{got[bad[:3]].tolist()} vs {want[bad[:3]].tolist()}")
        check(torch.equal(got, again), f"K1 at the map's shape ({tag}): two "
                                       "launches differ")
        # a control: each empty row (weight 0) flagged as a run of its own
        # gives the same sums; it shows what the empty rows' one long run
        # at the end of the sorted rows costs K1
        tail = flags | (vals[:, 6] == 0)
        check(torch.equal(segment_sum_from_flags(
            vals, tail, MAP_CAPACITY, impl="cuda"), got),
            "K1 with every empty row flagged gives other sums")
        t_tail = cuda_ms(lambda: segment_sum_from_flags(
            vals, tail, MAP_CAPACITY, impl="cuda"), 20)
        times = time_in_turns(
            lambda: segment_sum_from_flags(vals, flags, MAP_CAPACITY,
                                           impl="cuda"),
            lambda: segment_sum_from_flags(vals, flags, MAP_CAPACITY,
                                           impl="torch"))
        rows = int((torch.cumsum(flags.to(torch.int32), 0)
                    <= MAP_CAPACITY).sum())
        tiles, zero_blocks = k1_grid(n_rows, ch, MAP_CAPACITY)
        say(f"    K1 at the map's shape ({tag}) {tuple(vals.shape)} into "
            f"{MAP_CAPACITY} slots: bitwise equal to plain, two launches "
            f"bitwise equal; {int(flags.sum())} runs, {rows} of {n_rows} "
            f"rows have an id below the capacity; 1 launch of {tiles} tiles "
            f"+ {zero_blocks} zero-only blocks; {int((vals[:, 6] == 0).sum())}"
            f" empty rows, with each flagged as its own run {t_tail:.4f} ms "
            f"(sums bit for bit equal)")
        name = "segment_sum_from_flags (voxel map" + (
            ", 10 channels)" if color else ")")
        report(name, "pointcloud_stitching_tpu_torch/csrc/segment_reduce.cu",
               "pointcloud_stitching_tpu/kernels/segment_reduce.py:161",
               (got - want).abs().max().item(), times,
               nbytes(flags, got) + rows * ch * vals.element_size(),
               rows * ch)
        kernels[name]["launches"] = map_launches
        del flags, vals, got, again, want, acc, ref, pipes

    # change detection, localization and the isosurface of the depth map
    vmap, cloud_a, cloud_b = clouds[False]
    t = time.perf_counter()
    same = detect_changes_map(vmap, cloud_a)
    moved = detect_changes_map(vmap, cloud_b)
    n_moved = int(moved.sum())
    t_change = (time.perf_counter() - t) * 1e3
    check(not bool(same.any()), "points of the mapped frame read as changed")
    check(0 < n_moved < int(cloud_b.mask.sum()),
          f"{n_moved} changed points in the shifted frame")
    T_true = se3_from_rt(so3_exp(torch.tensor([0.0, 0.0, 0.0175],
                                              device=dev)),
                         torch.tensor([0.02, -0.01, 0.01], device=dev))
    query = cloud_a.replace(xyz=se3_apply(se3_inverse(T_true), cloud_a.xyz))
    t = time.perf_counter()
    res = VM.localize(vmap, query, iterations=20, max_corr_dist=0.1)
    T_got = res.T.cpu().numpy()
    t_loc = time.perf_counter() - t
    e_t, e_r = pose_error(T_got, T_true.cpu().numpy())
    check(e_t < 0.005 and e_r < 0.25,
          f"localize missed the transform by {e_t * 1e3:.3f} mm / "
          f"{e_r:.4f} deg")
    stages = {}
    undo = timed_calls(surface_mod, ("map_grid_bounds", "field_from_map",
                                     "marching_tetrahedra", "weld_mesh"),
                       stages)
    t = time.perf_counter()
    try:
        verts, faces, n_active = reconstruct_surface(vmap)
    finally:
        undo()
    t_mesh = time.perf_counter() - t
    check(len(faces) > 0 and np.isfinite(verts).all(), "no map surface")
    say(f"    change detection: 0 of {int(cloud_a.mask.sum())} points of the "
        f"mapped frame changed, {n_moved} of {int(cloud_b.mask.sum())} of "
        f"the frame shifted {MAP_SHIFT} m ({t_change:.1f} ms for both); "
        f"localize (20 iterations against {int(vmap.count())} voxels) "
        f"error {e_t * 1e3:.4f} mm / {e_r:.5f} deg in {t_loc:.2f} s; "
        f"reconstruct_surface {len(verts)} vertices, {len(faces)} faces, "
        f"{n_active} active cells in {t_mesh:.2f} s (stage ms, synced: "
        f"{ {k: round(v, 1) for k, v in stages.items()} })")
    say(f"    phase 10 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 11: the registration extras ---------------------------------------
NORMAL_RADIUS = 0.05     # m: estimate_normals and register_cli --gicp's
GRAPH_LEAF = 0.02        # m: graph_cli --voxel
GRAPH_NOISE = 0.001      # m: each graph_cli camera's own sensor noise
MAX_POSE_DEG = 0.25      # graph_cli: every pose within 5 mm and this angle


def synth_discs():
    """The 8 discs of ``oracle.synth_depth_frame(H, W, 0)``, drawn again
    from the frame's seed: (centre u, centre v, radius px, depth mm)."""
    rng = np.random.default_rng(0)
    return [(rng.uniform(0, W), rng.uniform(0, H),
             rng.uniform(0.04, 0.14) * min(H, W), rng.uniform(600, 3200))
            for _ in range(8)]


def disc_plane_mask(xyz: np.ndarray, margin: float) -> np.ndarray:
    """Points of ``oracle.synth_depth_frame(H, W, 0)`` (deprojected at the
    flagship intrinsics) that lie on one of its 8 discs, the planes z = d
    facing the camera, at least ``margin`` m inside the disc's rim and
    outside every later (overwriting) disc's: their analytic normal is
    (0, 0, -1)."""
    discs = synth_discs()
    z = xyz[:, 2]
    u = 421.5 * xyz[:, 0] / z + W / 2.0
    v = 421.1 * xyz[:, 1] / z + H / 2.0
    keep = np.zeros(len(xyz), bool)
    for k, (cu, cv, r, d) in enumerate(discs):
        dz = float(np.uint16(d)) * 0.001
        m_px = margin * 421.5 / dz
        on = ((np.abs(z - dz) < 1e-4)
              & (np.hypot(u - cu, v - cv) < r - m_px))
        for cu2, cv2, r2, _ in discs[k + 1:]:
            on &= np.hypot(u - cu2, v - cv2) > r2 + m_px
        keep |= on
    return keep


def run_cli(module: str, args) -> str:
    """One of the port's CLIs run in this process through its ``main``, as
    ``python -m`` runs it; returns what it printed."""
    import contextlib
    import importlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(
            f"pointcloud_stitching_tpu_torch.tools.{module}").main(
                [str(a) for a in args])
    check(rc in (None, 0), f"{module} exited with {rc}:\n{buf.getvalue()}")
    return buf.getvalue()


def recording(module: str, name: str):
    """Context manager: every call that ``module`` makes through its
    global ``name`` goes on as before and its arguments are kept, so that
    a kernel can be held against its plain version on exactly the inputs
    an entry point gave it."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        mod = sys.modules[module]
        real = getattr(mod, name)
        calls = []

        def rec(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)

        setattr(mod, name, rec)
        try:
            yield calls
        finally:
            setattr(mod, name, real)
    return cm()


def k2_on_calls(calls, tag: str) -> str:
    """K2 on each recorded ``segment_sum_sorted(vals, seg, capacity)``:
    'cuda' against 'torch' bit for bit, and against what the entry point
    got; timed in turns, with the library call (``index_add_`` into
    capacity + 1 rows, as phase 3 times it) beside. Returns the phase
    line's part."""
    import torch
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import \
        segment_sum_sorted
    check(calls, f"{tag}: no segment_sum_sorted call recorded")
    parts = []
    for (v, s, c), _ in calls:
        g = segment_sum_sorted(v, s, c, impl="cuda")
        w = segment_sum_sorted(v, s, c, impl="torch")
        torch.cuda.synchronize()
        check(torch.equal(g, w), f"K2 {tag} {tuple(v.shape)} -> {c}: sums "
              f"differ from plain by up to {(g - w).abs().max().item()}")
        jumps = int((s[1:] - s[:-1] > 1).sum())
        ms, pms, _ = time_in_turns(
            lambda: segment_sum_sorted(v, s, c, impl="cuda"),
            lambda: segment_sum_sorted(v, s, c, impl="torch"))
        lib_out = torch.zeros((c + 1, v.shape[1]), dtype=torch.float32,
                              device=v.device)
        lib_ms = cuda_ms(lambda: lib_out.zero_().index_add_(0, s, v), 20)
        b_ms, _ = bound(nbytes(v, s, g), v.numel())
        parts.append(f"{tuple(v.shape)} -> {c} slots ({jumps} id jumps, "
                     f"{int((s == c - 1).sum())} rows in slot {c - 1}): "
                     f"bitwise equal to plain, kernel "
                     f"{ms:.4f} ms, plain {pms:.4f} ms, index_add_ "
                     f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms")
    return f"K2 ({tag}) " + "; ".join(parts)


def synced_s(fn):
    """(result, seconds) of one synced call."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def extras_phase(dev, kb, card) -> None:
    """Phase 11: the registration extras at the registration cell's width
    (phase 7's clouds, 113,301 points in 131,072 slots)."""
    import tempfile

    import torch
    import oracle
    from pointcloud_stitching_tpu_torch.io import (load_cal, project_pixels,
                                                   projection_bounds,
                                                   render_indexed, save_cal,
                                                   save_ply)
    from pointcloud_stitching_tpu_torch.ops import (estimate_normals, gicp,
                                                    iss_keypoints, ndt, vfh)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sc = registration_scene(dev)
    src, dst, n_src, T_true = sc.src, sc.dst, sc.n_src, sc.T_true
    valid = src.xyz[src.mask].cpu().numpy()

    def point_err(T, T_ref) -> float:
        got = oracle.transform_np(np.asarray(T, np.float32), valid)
        return float(np.linalg.norm(
            got - oracle.transform_np(T_ref, valid), axis=-1).max())

    # (a) normals of both clouds; the discs' planes against (0, 0, -1)
    (ns, oks), t_ns = synced_s(lambda: estimate_normals(src, NORMAL_RADIUS))
    (nd, okd), t_nd = synced_s(lambda: estimate_normals(dst, NORMAL_RADIUS))
    syncs_n = count_syncs(lambda: estimate_normals(src, NORMAL_RADIUS))
    on_plane = disc_plane_mask(valid, NORMAL_RADIUS + 0.02)
    m_src = src.mask.cpu().numpy()
    check(on_plane.sum() > 1000, f"only {on_plane.sum()} disc points")
    ok_np = oks.cpu().numpy()[m_src]
    n_np = ns.cpu().numpy()[m_src]
    check(ok_np[on_plane].all(), "a disc point has no normal")
    dots = -n_np[on_plane, 2]
    check(dots.min() > 0.9999, f"disc normals off by up to "
          f"{np.degrees(np.arccos(dots.min())):.3f} deg")
    R_true = oracle.random_se3(seed=3, max_angle=0.05,
                               max_trans=0.05)[:3, :3]
    want_d = np.array([0.0, 0.0, -1.0], np.float32) @ R_true.T
    dots_d = np.abs(nd.cpu().numpy()[m_src][on_plane] @ want_d)
    check(dots_d.min() > 0.999, f"moved disc normals off by up to "
          f"{np.degrees(np.arccos(dots_d.min())):.3f} deg")
    say(f"[11/15 extras] {card}: (a) estimate_normals r {NORMAL_RADIUS} m, "
        f"{n_src} points: {t_ns * 1e3:.1f} / {t_nd * 1e3:.1f} ms (src / "
        f"dst), supported {int(oks.sum())} / {int(okd.sum())}, host syncs "
        f"{syncs_n}; {int(on_plane.sum())} disc points: normals within "
        f"{np.degrees(np.arccos(min(dots.min(), 1.0))):.4f} deg of "
        f"(0, 0, -1), moved within "
        f"{np.degrees(np.arccos(min(dots_d.min(), 1.0))):.4f} deg")

    T_glob = oracle.random_se3(seed=0, max_angle=2.0, max_trans=0.3)
    dst_g = sc.moved(T_glob)
    angle = np.degrees(np.arccos((np.trace(T_glob[:3, :3]) - 1) / 2))
    with tempfile.TemporaryDirectory() as tmp:
        sp, dp, dsp = (os.path.join(tmp, f) for f in ("s.ply", "g.ply",
                                                       "d.ply"))
        save_ply(sp, valid)
        save_ply(dp, dst_g.xyz[dst_g.mask].cpu().numpy())
        save_ply(dsp, dst.xyz[dst.mask].cpu().numpy())

        # (b) register_cli --global with FPFH starts (the phase's counted
        # run: every kernel launch of the CLI's process from here)
        cal = os.path.join(tmp, "b.cal")
        kb.reset_launches()
        out_b, t_b = synced_s(lambda: run_cli("register_cli", [
            sp, dp, cal, "--global", "--fpfh-starts", 64, "--prune"]))
        launches = dict(kb.LAUNCHES)
        T_b = load_cal(cal)
        err_b = point_err(T_b, T_glob)
        check(err_b < MAX_REG_ERR, f"--fpfh-starts 64 error {err_b} m")
        for k in ("segment_sum_from_flags", "nn_batched_prepared",
                  "nn_batched_prepared_ranged"):
            check(launches.get(k, 0) > 0, f"(b) launched no {k}: {launches}")
        _, t_b2 = synced_s(lambda: run_cli("register_cli", [
            sp, dp, cal, "--global", "--starts", 1, "--fpfh-starts", 32,
            "--prune"]))
        err_b2 = point_err(load_cal(cal), T_glob)
        check(err_b2 < MAX_REG_ERR, f"--starts 1 --fpfh-starts 32 error "
              f"{err_b2} m")
        icp_line = [ln for ln in out_b.splitlines() if ln.startswith("ICP")]
        say(f"    (b) register_cli --global --fpfh-starts 64 --prune, "
            f"{angle:.1f} deg misalignment: max point error "
            f"{err_b * 1e3:.4f} mm, {t_b:.2f} s ({' '.join(icp_line)}); "
            f"launches {launches}; --starts 1 --fpfh-starts 32 (FPFH "
            f"starts alone): {err_b2 * 1e3:.4f} mm, {t_b2:.2f} s")

        # (c) --gicp on top of (b), end to end; then GICP alone timed
        out_c, t_c = synced_s(lambda: run_cli("register_cli", [
            sp, dp, cal, "--global", "--fpfh-starts", 64, "--prune",
            "--gicp", "--gicp-normal-radius", NORMAL_RADIUS]))
        err_c = point_err(load_cal(cal), T_glob)
        check(err_c < MAX_REG_ERR, f"--gicp error {err_c} m")
        gline = [ln for ln in out_c.splitlines() if ln.startswith("GICP")]
        T0 = torch.from_numpy(T_b).to(dev)
        ng, okg = estimate_normals(dst_g, NORMAL_RADIUS)
        # 10 iterations at epsilon 0 (from a converged pose GICP stops
        # after one or two)
        kw = dict(init_T=T0, max_iterations=10, transformation_epsilon=0.0)
        g, t_g = synced_s(lambda: gicp(src, dst_g, ns, ng, oks, okg, **kw))
        it_g = int(g.iterations)
        syncs_g = count_syncs(lambda: gicp(src, dst_g, ns, ng, oks, okg,
                                           **kw))
        err_g = point_err(g.T.cpu().numpy(), T_glob)
        say(f"    (c) register_cli ... --gicp: max point error "
            f"{err_c * 1e3:.4f} mm, {t_c:.2f} s ({' '.join(gline)}); gicp "
            f"from (b)'s pose, epsilon 0: {it_g} iterations, "
            f"{t_g * 1e3 / max(it_g, 1):.2f} ms and "
            f"{syncs_g / max(it_g, 1):.1f} host syncs per iteration, error "
            f"{err_g * 1e3:.4f} mm")

        # (d) NDT of the moved cloud (0.05 rad / 5 cm) from identity; K2
        # then held against its plain version on the build's own inputs,
        # and the whole entry point run again on the plain route
        kb.reset_launches()
        with recording("pointcloud_stitching_tpu_torch.ops.ndt",
                       "segment_sum_sorted") as k2_ndt:
            r, t_ndt = synced_s(lambda: ndt(src, dst, 0.5))
        launches_ndt = dict(kb.LAUNCHES)
        check(launches_ndt == {"segment_sum_sorted": 2},
              f"ndt launches {launches_ndt}")
        err_ndt = point_err(r.T.cpu().numpy(), T_true)
        check(np.isfinite(err_ndt) and err_ndt < 0.02,
              f"ndt error {err_ndt} m")
        k2_line = k2_on_calls(k2_ndt, "ndt_build")
        del k2_ndt
        r_plain = ndt(src, dst, 0.5, impl="torch")
        check(torch.equal(r.T, r_plain.T)
              and int(r.iterations) == int(r_plain.iterations),
              "ndt through K2 differs from ndt on the plain route")
        say(f"    (d) ndt, 0.5 m cells, from identity: error "
            f"{err_ndt * 1e3:.4f} mm (start "
            f"{point_err(np.eye(4), T_true) * 1e3:.1f} mm), "
            f"{int(r.iterations)} iterations, {t_ndt * 1e3:.1f} ms; "
            f"launches {launches_ndt}; T bitwise equal to impl='torch'; "
            f"{k2_line}")

        # (f) pick_cli --pairs into register_cli --picks: four points that
        # win their pixel in both orthographic views
        dst_np = dst.xyz[dst.mask].cpu().numpy()
        size = 800
        seen = [np.unique(render_indexed(x, size=size)[1]) for x in
                (valid, dst_np)]
        both = np.intersect1d(seen[0][seen[0] >= 0], seen[1][seen[1] >= 0])
        corners = [both[np.argmin(valid[both] @ np.array(d, np.float32))]
                   for d in ((1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0))]
        spx = project_pixels(valid[corners], "z", size,
                             projection_bounds(valid))
        dpx = project_pixels(dst_np[corners], "z", size,
                             projection_bounds(dst_np))
        pairs = " ".join(f"{a},{b}:{c},{d}" for (a, b), (c, d)
                         in zip(spx, dpx))
        picks, cal_f = os.path.join(tmp, "picks.txt"), os.path.join(
            tmp, "f.cal")
        run_cli("pick_cli", [sp, dsp, picks, "--size", size, "--pairs",
                             pairs, "--radius", 0])
        got = np.loadtxt(picks, dtype=np.int64).reshape(-1, 2)
        check(np.array_equal(got, np.stack([corners, corners], 1)),
              f"pick_cli picked {got.tolist()}, want {corners}")
        run_cli("register_cli", [sp, dsp, cal_f, "--picks", picks,
                                 "--prune"])
        err_f = point_err(load_cal(cal_f), T_true)
        check(err_f < MAX_REG_ERR, f"pick -> register error {err_f} m")
        say(f"    (f) pick_cli --pairs (4 corners, {size} px views) -> "
            f"register_cli --picks --prune: picks {got[:, 0].tolist()}, "
            f"max point error {err_f * 1e3:.4f} mm")

        # (e) graph_cli --ply-dir over the stream rig's 8 poses. Phase 9's
        # frames are 8 unrelated synthetic scenes (no shared geometry to
        # register), so each camera sees this phase's scene instead: a
        # random 70% of src's points with its own 1 mm sensor noise (no
        # two cameras share a sample), in the camera's own frame
        _, ext = stream_rig()
        ply_dir, init_dir = (os.path.join(tmp, d) for d in ("ply", "init"))
        os.makedirs(ply_dir)
        os.makedirs(init_dir)
        init = ext.copy()
        for k in range(NCAM):
            rng_k = np.random.default_rng(200 + k)
            seen = rng_k.random(len(valid)) < 0.7
            noisy = valid[seen] + rng_k.normal(
                0.0, GRAPH_NOISE, (int(seen.sum()), 3)).astype(np.float32)
            save_ply(os.path.join(ply_dir, f"cam_{k}.ply"),
                     oracle.transform_np(np.linalg.inv(ext[k]), noisy))
            if k:
                init[k] = ext[k] @ oracle.random_se3(
                    seed=100 + k, max_angle=0.02, max_trans=0.02)
            save_cal(os.path.join(init_dir, f"cam_{k}.cal"), init[k])
        edges = ([(i, (i + 1) % NCAM) for i in range(NCAM)]
                 + [(i, i + 2) for i in range(0, NCAM - 2, 2)])
        edges_file = os.path.join(tmp, "edges.txt")
        with open(edges_file, "w") as f:
            f.writelines(f"{i} {j}\n" for i, j in edges)
        out_dir = os.path.join(tmp, "out")
        kb.reset_launches()
        with recording("pointcloud_stitching_tpu_torch.ops.voxel",
                       "segment_sum_sorted") as k2_graph:
            out_e, t_e = synced_s(lambda: run_cli("graph_cli", [
                edges_file, out_dir, "--ply-dir", ply_dir, "--init-dir",
                init_dir, "--voxel", GRAPH_LEAF, "--max-corr-dist", 0.1,
                "--icp-iter", 30, "--iterations", 10]))
        launches_e = dict(kb.LAUNCHES)
        k2_line = k2_on_calls(k2_graph, "graph_cli --voxel")
        del k2_graph
        errs = [pose_error(load_cal(os.path.join(out_dir, f"cam_{k}.cal")),
                           ext[k]) for k in range(NCAM)]
        errs0 = [pose_error(init[k], ext[k]) for k in range(NCAM)]
        e_t, e_r = max(e[0] for e in errs), max(e[1] for e in errs)
        check(e_t < MAX_REG_ERR and e_r < MAX_POSE_DEG,
              f"graph_cli poses off by up to {e_t} m / {e_r} deg")
        say(f"    (e) graph_cli --ply-dir, {NCAM} cameras, {len(edges)} "
            f"edges (ring + chords), --voxel {GRAPH_LEAF}: poses within "
            f"{e_t * 1e3:.4f} mm / {e_r:.4f} deg (start "
            f"{max(e[0] for e in errs0) * 1e3:.1f} mm / "
            f"{max(e[1] for e in errs0):.3f} deg), {t_e:.2f} s; "
            f"{out_e.splitlines()[0]}; launches {launches_e}; {k2_line}")

    # (g) ISS keypoints and VFH of one cloud
    leaf = sc.leaf
    (kp, sal), t_iss = synced_s(lambda: iss_keypoints(
        src, salient_radius=6 * leaf, non_max_radius=4 * leaf))
    (desc, ok_v), t_vfh = synced_s(lambda: vfh(src, ns, oks))
    check(0 < int(kp.sum()) < n_src and bool(ok_v)
          and bool(torch.isfinite(desc).all()), "iss / vfh failed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    say(f"    (g) iss_keypoints (salient {6 * leaf:.4f} m, non-max "
        f"{4 * leaf:.4f} m): {int(kp.sum())} keypoints in "
        f"{t_iss * 1e3:.1f} ms; vfh {t_vfh * 1e3:.2f} ms; peak memory "
        f"{peak:.1f} MiB")
    say(f"    phase 11 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 12: the analysis ops ---------------------------------------------
RANSAC_M = 1024          # hypotheses (segment_plane's default)
PLANE_THR = 0.01         # m: segment_plane and both CLIs' --drop-plane
DROP_FRAMES = 30         # stitch_cli runs of (b)
G_FRAMES = 5             # the traced stitch_cli run of (g)
G_VIEW_EVERY = 2
# s: the staleness limit of stitch_cli's client in (b) and (g). The client's
# 0.5 s default drops a camera whose newest frame is older than that, and
# with the view and the profiler on, a healthy loopback camera's frame comes
# near it (scripts/check_stale_ages.py measures how near); a frame stitched
# without a camera is not the direct call's cloud. No live loopback camera
# ages this far.
CLI_STALE_S = 30.0
CLUSTER_TOL = 0.05       # m: euclidean_clusters, the exact clusterers
SKELETON_LEAF = 0.02     # m: the exact clusterers' skeleton
SKELETON_CAP = 16384
SMOOTH_DEG = 20.0        # region_growing
FILTER_CROP = 8192       # slots of the crop both devices sweep in (c)
CLUSTER_CROP = 2048      # slots of the crop both devices sweep in (d)
SAMPLED = 256            # queries recounted with numpy at full size in (c)


def cloud_to(pc, dev):
    from pointcloud_stitching_tpu_torch import PointCloud
    return PointCloud(xyz=pc.xyz.to(dev), mask=pc.mask.to(dev),
                      rgb=None if pc.rgb is None else pc.rgb.to(dev))


def component_labels(xyz, valid, tol, k, normals=None, cos_thr=None):
    """Independent labels of the exact clusterers at full size: scipy's
    connected components of the radius graph, each edge decided as the
    port decides it in float32 (d2 summed x, y, z <= tol^2; with normals
    |n_i . n_j| >= cos_thr), ranked by size, ties to the lower root (the
    lowest index of a component), the top ``k`` labelled."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    idx = np.nonzero(valid)[0]
    p = xyz[idx]
    pairs = cKDTree(p.astype(np.float64)).query_pairs(
        float(tol) * (1 + 1e-4), output_type="ndarray")
    d = p[pairs[:, 0]] - p[pairs[:, 1]]
    keep = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            <= np.float32(tol) * np.float32(tol))
    if normals is not None:
        a, b = normals[idx[pairs[:, 0]]], normals[idx[pairs[:, 1]]]
        keep &= np.abs((a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])
                       + a[:, 2] * b[:, 2]) >= cos_thr
    e = pairs[keep]
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                   shape=(len(idx), len(idx)))
    _, comp = connected_components(g, directed=False)
    sizes = np.bincount(comp)
    root = np.full(len(sizes), len(xyz), np.int64)
    np.minimum.at(root, comp, idx)
    order = np.lexsort((root, -sizes))[:k]
    rank = np.full(len(sizes), -1, np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    out = np.full(len(xyz), -1, np.int32)
    out[idx] = rank[comp]
    return out


def disc_check(src, thr) -> str:
    """segment_plane on a window around the largest visible disc of the
    registration cloud (its pixels within 1.2 disc radii): the disc is
    most of the window, so the plane must be the disc's, z = its depth.
    On the whole cloud each disc holds a few percent of the points, which
    RANSAC_M hypotheses rarely hit. Returns the phase line's part."""
    import torch
    from pointcloud_stitching_tpu_torch.ops import segment_plane
    from pointcloud_stitching_tpu_torch.utils import prng
    xyz = src.xyz.cpu().numpy()
    valid = src.mask.cpu().numpy()
    z = np.where(valid, xyz[:, 2], 1.0)
    u = 421.5 * xyz[:, 0] / z + W / 2.0
    v = 421.1 * xyz[:, 1] / z + H / 2.0
    best = None
    for cu, cv, r, dd in synth_discs():
        dz = float(np.uint16(dd)) * 0.001
        on = valid & (np.abs(z - dz) < 1e-4) & (np.hypot(u - cu, v - cv) < r)
        if best is None or on.sum() > best[0].sum():
            best = (on, cu, cv, r, dz)
    on, cu, cv, r, dz = best
    win = valid & (np.hypot(u - cu, v - cv) < 1.2 * r)
    model, inl, cnt = segment_plane(
        src.replace(mask=torch.from_numpy(win).to(src.xyz.device)), thr,
        prng.key(0, device=src.xyz.device))
    m = model.cpu().double().numpy()
    tilt = float(np.degrees(np.arccos(min(abs(m[2]), 1.0))))
    depth = -m[3] / m[2]
    got = inl.cpu().numpy()
    check(tilt < 0.5 and abs(depth - dz) < 1e-3 and got[on].all(),
          f"(a) the window's plane is not the disc at {dz} m: tilt {tilt} "
          f"deg, z = {depth}, {int(got[on].sum())} of {int(on.sum())} "
          "disc points")
    return (f"; in a window around the largest disc ({int(on.sum())} "
            f"disc points of {int(win.sum())}) the plane is the disc: "
            f"normal {tilt:.4f} deg off z, z = {depth:.5f} m against "
            f"{dz:.3f}, every disc point an inlier ({int(cnt)} inliers)")


def patient_client(live: list | None = None):
    """Make stitch_cli's client keep every live camera (``CLI_STALE_S``)
    and, given a list ``live``, record in it how many cameras each
    snapshot took. Returns a function that undoes it."""
    from pointcloud_stitching_tpu_torch.runtime import client as CL
    real_init, real_snapshot = (CL.MulticameraClient.__init__,
                                CL.MulticameraClient._snapshot)

    def patient_init(self, *a, **kw):
        real_init(self, *a, **{**kw, "stale_timeout": CLI_STALE_S})

    def counted_snapshot(self, *a, **kw):
        stage, n = real_snapshot(self, *a, **kw)
        if live is not None:
            live.append(n)
        return stage, n

    CL.MulticameraClient.__init__ = patient_init
    CL.MulticameraClient._snapshot = counted_snapshot

    def undo():
        CL.MulticameraClient.__init__ = real_init
        CL.MulticameraClient._snapshot = real_snapshot
    return undo


def analysis_phase(dev, kb, card):
    """Phase 12: the analysis ops on phase 7's 113k-point cloud and the
    flagship's 262,144-slot output of phase 9's rig, and the stitch CLI's
    remaining options on phase 9's loopback rig. Returns the kernels'
    launches in (b)'s ``stitch_cli --drop-plane`` run, the draws' main
    path, and the flagship output."""
    import contextlib
    import filecmp
    import io
    import socket
    import tempfile
    import threading

    import torch
    from pointcloud_stitching_tpu_torch import (Intrinsics, PointCloud,
                                                StitchConfig,
                                                StitchingPipeline)
    from pointcloud_stitching_tpu_torch.io import load_ply, save_ply
    from pointcloud_stitching_tpu_torch.ops import (
        cluster_stats, concave_hull, convex_hull, crop_hull,
        estimate_normals, euclidean_clusters, euclidean_clusters_exact,
        extract_plane, frustum_cull, knn_mean_distance, oriented_bboxes,
        passthrough, radius_outlier_removal, region_growing, segment_plane,
        statistical_outlier_removal, voxel_downsample)
    from pointcloud_stitching_tpu_torch.ops import hull as HL
    from pointcloud_stitching_tpu_torch.runtime import (
        Codec, FakeCameraServer, Kind, recv_frame, stitch_cli, wire)
    from pointcloud_stitching_tpu_torch.runtime import publisher as PUB
    from pointcloud_stitching_tpu_torch.tools import segment_cli
    from pointcloud_stitching_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    sc = registration_scene(dev)
    src, n_src = sc.src, sc.n_src
    src_cpu = cloud_to(src, cpu)
    frames, ext = stream_rig()
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    pipe = StitchingPipeline(flagship_cfg(StitchConfig),
                             i0.stack([i0] * (NCAM - 1)), ext, device=dev)
    d_rig = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    flag = pipe(d_rig).cloud
    del pipe

    # (a) segment_plane on both clouds from key 0 on each device: the
    # card's draws and plane against the CPU's, then timed
    planes = {}
    for tag, pc in (("113k", src), ("flagship", flag)):
        key_d, key_c = prng.key(0, device=dev), prng.key(0)
        p = pc.mask.to(torch.float32)
        p = p / torch.clamp(p.sum(), min=1.0)
        check(torch.equal(
            prng.choice(key_d, p.shape[0], (RANSAC_M, 3), p=p).cpu(),
            prng.choice(key_c, p.shape[0], (RANSAC_M, 3), p=p.cpu())),
            f"(a) {tag}: the card's draws differ from the CPU's")
        got = segment_plane(pc, PLANE_THR, key_d)
        want = segment_plane(cloud_to(pc, cpu), PLANE_THR, key_c)
        m_err = float((got[0].cpu() - want[0]).abs().max())
        check(m_err <= 1e-5, f"(a) {tag}: CUDA model differs from the "
                             f"CPU's by {m_err}")
        xyz64 = pc.xyz.cpu().double().numpy()
        m64 = want[0].double().numpy()
        dist = np.abs(xyz64 @ m64[:3] + m64[3])
        edge = (np.abs(dist - PLANE_THR) < 1e-6) & pc.mask.cpu().numpy()
        diff = (got[1].cpu() != want[1]).numpy()
        check(not (diff & ~edge).any(), f"(a) {tag}: inlier masks differ "
              f"at {int((diff & ~edge).sum())} points off the threshold")
        run = lambda: segment_plane(pc, PLANE_THR, key_d)  # noqa: E731
        model, inl, cnt = run()
        ms = median_ms(run, 10)
        syncs = count_syncs(run)
        model_np = model.cpu().double().numpy()
        resid = np.abs(xyz64 @ model_np[:3] + model_np[3])[
            inl.cpu().numpy()]
        check(int(cnt) > 100 and resid.max() <= PLANE_THR + 1e-6,
              f"(a) {tag}: {int(cnt)} inliers, worst {resid.max()} m")
        line = ""
        if tag == "113k":
            line = disc_check(pc, PLANE_THR)
        planes[tag] = model
        say(f"[12/15 analysis] {card}: (a) segment_plane {tag} "
            f"({pc.capacity} slots, {int(pc.mask.sum())} valid), "
            f"{RANSAC_M} hypotheses, {PLANE_THR} m: {int(cnt)} inliers, "
            f"all within the threshold{line}; {ms:.3f} ms per call "
            f"(median of 10), {syncs} host syncs; on key 0 CUDA = CPU: the "
            f"same {RANSAC_M} x 3 draws, model within {m_err:.2g}, inlier "
            f"masks equal "
            f"({int(edge.sum())} points within 1e-6 m of the threshold, "
            f"{int(diff.sum())} differ)")

    servers = [FakeCameraServer(f, codec=Codec.SNAPPY).start()
               for f in frames]
    cams = sum((["--camera", f"127.0.0.1:{srv.port}"] for srv in servers),
               [])
    # (b) and (g) compare each frame with the direct call on all NCAM
    # cameras
    live = []
    undo_client = patient_client(live)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (b) stitch_cli --drop-plane against a run without the flag,
            # in this process (the launch counters are read around each)
            base = cams + ["--height", str(H), "--width", str(W),
                           "--frames", str(DROP_FRAMES), "--print-every",
                           "0", "--save-every", "10"]
            runs = {}
            for tag, extra in (("without", []),
                               ("--drop-plane", ["--drop-plane",
                                                 str(PLANE_THR)])):
                out = os.path.join(tmp, tag.strip("-"))
                kb.reset_launches()
                live.clear()
                with contextlib.redirect_stdout(io.StringIO()):
                    m = stitch_cli._run(base + ["--save-dir", out] + extra)
                torch.cuda.synchronize()
                check(live and min(live) == NCAM,
                      f"(b) {tag}: live cameras at each snapshot {live}")
                runs[tag] = (m, dict(kb.LAUNCHES), out)
            # the reference: the CLI's pipeline (default config, nominal
            # D435 intrinsics, identity poses) called directly
            i_d = Intrinsics.d435_default(width=W, height=H, device=dev)
            ref = StitchingPipeline(
                StitchConfig(num_cameras=NCAM, height=H, width=W),
                i_d.stack([i_d] * (NCAM - 1)),
                np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1)),
                device=dev)(d_rig).cloud
            model, _, cnt = segment_plane(ref, PLANE_THR,
                                          prng.key(0, device=dev))
            kept = extract_plane(ref, model, PLANE_THR)
            wants = {"without": ref.xyz[ref.mask].cpu().numpy(),
                     "--drop-plane": kept.xyz[kept.mask].cpu().numpy()}
            parts = []
            for tag, (m, launches, out) in runs.items():
                plys = sorted(os.listdir(out))
                check(len(plys) == DROP_FRAMES // 10, f"(b) {tag}: {plys}")
                for f in plys:
                    xyz, _ = load_ply(os.path.join(out, f))
                    check(np.array_equal(xyz, wants[tag]),
                          f"(b) {tag}: {f} differs from the direct call")
                # one draw a frame: one threefry2x32 and one scan16
                draws = DROP_FRAMES if tag == "--drop-plane" else 0
                check(launches.get("segment_sum_from_flags") == DROP_FRAMES
                      and launches.get("nn_batched_prepared")
                      == 5 * DROP_FRAMES
                      and launches.get("threefry2x32", 0) == draws
                      and launches.get("scan16", 0) == draws,
                      f"(b) {tag}: launches {launches}")
                parts.append(f"{tag}: fps {m.fps:.2f}, latency p50 "
                             f"{m.latency_ms(50):.2f} p99 "
                             f"{m.latency_ms(99):.2f} ms, {len(wants[tag])} "
                             f"points saved, launches {launches}")
            say(f"    (b) stitch_cli, {NCAM} x {H}x{W} snappy loopback, "
                f"{DROP_FRAMES} frames, every saved cloud bitwise equal to "
                f"the direct call (and segment_plane/extract_plane from "
                f"key 0, {int(cnt)} inliers): " + "; ".join(parts))

            # (g) --publish-port with a subscriber, --view into a directory
            # (no display here) and --trace-dir, in one run; the publisher
            # holds the first frame until the subscriber is in
            with socket.socket() as so:
                so.bind(("127.0.0.1", 0))
                port = so.getsockname()[1]
            got_frames, sub_err = [], []

            def subscribe():
                for _ in range(3000):
                    try:
                        conn = socket.create_connection(("127.0.0.1", port),
                                                        timeout=30)
                        break
                    except ConnectionRefusedError:
                        time.sleep(0.005)
                else:
                    sub_err.append("no publisher")
                    return
                with conn:
                    while len(got_frames) < G_FRAMES:
                        try:
                            kind, _, payload = recv_frame(conn)
                        except (ConnectionError, OSError, EOFError) as e:
                            sub_err.append(repr(e))
                            return
                        if kind == Kind.POINTS_I16MM:
                            got_frames.append(payload[0])

            real_start = PUB.CloudPublisher.start

            def start_and_wait(self):
                real_start(self)
                t_w = time.perf_counter()
                while not self.num_subscribers:
                    check(time.perf_counter() - t_w < 30,
                          "(g) no subscriber came")
                    time.sleep(0.002)
                return self

            sub = threading.Thread(target=subscribe, daemon=True)
            sub.start()
            view_dir, trace_dir = (os.path.join(tmp, x) for x in
                                   ("view", "trace"))
            PUB.CloudPublisher.start = start_and_wait
            env_display = {k: os.environ.pop(k) for k in
                           ("DISPLAY", "WAYLAND_DISPLAY") if k in os.environ}
            live.clear()
            try:
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    m = stitch_cli._run(
                        cams + ["--height", str(H), "--width", str(W),
                                "--frames", str(G_FRAMES), "--print-every",
                                "0", "--save-dir", os.path.join(tmp, "g"),
                                "--publish-port", str(port), "--view",
                                "--view-dir", view_dir, "--view-every",
                                str(G_VIEW_EVERY),
                                "--trace-dir", trace_dir])
                t_g = time.perf_counter() - t
            finally:
                PUB.CloudPublisher.start = real_start
                os.environ.update(env_display)
            sub.join(timeout=60)
            check(not sub.is_alive() and not sub_err,
                  f"(g) subscriber: {sub_err}")
            check(live and min(live) == NCAM,
                  f"(g) live cameras at each snapshot {live}")
            packed, _ = wire.unpack_points_i16mm(
                wire.pack_points_i16mm(wants["without"]))
            same = [np.array_equal(x, packed) for x in got_frames]
            check(len(got_frames) == G_FRAMES and all(same),
                  f"(g) the subscriber got {len(got_frames)} frames, equal "
                  f"to the saved cloud {same}, of "
                  f"{[len(x) for x in got_frames]} points against "
                  f"{len(packed)}")
            images = sorted(os.listdir(view_dir))
            check(len(images) == -(-G_FRAMES // G_VIEW_EVERY) + 1,
                  f"(g) the view wrote {images}")
            trace_file = os.path.join(trace_dir, "trace.json")
            with open(trace_file) as f:
                trace_text = f.read()
            for kname in ("segsum_flags_kernel", "nn_batched_split"):
                check(kname in trace_text, f"(g) the trace names no "
                                           f"{kname}")
            say(f"    (g) stitch_cli --publish-port --view --view-every "
                f"{G_VIEW_EVERY} "
                f"--trace-dir, {G_FRAMES} frames in {t_g:.1f} s (fps "
                f"{m.fps:.2f} under the profiler): the subscriber got "
                f"{len(got_frames)} of {G_FRAMES} frames, each the saved "
                f"cloud in int16 mm ({len(packed)} points); the view wrote "
                f"{len(images)} images ({images[0]} ... {images[-1]}); "
                f"trace.json {os.path.getsize(trace_file) / 2**20:.1f} MiB "
                f"names segsum_flags_kernel (K1) and nn_batched_split (K3)")
    finally:
        undo_client()
        for srv in servers:
            srv.stop()

    # (c) filters on the 113k cloud
    fr_i = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                             width=W, height=H)
    cuts = {"passthrough": lambda pc: passthrough(pc, 2, 0.5, 2.0),
            "frustum_cull": lambda pc: frustum_cull(
                pc, fr_i if pc.xyz.device == cpu else fr_i.to(dev),
                ext[0], z_min=0.3, z_max=3.0)}
    parts = []
    for name, fn in cuts.items():
        got, t_f = synced_s(lambda: fn(src))
        want = fn(src_cpu)
        check(torch.equal(got.mask.cpu(), want.mask), f"(c) {name}: CUDA "
                                                      "differs from CPU")
        parts.append(f"{name} {int(got.mask.sum())} kept, "
                     f"{t_f * 1e3:.2f} ms")
    ror, t_ror = synced_s(lambda: radius_outlier_removal(src, 0.02, 4))
    md, t_md = synced_s(lambda: knn_mean_distance(src, 16))
    sor, t_sor = synced_s(lambda: statistical_outlier_removal(src, 16))
    # full size: SAMPLED queries recounted with numpy (float32, the
    # port's order), and the SOR threshold from md in float64
    xyz = src.xyz.cpu().numpy()
    valid = src.mask.cpu().numpy()
    rows = np.random.default_rng(12).choice(np.nonzero(valid)[0], SAMPLED,
                                            replace=False)
    dq = xyz[rows][:, None, :] - xyz[None, valid, :]
    d2 = (dq[..., 0] * dq[..., 0] + dq[..., 1] * dq[..., 1]) \
        + dq[..., 2] * dq[..., 2]
    counts = (d2 <= np.float32(0.02) * np.float32(0.02)).sum(1) - 1
    check(np.array_equal(ror.mask.cpu().numpy()[rows], counts >= 4),
          "(c) ROR differs from the recount at sampled points")
    knn = np.sqrt(np.sort(d2, axis=1)[:, 1:17]).mean(1)
    md_np = md.cpu().numpy()
    md_err = float(np.abs(md_np[rows] - knn).max())
    check(md_err <= 1e-6, f"(c) knn_mean_distance off by {md_err}")
    mv = md_np[valid].astype(np.float64)
    thr = mv.mean() + mv.std(ddof=1)
    sor_np = sor.mask.cpu().numpy()
    near = np.abs(md_np - thr) < 1e-6
    check(np.array_equal(sor_np[~near], (valid & (md_np <= thr))[~near]),
          "(c) SOR differs from its threshold away from it")
    # both devices on a crop
    crop = PointCloud(xyz=src.xyz[:FILTER_CROP], mask=src.mask[:FILTER_CROP])
    crop_cpu = cloud_to(crop, cpu)
    for name, fn in (("ROR", lambda pc: radius_outlier_removal(pc, 0.02, 4)),
                     ("SOR", lambda pc: statistical_outlier_removal(pc,
                                                                    16))):
        check(torch.equal(fn(crop).mask.cpu(), fn(crop_cpu).mask),
              f"(c) {name} on the crop: CUDA differs from CPU")
    check(float((knn_mean_distance(crop, 16).cpu()
                 - knn_mean_distance(crop_cpu, 16)).abs().max()) <= 1e-6,
          "(c) knn_mean_distance on the crop: CUDA differs from CPU")
    say(f"    (c) filters, {n_src} points: {'; '.join(parts)} (CUDA = CPU "
        f"masks); ROR (0.02 m, 4) {int(ror.mask.sum())} kept, {t_ror:.3f} "
        f"s; knn_mean_distance (16) {t_md:.3f} s; SOR (16, 1.0) "
        f"{int(sor.mask.sum())} kept, {t_sor:.3f} s; at full size "
        f"{SAMPLED} sampled points recounted with numpy: ROR equal, mean "
        f"distances within {md_err:.2g}, SOR equal to its float64 threshold "
        f"({int(near.sum())} points within 1e-6); on a {FILTER_CROP}-slot "
        f"crop ROR, SOR and the mean distances CUDA = CPU")

    # (d) clusters: the 113k cloud without its plane; the exact clusterers
    # on its 2 cm skeleton
    rest = extract_plane(src, planes["113k"], PLANE_THR)
    rest_cpu = cloud_to(rest, cpu)
    run = lambda: euclidean_clusters(rest, CLUSTER_TOL)  # noqa: E731
    (lab, num, sizes), t_ec = synced_s(run)
    ms_ec = median_ms(run, 5)
    syncs_ec = count_syncs(run)
    want = euclidean_clusters(rest_cpu, CLUSTER_TOL)
    check(all(torch.equal(a.cpu(), b) for a, b in zip((lab, num, sizes),
                                                      want)),
          "(d) euclidean_clusters: CUDA differs from CPU")
    stats = cluster_stats(rest, lab)
    obb = oriented_bboxes(rest, lab)
    obb_cpu = oriented_bboxes(rest_cpu, lab.cpu())
    st_err = max(float((a.cpu() - b).abs().max()) for a, b in
                 zip(stats, cluster_stats(rest_cpu, lab.cpu())))
    ob_err = max(float((obb[i].cpu() - obb_cpu[i]).abs().max())
                 for i in (0, 2))
    ga, wa = obb[1].cpu(), obb_cpu[1]
    sgn = torch.where((ga * wa).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    ax_err = float((ga * sgn - wa).abs().max())
    check(max(st_err, ob_err, ax_err) <= 1e-5, f"(d) stats / OBB: CUDA "
          f"differs from CPU by {st_err} / {ob_err} / {ax_err}")
    skel = voxel_downsample(rest, SKELETON_LEAF, capacity=SKELETON_CAP)
    n_skel = int(skel.count())
    nrm, okn = estimate_normals(skel, 3 * SKELETON_LEAF)
    # region_growing's threshold: cos of the float32 angle, on the host
    cos_thr = np.float32(np.cos(np.float64(np.float32(np.radians(
        SMOOTH_DEG)))))
    exact = lambda: euclidean_clusters_exact(skel, CLUSTER_TOL)  # noqa
    grow = lambda: region_growing(  # noqa: E731
        skel, nrm, CLUSTER_TOL, float(np.radians(SMOOTH_DEG)),
        normals_valid=okn)
    res = {}
    for name, fn in (("exact", exact), ("region_growing", grow)):
        out, t_c = synced_s(fn)
        syncs = count_syncs(fn)
        res[name] = (out, t_c, syncs)
    sk_xyz = skel.xyz.cpu().numpy()
    sk_valid = skel.mask.cpu().numpy()
    want_ex = component_labels(sk_xyz, sk_valid, CLUSTER_TOL, 16)
    want_rg = component_labels(sk_xyz, sk_valid & okn.cpu().numpy(),
                               CLUSTER_TOL, 16, nrm.cpu().numpy(),
                               cos_thr)
    for name, want_l in (("exact", want_ex), ("region_growing", want_rg)):
        got_l = res[name][0][0].cpu().numpy()
        check(np.array_equal(got_l, want_l), f"(d) {name}: labels differ "
              f"from scipy's components at {int((got_l != want_l).sum())} "
              "points")
    cc = slice(0, CLUSTER_CROP)
    sk_crop = PointCloud(xyz=skel.xyz[cc], mask=skel.mask[cc])
    for name, fn in (
            ("exact", lambda pc, nn, ok: euclidean_clusters_exact(
                pc, CLUSTER_TOL)),
            ("region_growing", lambda pc, nn, ok: region_growing(
                pc, nn, CLUSTER_TOL, float(np.radians(SMOOTH_DEG)),
                normals_valid=ok))):
        g = fn(sk_crop, nrm[cc], okn[cc])
        w = fn(cloud_to(sk_crop, cpu), nrm[cc].cpu(), okn[cc].cpu())
        check(all(torch.equal(a.cpu(), b) for a, b in zip(g, w)),
              f"(d) {name} on the crop: CUDA differs from CPU")
    say(f"    (d) euclidean_clusters ({CLUSTER_TOL} m) on the "
        f"{int(rest.mask.sum())} points off the plane: {int(num)} clusters "
        f"(sizes {sizes.cpu().tolist()[:int(num)]}), {ms_ec:.2f} ms "
        f"(median of 5; first {t_ec * 1e3:.1f}), {syncs_ec} host syncs, "
        f"CUDA = CPU; cluster_stats and OBBs CUDA = CPU within "
        f"{max(st_err, ob_err, ax_err):.2g}; on the {n_skel}-point "
        f"{SKELETON_LEAF} m skeleton: euclidean_clusters_exact "
        f"{int(res['exact'][0][1])} clusters in "
        f"{res['exact'][1] * 1e3:.1f} ms ({res['exact'][2]} syncs), "
        f"region_growing ({SMOOTH_DEG} deg) {int(res['region_growing'][0][1])}"
        f" regions in {res['region_growing'][1] * 1e3:.1f} ms "
        f"({res['region_growing'][2]} syncs): both equal to scipy's "
        f"components of the same graph; on a {CLUSTER_CROP}-slot crop CUDA "
        f"= CPU")

    # (e) hulls
    dirs = torch.from_numpy(HL.fibonacci_directions(2048)).to(dev)
    run = lambda: HL._support_indices(src.xyz, src.mask, dirs)  # noqa
    si = run()
    ms_si = median_ms(run, 10)
    check(torch.equal(si.cpu(), HL._support_indices(
        src_cpu.xyz, src_cpu.mask, dirs.cpu())),
        "(e) _support_indices: CUDA differs from CPU")
    h_ex, t_hex = synced_s(lambda: convex_hull(src, exact=True))
    h_sup, t_hsup = synced_s(lambda: convex_hull(src))
    check(0.95 * h_ex.volume <= h_sup.volume <= h_ex.volume * (1 + 1e-6),
          f"(e) support hull {h_sup.volume} vs exact {h_ex.volume}")
    inside = crop_hull(src, h_ex)
    check(torch.equal(inside.mask.cpu(), crop_hull(src_cpu, h_ex).mask)
          and int(inside.mask.sum()) == n_src,
          "(e) crop_hull: CUDA differs from CPU, or drops a point")
    outside = crop_hull(src, h_sup, invert=True)
    check(torch.equal(outside.mask.cpu(),
                      crop_hull(src_cpu, h_sup, invert=True).mask),
          "(e) crop_hull (inverted): CUDA differs from CPU")
    big = res["exact"][0][0] == 0
    part = PointCloud.from_points(skel.xyz[big], device=dev)
    ch, t_ch = synced_s(lambda: concave_hull(part, 3 * SKELETON_LEAF))
    say(f"    (e) hulls of {n_src} points: _support_indices (2048 "
        f"directions) {ms_si:.3f} ms, CUDA = CPU; convex exact "
        f"{len(h_ex.vertex_ids)} vertices {h_ex.volume:.4f} m^3 in "
        f"{t_hex:.3f} s, support-reduced {len(h_sup.vertex_ids)} vertices "
        f"{h_sup.volume:.4f} m^3 in {t_hsup:.3f} s; crop_hull keeps all "
        f"{n_src} points in the exact hull, {int(outside.mask.sum())} "
        f"outside the support hull, CUDA = CPU; concave_hull (alpha "
        f"{3 * SKELETON_LEAF} m) of the largest skeleton cluster "
        f"({int(big.sum())} points): {len(ch.faces)} faces, "
        f"{ch.volume * 1e3:.2f} L in {t_ch:.3f} s")

    # (f) segment_cli on the 113k cloud, on the card and on the CPU: both
    # split key 0 as the JAX CLI does, so both draw the same planes
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene.ply")
        save_ply(ply, xyz[valid])
        outs = {}
        saved_env = os.environ.get("PCS_PLATFORM")
        try:
            for tag, plat in (("card", dev.type), ("cpu", "cpu")):
                os.environ["PCS_PLATFORM"] = plat
                out = os.path.join(tmp, tag)
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    n_cl = segment_cli._run([ply, out, "--drop-plane",
                                             str(PLANE_THR), "--obb",
                                             "--hull"])
                outs[tag] = (out, buf.getvalue(), time.perf_counter() - t,
                             n_cl)
        finally:
            if saved_env is None:
                os.environ.pop("PCS_PLATFORM", None)
            else:
                os.environ["PCS_PLATFORM"] = saved_env
        files = sorted(os.listdir(outs["card"][0]))
        check(files and files == sorted(os.listdir(outs["cpu"][0])),
              f"(f) segment_cli wrote {files} on the card, "
              f"{sorted(os.listdir(outs['cpu'][0]))} on the CPU")
        bad = [f for f in files if not filecmp.cmp(
            os.path.join(outs["card"][0], f),
            os.path.join(outs["cpu"][0], f), shallow=False)]
        check(not bad, f"(f) segment_cli files differ: {bad}")
        n_cl = outs["card"][3]
        check(n_cl == outs["cpu"][3] and n_cl > 0, f"(f) {n_cl} clusters "
              f"on the card, {outs['cpu'][3]} on the CPU")
        say(f"    (f) segment_cli --drop-plane {PLANE_THR} --obb --hull "
            f"on {n_src} points: {n_cl} clusters and {len(files) - n_cl} "
            f"hulls, every file equal to the CPU run's; "
            f"{outs['card'][2]:.2f} s on the card, {outs['cpu'][2]:.2f} s "
            f"on the CPU; {outs['card'][1].splitlines()[1]}")
    say(f"    phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return runs["--drop-plane"][1], flag


# --- phase 13: the sharded port (parallel/) ----------------------------------
SHARD_FRAMES = 10        # track-mode frames of each sharded stitch run
SHARD_TIMED = 20         # frames of the timed runs (phase 6 times 20)
SHARD_GLOO = 4           # ranks of the one-card world over gloo
SHARD_LEAF = 2.0 ** -7   # m: the sharded TSDF's leaf; with the origin a
SHARD_ORIGIN = (-1.0, -0.59375, 0.203125)   # multiple of it, slabs shift
#                          exactly. Z slab 0 ([0.20, 0.70) m at 4 slabs)
#                          holds no surface of TSDF_SCENE
RANK_TIMEOUT_S = 300     # any collective of a rank
WORLD_TIMEOUT_S = 420    # one world's whole run


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, n: int, dev) -> float:
    """Median ms of ``n`` synced calls of ``fn`` (after one warm call)."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def _digest(*ts) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


SHARD_RUNS = (("shardmap", "1 cm", {}),
              ("shardmap", "6 cm + cam pass",
               dict(out_voxel_leaf=0.06, cam_voxel_enabled=True)),
              ("sharded", "1 cm", {}),
              ("sharded", "6 cm + cam pass",
               dict(out_voxel_leaf=0.06, cam_voxel_enabled=True)))


def _stitch_launches(kind: str, ov: dict, dev) -> dict:
    """Launches per rank of SHARD_FRAMES frames of a SHARD_RUNS run: per
    frame K2 once for the ICP pass and once for the camera pass (which
    make_shardmap_stitch forces), K3 once per ICP iteration, K1 once; none
    off the card."""
    if dev.type != "cuda":
        return {}
    cam = kind == "shardmap" or bool(ov.get("cam_voxel_enabled"))
    return {"segment_sum_sorted": (1 + int(cam)) * SHARD_FRAMES,
            "nn_batched_prepared": 5 * SHARD_FRAMES,
            "segment_sum_from_flags": SHARD_FRAMES}


def _shard_stitch(dev, mesh, world: int, rank: int) -> list:
    """(a)/(b): both sharded stitches at both flagship configurations, 10
    frames in track mode from this rank's 8 / world cameras. Each run's
    launches must be the path's (per frame K2 once for the ICP pass and
    once for the camera pass, K3 5 times, K1 once); its last cloud must
    equal the unsharded step's with ICP off fed its extrinsics, bit for
    bit; 'torch' runs (every run in a world of 1, the 6 cm shard_map run
    otherwise) must equal 'auto' bit for bit and launch nothing. In a
    world of 1 the unsharded step runs the same 10 frames beside."""
    import torch
    from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                                stitch_step)
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    from pointcloud_stitching_tpu_torch.parallel import (
        collectives as C, make_sharded_stitch, make_shardmap_stitch)

    ext_np, depths_np = flagship_scene()
    depths = torch.from_numpy(depths_np).to(dev)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    intr_l, depths_l = C.local_rows(intr, mesh), C.local_rows(depths, mesh)
    builders = {"shardmap": make_shardmap_stitch,
                "sharded": make_sharded_stitch}
    entries = []
    for kind, tag, ov in SHARD_RUNS:
        cam = kind == "shardmap" or bool(ov)
        impls = ("auto", "torch") if world == 1 or (
            kind == "shardmap" and ov) else ("auto",)
        outs = {}
        for impl in impls:
            step = builders[kind](flagship_cfg(StitchConfig,
                                               kernel_impl=impl, **ov), mesh)
            ext = torch.from_numpy(ext_np).to(dev)
            pts = []
            kb.reset_launches()
            C.reset_traffic()
            for _ in range(SHARD_FRAMES):
                out = step(intr_l, C.local_rows(ext, mesh), depths_l)
                ext = out.extrinsics                       # track mode
                pts.append(out.metrics.points_out)
            _sync(dev)
            outs[impl] = (out, dict(kb.LAUNCHES), sum(C.BYTES.values()),
                          [int(p) for p in pts])
        out, launches, nbytes_, pts = outs["auto"]
        want = _stitch_launches(kind, ov, dev)
        check(launches == want, f"{kind} {tag}, rank {rank}/{world}: "
              f"launches {launches}, want {want}")
        if "torch" in outs:
            check(not outs["torch"][1], f"{kind} {tag}: 'torch' launched "
                  f"{outs['torch'][1]}")
            check(same_output(out, outs["torch"][0]),
                  f"{kind} {tag}, rank {rank}/{world}: 'auto' differs from "
                  "'torch'")
        rest = {k: v for k, v in ov.items() if k != "cam_voxel_enabled"}
        fed = stitch_step(flagship_cfg(StitchConfig, icp_enabled=False,
                                       cam_voxel_enabled=cam, **rest),
                          intr, out.extrinsics, depths)
        check(torch.equal(fed.cloud.xyz, out.cloud.xyz)
              and torch.equal(fed.cloud.mask, out.cloud.mask),
              f"{kind} {tag}, rank {rank}/{world}: the cloud differs from "
              "the unsharded step's fed the same extrinsics")
        m = out.metrics
        e = dict(kind=kind, tag=tag, launches=launches, pts=pts,
                 bytes_per_frame=nbytes_ / SHARD_FRAMES,
                 torch_equal="torch" in outs,
                 digest=_digest(out.cloud.xyz, out.cloud.mask,
                                out.extrinsics, m.points_in, m.points_out,
                                m.icp_mean_error, m.icp_inliers,
                                m.loop_error),
                 ext=out.extrinsics.cpu().numpy(),
                 cloud=(out.cloud.xyz[out.cloud.mask].cpu().numpy()
                        if rank == 0 else None))
        if world == 1:
            cfg1 = flagship_cfg(StitchConfig, cam_voxel_enabled=cam, **rest)
            ext1 = torch.from_numpy(ext_np).to(dev)
            for _ in range(SHARD_FRAMES):
                o1 = stitch_step(cfg1, intr, ext1, depths)
                ext1 = o1.extrinsics
            d = float((out.extrinsics - ext1).abs().max())
            check(d <= ATOL_SLICE, f"{kind} {tag}: extrinsics {d} from the "
                  "unsharded step's")
            e.update(d_unsharded=d, pts_unsharded=int(o1.metrics.points_out))
        entries.append(e)
    return entries


def _shard_ring(dev, mesh, world: int, rank: int) -> dict:
    """(c): the ring NN over phase 7's clouds (131,072 x 131,072), this
    rank's queries and reference shard; d2 bit for bit the unsharded K3's
    on the same queries, K3 launched once per ring step."""
    import torch
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    from pointcloud_stitching_tpu_torch.ops import nearest_neighbors
    from pointcloud_stitching_tpu_torch.parallel import (
        collectives as C, ring_nearest_neighbors)

    sc = registration_scene(dev)
    q = C.local_rows(sc.src.xyz, mesh)
    r, rm = C.local_rows(sc.dst.xyz, mesh), C.local_rows(sc.dst.mask, mesh)
    kb.reset_launches()
    C.reset_traffic()
    idx, d2 = ring_nearest_neighbors(q, r, rm, mesh)
    _sync(dev)
    launches, nbytes_ = dict(kb.LAUNCHES), sum(C.BYTES.values())
    want = {"nn_batched_prepared": world} if dev.type == "cuda" else {}
    check(launches == want, f"ring NN rank {rank}/{world}: launches "
          f"{launches}, want {want}")
    ridx, rd2 = nearest_neighbors(q, sc.dst.xyz, sc.dst.mask)
    check(torch.equal(d2, rd2), f"ring NN rank {rank}/{world}: d2 differs "
          f"from unsharded K3 by {float((d2 - rd2).abs().max())}")
    return dict(launches=launches, bytes=nbytes_,
                agree=float((idx == ridx).float().mean()),
                ms=_median_ms(lambda: ring_nearest_neighbors(q, r, rm, mesh),
                              5, dev),
                ms_unsharded=_median_ms(lambda: nearest_neighbors(
                    q, sc.dst.xyz, sc.dst.mask), 5, dev))


def _shard_tsdf(dev, zmesh, world: int, rank: int) -> dict:
    """(d): phase 8's 4-camera scene into 256^3 at a 2^-7 m leaf in Z
    slabs: two frames (the second without its last camera) of sharded
    'auto' integrate (K5 on the slab's REFINE bricks; a camera with none
    launches nothing) bit for bit the unsharded 'dense' one's slab,
    without and with colour; the sharded raycast against the unsharded
    one; times."""
    import torch
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    from pointcloud_stitching_tpu_torch.kernels.patch_gather import (
        patch_gather)
    from pointcloud_stitching_tpu_torch.models import tsdf as TM
    from pointcloud_stitching_tpu_torch.parallel import (
        make_sharded_integrate, make_sharded_raycast, shard_volume)

    i1 = Intrinsics.create(fx=TSDF_FX, fy=TSDF_FY, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i1.stack([i1] * (TSDF_NCAM - 1))
    frames = [tuple(torch.from_numpy(a).to(dev) for a in tsdf_rig(k))
              for k in range(2)]
    # the second frame without its last camera (a camera that drops out):
    # it has no REFINE brick in any slab, so its gathers are empty
    frames[1][1][TSDF_NCAM - 1] = 0
    color = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (TSDF_NCAM, H, W, 3), dtype=np.uint8)).to(dev)
    zs = TSDF_GRID[2] // world
    lo, hi = rank * zs, (rank + 1) * zs
    integ = make_sharded_integrate(zmesh, method="auto")
    res = {}
    for with_rgb in (False, True):
        full = TM.TSDFVolume.create(TSDF_GRID, SHARD_LEAF,
                                    origin=SHARD_ORIGIN, with_rgb=with_rgb,
                                    device=dev)
        slab = shard_volume(full, zmesh)
        col = color if with_rgb else None
        kb.reset_launches()
        with recording("pointcloud_stitching_tpu_torch.models.tsdf",
                       "patch_gather") as calls:
            for ext, depth in frames:
                slab = integ(slab, depth, intr, ext, color=col)
        _sync(dev)
        k5 = kb.LAUNCHES.get("patch_gather", 0)
        nonempty = [(a, kw) for a, kw in calls if a[1].shape[0] > 0]
        check(k5 == (len(nonempty) if dev.type == "cuda" else 0),
              f"TSDF rank {rank}/{world}: K5 launched {k5} times for "
              f"{len(nonempty)} non-empty gathers of {len(calls)}")
        for ext, depth in frames:
            full = TM.integrate(full, depth, intr, ext, color=col,
                                method="dense")
        for f in ("tsdf", "weight") + (("rgb",) if with_rgb else ()):
            check(torch.equal(getattr(slab, f), getattr(full, f)[:, :, lo:hi]),
                  f"TSDF rank {rank}/{world}: sharded 'auto' {f} differs "
                  "from unsharded 'dense'")
        if nonempty and dev.type == "cuda":
            a, kw = nonempty[0]
            check(torch.equal(patch_gather(*a, impl="cuda"),
                              patch_gather(*a, impl="torch")),
                  f"TSDF rank {rank}/{world}: K5 differs from plain")
        empty = len(calls) - len(nonempty)
        check(empty > 0, f"TSDF rank {rank}/{world}: the dead camera's "
              "gathers are not empty")
        res["rgb" if with_rgb else "plain"] = dict(
            k5=k5, gathers=len(calls), empty=empty, nonempty=len(nonempty),
            bricks=[int(a[1].shape[0]) for a, _ in calls])
        if not with_rgb:
            plain_full, plain_slab = full, slab
    ext0 = frames[0][0][0]
    # the scene lies within 3 m of the rig: a shorter march than phase 8's
    rcfn = make_sharded_raycast(zmesh, t_max=3.0, stride=2)
    rc = rcfn(plain_slab, i1, ext0)
    rf = TM.raycast(plain_full, i1, ext0, t_max=3.0, stride=2)
    both = rc.valid & rf.valid
    res.update(
        rc_disagree=float((rc.valid != rf.valid).float().mean()),
        rc_both=int(both.sum()),
        rc_depth=float((rc.depth - rf.depth)[both].abs().max()),
        ms_integrate=_median_ms(lambda: integ(plain_slab, frames[0][1], intr,
                                              frames[0][0]), 5, dev),
        ms_raycast=_median_ms(lambda: rcfn(plain_slab, i1, ext0), 5, dev))
    check(res["rc_disagree"] < 0.01 and res["rc_both"] > 1000
          and res["rc_depth"] <= 2e-3,
          f"TSDF rank {rank}/{world}: raycast validity disagrees on "
          f"{res['rc_disagree']:.4f}, depth by {res['rc_depth']}")
    if world == 1:
        res.update(ms_integrate_unsharded=_median_ms(lambda: TM.integrate(
            plain_full, frames[0][1], intr, frames[0][0]), 5, dev),
            ms_raycast_unsharded=_median_ms(lambda: TM.raycast(
                plain_full, i1, ext0, t_max=3.0, stride=2), 5, dev))
    return res


def _shard_timing(dev, mesh, world: int) -> dict:
    """(e): ms per frame of ``make_sharded_stitch`` at phase 6's flagship
    configuration, the bytes that cross ranks per frame, and (in a run
    whose collectives drain the device before and after) their share."""
    import torch
    import torch.distributed as dist
    from pointcloud_stitching_tpu_torch import Intrinsics, StitchConfig
    from pointcloud_stitching_tpu_torch.parallel import (
        collectives as C, make_sharded_stitch)

    ext_np, depths_np = flagship_scene()
    depths = C.local_rows(torch.from_numpy(depths_np).to(dev), mesh)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = C.local_rows(i0.stack([i0] * (NCAM - 1)), mesh)
    step = make_sharded_stitch(flagship_cfg(StitchConfig), mesh)
    state = {"ext": torch.from_numpy(ext_np).to(dev)}

    def run(n: int) -> float:
        _sync(dev)
        dist.barrier()
        t = time.perf_counter()
        for _ in range(n):
            state["ext"] = step(intr, C.local_rows(state["ext"], mesh),
                                depths).extrinsics
        _sync(dev)
        return (time.perf_counter() - t) * 1e3 / n

    run(3)
    C.reset_traffic()
    ms = run(SHARD_TIMED)
    bytes_pf = sum(C.BYTES.values()) / SHARD_TIMED
    C.reset_traffic()
    with C.timed():
        ms_timed = run(SHARD_FRAMES)
    coll_ms = sum(C.SECONDS.values()) * 1e3 / SHARD_FRAMES
    return dict(ms=ms, bytes_per_frame=bytes_pf, ms_timed=ms_timed,
                coll_ms=coll_ms, coll_share=coll_ms / ms_timed,
                seconds={k: v * 1e3 / SHARD_FRAMES
                         for k, v in C.SECONDS.items()})


def _shard_work(rank: int, world: int, backend: str, coordinator: str,
                device: str) -> dict:
    """One rank of a world: joins the process group through the port's
    ``init_multihost`` and runs (a)/(b), (c), (d) and (e)."""
    import datetime

    import torch
    import torch.distributed as dist
    from pointcloud_stitching_tpu_torch.parallel import (init_multihost,
                                                         make_mesh)
    from pointcloud_stitching_tpu_torch.utils.platform import (
        set_full_fp32_matmul)

    dev = torch.device(device)
    if dev.type == "cuda":
        # as torchrun would: platform_device() then names this rank's card
        os.environ["LOCAL_RANK"] = str(dev.index)
        torch.cuda.set_device(dev)
        from pointcloud_stitching_tpu_torch.kernels import build as kb
        kb.library()            # built by phase 2: loads, never compiles
    set_full_fp32_matmul()
    check(init_multihost(coordinator=coordinator, num_processes=world,
                         process_id=rank, backend=backend,
                         timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S)),
          "init_multihost did not initialize")
    check(dist.get_backend() == backend, f"backend {dist.get_backend()}")
    try:
        mesh, zmesh = make_mesh(), make_mesh(axis="z")
        t0 = time.perf_counter()
        out = dict(stitch=_shard_stitch(dev, mesh, world, rank))
        out["ring"] = _shard_ring(dev, mesh, world, rank)
        out["tsdf"] = _shard_tsdf(dev, zmesh, world, rank)
        out["timing"] = _shard_timing(dev, mesh, world)
        out["seconds"] = time.perf_counter() - t0
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def _shard_rank(rank, world, backend, coordinator, device, queue) -> None:
    """Process target: the rank's results (or its traceback) go to the
    parent through ``queue``."""
    import traceback
    try:
        queue.put((rank, "ok", _shard_work(rank, world, backend,
                                           coordinator, device)))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def shard_world(backend: str, devices: list) -> list:
    """Spawn one rank per entry of ``devices`` (torch.multiprocessing,
    'spawn'; rank r computes on ``devices[r]``) joined over ``backend``;
    returns their results in rank order. A failed rank raises here; every
    rank is stopped before this returns."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    world = len(devices)
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, backend, f"127.0.0.1:{port}",
                               str(devices[r]), q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while len(results) < world:
            try:
                rank, status, payload = q.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue_mod.Empty:
                raise AssertionError(
                    f"world of {world} ({backend}): no result from ranks "
                    f"{sorted(set(range(world)) - set(results))} within "
                    f"{WORLD_TIMEOUT_S} s (exit codes "
                    f"{[p.exitcode for p in procs]})") from None
            check(status == "ok", f"world of {world} ({backend}): rank "
                  f"{rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=60)
            check(p.exitcode == 0, f"world of {world}: a rank exited "
                  f"with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def one_card_worlds(dev) -> list:
    """Phase 13's worlds on one card: (label, backend, devices) of a world
    of 1 over NCCL and a world of SHARD_GLOO over gloo sharing the card
    (the stand-in for a 4-GPU host; NCCL refuses two ranks on one
    device). Off the card (a CPU rehearsal) both are gloo."""
    one = "nccl" if dev.type == "cuda" else "gloo"
    return [(one, one, [dev]),
            ("gloo, one card, staged through host", "gloo",
             [dev] * SHARD_GLOO)]


def parallel_phase(dev, card, unsharded_ms: float, worlds=None) -> None:
    """Phase 13: ``parallel/`` at the flagship size in each of ``worlds``
    (default ``one_card_worlds``); the first is the world of 1 that the
    others are held against."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    specs = worlds or one_card_worlds(dev)
    check(len(specs[0][2]) == 1, "the first world must have one rank")
    results = [shard_world(backend, devs) for _, backend, devs in specs]
    one = results[0][0]
    labels = [f"world {len(devs)} ({label})" for label, _, devs in specs]

    # each rank's launches, as the ranks counted them
    for w, rs in enumerate(results):
        for r, res in enumerate(rs):
            for (kind, tag, ov), e in zip(SHARD_RUNS, res["stitch"]):
                check(e["launches"] == _stitch_launches(kind, ov, dev),
                      f"{labels[w]} rank {r} {kind} {tag}: launches "
                      f"{e['launches']}")
            check(res["ring"]["launches"] == (
                {"nn_batched_prepared": len(rs)} if dev.type == "cuda"
                else {}), f"{labels[w]} rank {r}: ring NN launches "
                f"{res['ring']['launches']}")
            for k in ("plain", "rgb"):
                x = res["tsdf"][k]
                check(x["k5"] == (x["nonempty"] if dev.type == "cuda"
                                  else 0) and x["empty"] > 0,
                      f"{labels[w]} rank {r}: K5 launched {x['k5']} times "
                      f"for {x['nonempty']} non-empty gathers")

    # (a) and (b): the stitch
    for i, (kind, tag, _) in enumerate(SHARD_RUNS):
        a = one["stitch"][i]
        name = ("make_shardmap_stitch" if kind == "shardmap"
                else "make_sharded_stitch")
        say(f"[13/15 parallel] (a) {labels[0]} {card}: {name} "
            f"{tag}: {SHARD_FRAMES} frames track mode, points_out "
            f"{a['pts'][0]}..{a['pts'][-1]}; 'auto' == 'torch' bit for "
            f"bit; |ext - stitch_step| {a['d_unsharded']:.3g} (points_out "
            f"{a['pts_unsharded']}); cloud == stitch_step fed its "
            f"extrinsics bit for bit; launches {a['launches']}")
        for w, rs in enumerate(results[1:], 1):
            rk = [r["stitch"][i] for r in rs]
            check(len({e["digest"] for e in rk}) == 1,
                  f"(b) {labels[w]} {kind} {tag}: the ranks' outputs differ")
            b = rk[0]
            d_ext = float(np.abs(b["ext"] - a["ext"]).max())
            check(d_ext <= ATOL_SLICE, f"(b) {labels[w]} {kind} {tag}: "
                  f"extrinsics {d_ext} from world 1's")
            check(b["pts"] == a["pts"], f"(b) {labels[w]} {kind} {tag}: "
                  f"points_out {b['pts']} against world 1's {a['pts']}")
            d_cloud = float(np.abs(np.sort(b["cloud"], 0)
                                   - np.sort(a["cloud"], 0)).max())
            check(d_cloud <= ATOL_SLICE, f"(b) {labels[w]} {kind} {tag}: "
                  f"sorted cloud {d_cloud} from world 1's")
            say(f"    (b) {labels[w]}: every rank's output bit for bit the "
                f"same (digest {b['digest']}); |ext - (a)| {d_ext:.3g}, "
                f"|sorted cloud - (a)| {d_cloud:.3g}, points_out equal; "
                f"cloud == stitch_step fed its extrinsics; launches per "
                f"rank {[e['launches'] for e in rk]}"
                + ("; 'auto' == 'torch' bit for bit on every rank"
                   if b["torch_equal"] else "")
                + f"; bytes crossing per frame per rank "
                f"{b['bytes_per_frame']:.0f}")

    # (c): the ring NN
    for w, rs in enumerate(results):
        c = [r["ring"] for r in rs]
        say(f"    (c) ring NN 131072 x 131072, {labels[w]}: d2 == "
            f"unsharded K3 bit for bit on every rank, idx agreement "
            f"{min(x['agree'] for x in c):.6f}; K3 launches per rank "
            f"{[x['launches'].get('nn_batched_prepared', 0) for x in c]}; "
            f"{max(x['ms'] for x in c):.3f} ms per call (slowest rank), "
            f"unsharded K3 on a rank's queries "
            f"{max(x['ms_unsharded'] for x in c):.3f} ms; bytes received "
            f"per rank {c[0]['bytes']}")

    # (d): the TSDF
    for w, rs in enumerate(results):
        d = [r["tsdf"] for r in rs]
        say(f"    (d) TSDF {TSDF_NCAM} x {H}x{W} into {TSDF_GRID} at "
            f"{SHARD_LEAF} m, {labels[w]}, {len(rs)} Z slab(s): two "
            f"frames of sharded 'auto' == unsharded 'dense' bit for bit, "
            f"plain and colour; K5 launches per rank plain "
            f"{[x['plain']['k5'] for x in d]} colour "
            f"{[x['rgb']['k5'] for x in d]} (empty gathers skipped "
            f"{[x['plain']['empty'] for x in d]} / "
            f"{[x['rgb']['empty'] for x in d]}; bricks per depth gather "
            f"{[x['plain']['bricks'][:TSDF_NCAM * 2] for x in d]}); "
            f"raycast stride 2, to 3 m: "
            f"validity disagrees on {max(x['rc_disagree'] for x in d):.5f}, "
            f"|depth| {max(x['rc_depth'] for x in d):.3g} m on "
            f"{d[0]['rc_both']} pixels; ms per sharded integrate "
            f"{max(x['ms_integrate'] for x in d):.3f}, raycast "
            f"{max(x['ms_raycast'] for x in d):.3f} (slowest rank)"
            + (f"; unsharded 'auto' integrate "
               f"{d[0]['ms_integrate_unsharded']:.3f}, raycast "
               f"{d[0]['ms_raycast_unsharded']:.3f}" if w == 0 else ""))

    # (e): times
    parts = []
    for w, rs in enumerate(results):
        x = [r["timing"] for r in rs]
        parts.append(
            f"{labels[w]} {max(v['ms'] for v in x):.3f} ms per frame "
            f"(slowest rank), bytes crossing ranks per frame "
            f"{sum(v['bytes_per_frame'] for v in x):.0f} "
            f"({x[0]['bytes_per_frame']:.0f} per rank), collectives "
            f"{max(v['coll_ms'] for v in x):.3f} of "
            f"{max(v['ms_timed'] for v in x):.3f} ms "
            f"({100 * max(v['coll_share'] for v in x):.1f}%) in the run "
            f"that drains around each ({x[0]['seconds']}); rank seconds "
            f"{max(r['seconds'] for r in rs):.1f}")
    say(f"    (e) times {card}: make_sharded_stitch at the flagship 1 cm "
        f"config, {SHARD_TIMED} frames track mode: " + "; ".join(parts)
        + f"; phase 6 unsharded {unsharded_ms:.3f} ms per frame")
    say(f"    phase 13 took {time.perf_counter() - t_phase:.1f} s")



# --- phase 14: the port's commands -------------------------------------------
CLUSTER_FRAMES = 30
CLUSTER_TIMEOUT = 600    # seconds for one launcher run, its build included
# the CUDA kernels of the stitch path, by the names the trace gives them,
# and their launches per stitched frame at stitch_cli's default config
# (ring ICP of 5 iterations on, no per-camera pass)
TRACE_KERNELS = {"K1": ("segsum_flags_kernel", 1),
                 "K2": ("segsum_sorted_kernel", 1),
                 "K3": ("nn_batched_split", 5)}
# the JAX package's positional parameters of each entry point whose order
# the port once broke (tests/test_torch_signatures.py holds the port to
# them; this script may not import the JAX package to read them)
JAX_ORDER = {
    "nearest_neighbors": ("query", "ref", "ref_mask", "query_tile",
                          "ref_tile", "impl", "interpret"),
    "icp_batched": ("src", "dst", "init_T", "iterations", "max_corr_dist",
                    "query_tile", "ref_tile", "nn_impl", "trim_fraction",
                    "nn_interpret"),
    "icp_point_to_plane_batched": (
        "src", "dst", "dst_normals", "init_T", "iterations", "max_corr_dist",
        "query_tile", "ref_tile", "nn_impl", "trim_fraction", "nn_interpret"),
    "icp": ("src", "dst", "init_T", "iterations", "max_corr_dist",
            "query_tile", "ref_tile", "nn_impl", "trim_fraction", "prune"),
    "icp_converge": ("src", "dst", "init_T", "max_iterations",
                     "transformation_epsilon", "max_corr_dist", "query_tile",
                     "ref_tile", "nn_impl", "trim_fraction", "prune"),
    "register_pair": ("src", "dst", "src_idx", "dst_idx", "refine",
                      "max_iterations", "transformation_epsilon",
                      "max_corr_dist", "query_tile", "ref_tile",
                      "trim_fraction", "prune"),
    "register_global": ("src", "dst", "key", "num_starts",
                        "coarse_leaf", "coarse_capacity",
                        "coarse_iterations", "coarse_corr_dist",
                        "coarse_trim", "query_tile", "ref_tile", "refine",
                        "fpfh_starts", "fpfh_k_corr"),
    "voxel_downsample": ("pc", "leaf", "capacity", "impl", "interpret",
                         "packed"),
    "voxel_map_update": ("vmap", "cloud", "decay", "min_weight",
                         "max_weight", "impl", "interpret"),
    "TemporalAccumulator": ("capacity", "leaf", "decay", "min_weight",
                            "max_weight", "with_rgb", "impl", "interpret"),
    "StitchingPipeline": ("cfg", "intr", "extrinsics", "update_mode",
                          "ema_alpha", "color_intr", "color_ext"),
    "build": ("force",),
}


def free_base_port(n: int) -> int:
    """A base port with n free loopback ports above it."""
    import socket
    for _ in range(50):
        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            base = so.getsockname()[1]
        if base + n >= 65536:
            continue
        socks = []
        try:
            for port in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for so in socks:
                so.close()
    raise RuntimeError("no run of free ports")


def run_cluster(dev, tag: str, extra: list, client_args: str) -> dict:
    """scripts/local_cluster_torch.py with NCAM cameras of HxW and
    CLUSTER_FRAMES frames as a subprocess, its client on ``dev``; returns
    stitch_cli's summary."""
    cmd = [sys.executable, os.path.join(REPO, "scripts",
                                        "local_cluster_torch.py"),
           "--cameras", str(NCAM), "--frames", str(CLUSTER_FRAMES),
           "--height", str(H), "--width", str(W),
           "--base-port", str(free_base_port(NCAM)), *extra,
           "--client-args", client_args + " --print-every 0"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=CLUSTER_TIMEOUT)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"(a) {tag}: the launcher exited with "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    up = sum(line.startswith("fake camera server on ") for line in lines)
    check(up == NCAM, f"(a) {tag}: {up} of {NCAM} servers came up")
    check(f"streaming from {NCAM} cameras on {dev}" in proc.stdout,
          f"(a) {tag}: the client did not stream on {dev}")
    summary = json.loads(lines[-1])
    check(summary["frames"] == CLUSTER_FRAMES
          and summary["dropped_cameras"] == 0,
          f"(a) {tag}: stitched {summary}")
    summary["wall_s"] = wall
    return summary


def trace_launches(trace_file: str) -> dict:
    """Device kernel events per stitch kernel in a torch.profiler trace."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(kname in n for n in names)
            for k, (kname, _) in TRACE_KERNELS.items()}


def positional_calls(dev):
    """(name, positional call, keyword call) for each entry point of the
    table, on the card at the registration and flagship shapes; the keyword
    call names the arguments as the JAX package does."""
    import torch
    from pointcloud_stitching_tpu_torch import (Intrinsics, PointCloud,
                                                StitchConfig,
                                                StitchingPipeline, native)
    from pointcloud_stitching_tpu_torch.models import (register_global,
                                                       register_pair)
    from pointcloud_stitching_tpu_torch.models.voxel_map import (
        TemporalAccumulator, VoxelMap, voxel_map_update)
    from pointcloud_stitching_tpu_torch.ops import (
        icp, icp_batched, icp_converge, icp_point_to_plane_batched,
        nearest_neighbors, voxel_downsample)
    from pointcloud_stitching_tpu_torch.utils import prng

    sc = registration_scene(dev)
    src, dst = sc.src, sc.dst
    # the ring ICP's batch: 7 pairs of 2048-point clouds cut from the scene
    b, n = NCAM - 1, 2048
    bs = PointCloud(xyz=src.xyz[:b * n].reshape(b, n, 3),
                    mask=src.mask[:b * n].reshape(b, n))
    bd = PointCloud(xyz=dst.xyz[:b * n].reshape(b, n, 3),
                    mask=dst.mask[:b * n].reshape(b, n))
    normals = torch.nn.functional.normalize(bd.xyz, dim=-1)
    frames, ext = stream_rig()
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=W / 2.0, ppy=H / 2.0,
                           width=W, height=H, device=dev)
    intr = i0.stack([i0] * (NCAM - 1))
    cfg = flagship_cfg(StitchConfig)
    depths = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    inf = float("inf")

    def two_frames(*a, **k):
        pipe = StitchingPipeline(*a, **k)
        check(pipe.device == dev, f"the pipeline chose {pipe.device}")
        return [pipe(depths), pipe(depths), pipe.extrinsics]

    def two_updates(*a, **k):
        """Two updates (src, then dst) of a fresh 2^20-slot map."""
        vmap = VoxelMap.create(1 << 20, 0.01)
        check(vmap.device == dev, f"the map chose {vmap.device}")
        for cloud in (src, dst):
            if a:
                vmap = voxel_map_update(vmap, cloud, *a, **k)
            else:
                vmap = voxel_map_update(**{**k, "vmap": vmap,
                                           "cloud": cloud})
        return vmap

    def accumulate(*a, **k):
        acc = TemporalAccumulator(*a, **k)
        check(acc.state.device == dev, f"the map chose {acc.state.device}")
        acc.update(src)
        acc.update(dst)
        return acc.state

    def rebuilt(*a, **k):
        before = native.build().stat().st_mtime_ns
        path = native.build(*a, **k)
        check(path.stat().st_mtime_ns > before, "build(force) did not "
              "rebuild the native library")
        return str(path)

    rows = {
        "nearest_neighbors": (nearest_neighbors, (
            src.xyz, dst.xyz, dst.mask, 1024, 4096, "auto", False)),
        "icp_batched": (icp_batched, (
            bs, bd, None, 5, 0.1, 1024, 4096, "auto", 0.1, False)),
        "icp_point_to_plane_batched": (icp_point_to_plane_batched, (
            bs, bd, normals, None, 5, 0.1, 1024, 4096, "auto", 0.1, False)),
        "icp": (icp, (src, dst, None, 5, 0.1, 1024, 4096, "auto", 0.0,
                      True)),
        "icp_converge": (icp_converge, (
            src, dst, None, 50, 1e-8, 0.25, 1024, 4096, "auto", 0.0, True)),
        "register_pair": (register_pair, (
            src, dst, sc.picks, sc.picks, True, 50, 1e-8, 0.25, 1024, 4096,
            0.0, True)),
        "register_global": (register_global, (
            src, dst, prng.key(0, device=dev), 4, 0.05, 1024, 15, None, 0.1,
            512, 1024, True, 0, 8)),
        "voxel_downsample": (voxel_downsample, (
            src, 0.01, REG_CAP, "auto", False, "auto")),
        "voxel_map_update": (two_updates, (
            "vmap", "cloud", 0.9, 0.05, inf, "auto", False)),
        "TemporalAccumulator": (accumulate, (
            1 << 20, 0.01, 0.9, 0.05, inf, False, "auto", False)),
        "StitchingPipeline": (two_frames, (cfg, intr, ext, "track", 0.05)),
        "build": (rebuilt, (True,)),
    }
    calls = []
    for name, (fn, args) in rows.items():
        kw = dict(zip(JAX_ORDER[name], args))
        if name == "voxel_map_update":
            # two_updates passes the map and the cloud itself
            pos = (lambda fn=fn, a=args: fn(*a[2:]))
            key = (lambda fn=fn, kw=kw: fn(**{
                k: v for k, v in kw.items() if k not in ("vmap", "cloud")}))
        else:
            pos = (lambda fn=fn, a=args: fn(*a))
            key = (lambda fn=fn, kw=kw: fn(**kw))
        calls.append((name, pos, key))
    return calls


def flat(x) -> list:
    """The tensors and plain values of a result, in a fixed order."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in flat(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in flat(item)]
    return [x]


def bitwise_equal(a, b) -> bool:
    import torch
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        (x.dtype == y.dtype and bool(torch.equal(x, y)))
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(fa, fb))


# --- phase 15: the random draws ----------------------------------------------
# jax.random's own values for key(5), made with JAX 0.9.0 on the CPU
# (jax_threefry_partitionable on, its default, and 32-bit mode, as the JAX
# package runs): bits (8), split (3 keys), uniform (6, as int32 bit
# patterns), randint (8 in [0, randint_hi)), the sum and last word of
# 262,144 bits, and choice over choice_n slots (p uniform on the slots
# whose index is not a multiple of choice_mod, shape (choice_h, 3)): its
# first indices and their sum. tests/test_torch_prng.py holds these against
# live jax.random, so they cannot go stale.
JAX_DRAWS = {
    "seed": 5,
    "bits": [2003086470, 3955154020, 3160280976, 408371909, 3927703089,
             2910825445, 72334161, 232576969],
    "split": [[2724472204, 3573582090], [202567368, 3886822060],
              [3594430910, 1784718894]],
    "uniform": [1055836504, 1064025820, 1060920846, 1036171792, 1063918590,
                1059946410],
    "randint_hi": 100003,
    "randint": [64884, 33892, 13004, 8385, 58791, 23223, 57780, 28956],
    "bits_n": 262144,
    "bits_sum": 562713204571296,
    "bits_last": 2002440075,
    "choice_n": 262144,
    "choice_mod": 7,
    "choice_h": 1024,
    "choice_head": [139885, 20740, 69255, 237218, 22416, 84481, 257728,
                    247948, 209394, 148602, 261939, 160686],
    "choice_sum": 407417054,
}
# H100 SXM int32 instructions per second: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the Hopper architecture white paper)
INT32_INSTR_PER_S = 132 * 64 * 1.98e9
# integer instructions per threefry2x32 counter: 20 rounds of add, funnel
# shift and xor, 5 key injections of 3 adds, the counter and key set-up
THREEFRY_OPS = 80
FPFH_LOGITS = 1024       # register_global's skeleton (coarse_capacity)


def draw_calls(dev, p) -> dict:
    """The draws the paths make, by name, as calls: ``choice`` over ``p``
    (segment_plane's), ``normal(39, 4)`` (register_global's 64 starts),
    ``categorical`` (64, 3) over FPFH_LOGITS logits and ``randint`` (the
    FPFH starts), ``split``."""
    import torch
    from pointcloud_stitching_tpu_torch.utils import prng
    ks = prng.split(prng.key(0, device=dev))
    logits = torch.where(torch.arange(FPFH_LOGITS, device=dev) % 5 != 0,
                         0.0, -1e9)
    return {
        f"choice ({RANSAC_M}, 3) of {p.shape[0]}": lambda: prng.choice(
            ks[0], p.shape[0], (RANSAC_M, 3), p=p),
        "normal (39, 4)": lambda: prng.normal(ks[0], (39, 4)),
        f"categorical (64, 3) of {FPFH_LOGITS}": lambda: prng.categorical(
            ks[1], logits, shape=(64, 3)),
        "randint (64, 3)": lambda: prng.randint(ks[1], (64, 3), 0, 8),
        "split": lambda: prng.split(ks[0])}


def draw_profile(fn, kb, reps: int = 20):
    """(device ms, ms per call back to back, kernels, of which the port's,
    wrapper launches) of one draw: device time with the queue prefilled,
    the host-bound time without, torch.profiler's count of the card's
    kernels per draw (the port's own by name), and the launch counters of
    one draw."""
    _, _, ops, top = device_profile(fn, calls=5)
    ours = sum(n for _, n, name in top
               if any(k in name for k in ("threefry2x32", "scan16",
                                          "addback")))
    kb.reset_launches()
    fn()
    launches = dict(kb.LAUNCHES)
    return (cuda_ms(fn, reps), cuda_ms(fn, reps, prefill=False), ops, ours,
            launches)


def prng_phase(dev, kb, report, kernels, card, drop_launches: dict,
               flag) -> None:
    """Phase 15: the random draws (``utils/prng.py``) on the card.

    (a) both kernels equal their plain versions bit for bit: threefry2x32
    at 1, 3,072 (segment_plane's 1024 x 3 draw) and 262,144 counters, both
    outputs, and the scan of the flagship's 262,144-slot mask; (b) the
    card's bits, split, uniform, randint and choice equal JAX's literal
    values (JAX_DRAWS), its uniform on a range, normal and categorical
    equal the CPU's on the same key, and a CPU key with the flagship
    cloud draws on the card; (c) the kernels timed in turns with their plain
    versions (their launches are phase 12 (b)'s, the --drop-plane stitch:
    one of each per frame), and ms and device operations per draw of
    choice over 262,144 slots, normal(39, 4) (register_global's 64
    starts) and categorical over phase 11's FPFH logits."""
    import torch
    from pointcloud_stitching_tpu_torch.kernels import prng as KP
    from pointcloud_stitching_tpu_torch.ops import segment_plane
    from pointcloud_stitching_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    jd = JAX_DRAWS
    k5 = prng.key(jd["seed"], device=dev)
    m3 = 3 * RANSAC_M

    # (a) the kernels against their plain versions
    for n in (1, m3, jd["bits_n"]):
        for pairs in (False, True):
            got = KP.threefry2x32(k5, n, pairs, impl="cuda")
            want = KP.threefry2x32(k5, n, pairs, impl="torch")
            check(torch.equal(got, want), f"(a) threefry2x32 at {n} "
                  f"({'pairs' if pairs else 'bits'}) differs from plain")
    p = flag.mask.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    c = KP.scan16(p, impl="cuda")
    c_plain = KP.scan16(p, impl="torch")
    check(torch.equal(c, c_plain), "(a) scan16 differs from plain")
    check(torch.equal(c, KP.scan16(p.cpu()).to(dev)),
          "(a) scan16 on the card differs from the CPU's")
    lib_cumsum = torch.cumsum(p, 0)
    say(f"[15/15 draws] {card}: (a) threefry2x32 bit for bit plain at 1, "
        f"{m3} and {jd['bits_n']} counters (bits and pairs); scan16 of the "
        f"flagship's {p.shape[0]}-slot mask ({int(flag.mask.sum())} valid) "
        f"bit for bit plain and the CPU, c[-1] = {float(c[-1]):.9g} "
        f"(torch.cumsum {float(lib_cumsum[-1]):.9g}, max |diff| "
        f"{float((c - lib_cumsum).abs().max()):.3g})")

    # (b) the card's draws against JAX's values
    n = jd["choice_n"]
    mask = (torch.arange(n, device=dev) % jd["choice_mod"] != 0).to(
        torch.float32)
    idx = prng.choice(k5, n, (jd["choice_h"], 3), p=mask / mask.sum())
    big = prng.bits(k5, (jd["bits_n"],))
    got = {
        "bits": prng.bits(k5, (len(jd["bits"]),)).tolist(),
        "split": prng.split(k5, len(jd["split"])).tolist(),
        "uniform": prng.uniform(k5, (len(jd["uniform"]),)).view(
            torch.int32).tolist(),
        "randint": prng.randint(k5, (len(jd["randint"]),), 0,
                                jd["randint_hi"]).tolist(),
        "bits_sum": int(big.sum()), "bits_last": int(big[-1]),
        "choice_head": idx.reshape(-1)[:len(jd["choice_head"])].tolist(),
        "choice_sum": int(idx.sum())}
    for name, value in got.items():
        check(value == jd[name], f"(b) {name} on the card is {value}, "
              f"JAX's is {jd[name]}")
    say(f"    (b) the card's bits, split, uniform, randint, {jd['bits_n']} "
        f"bits and choice ({jd['choice_h']} x 3 of {n}) equal JAX's values "
        "for key(5)")
    # the draws that go through float ops: the card's against the CPU's on
    # the same key (uniform on a range bit for bit: its multiply-add is
    # made in float64; normal within 1e-5 relative, the bound against
    # JAX, as CUDA's erfinv may differ by ulps; categorical's indices)
    cpu = torch.device("cpu")
    k5c = prng.key(jd["seed"])
    u_g = prng.uniform(k5, (jd["bits_n"],), -2.5, 7.0)
    u_c = prng.uniform(k5c, (jd["bits_n"],), -2.5, 7.0)
    check(torch.equal(u_g.cpu().view(torch.int32), u_c.view(torch.int32)),
          "(b) uniform on [-2.5, 7) on the card differs from the CPU's in "
          f"{int((u_g.cpu() != u_c).sum())} of {jd['bits_n']}")
    q_g, q_c = prng.normal(k5, (39, 4)).cpu(), prng.normal(k5c, (39, 4))
    q_rel = float(((q_g - q_c).abs() / q_c.abs().clamp(min=1e-6)).max())
    check(q_rel <= 1e-5, f"(b) normal (39, 4): card vs CPU {q_rel:.3g} "
                         "relative")
    logits = torch.where(torch.arange(FPFH_LOGITS, device=dev) % 5 != 0,
                         0.0, -1e9)
    c_g = prng.categorical(k5, logits, shape=(64, 3)).cpu()
    c_c = prng.categorical(k5c, logits.cpu(), shape=(64, 3))
    check(torch.equal(c_g, c_c), "(b) categorical (64, 3): the card's "
          f"indices differ from the CPU's at {int((c_g != c_c).sum())}")
    # a key made on the CPU, with the cloud on the card: the draw runs on
    # the card (the key moves to the cloud), as one from a card key
    kb.reset_launches()
    got_c = segment_plane(flag, PLANE_THR, prng.key(0, device=cpu))
    moved = dict(kb.LAUNCHES)
    want_c = segment_plane(flag, PLANE_THR, prng.key(0, device=dev))
    check(moved.get("threefry2x32") == 1 and moved.get("scan16") == 1
          and got_c[0].device == flag.xyz.device
          and torch.equal(got_c[0], want_c[0])
          and torch.equal(got_c[1], want_c[1]),
          f"(b) segment_plane from a CPU key: launches {moved}")
    say(f"    (b) on the same key the card's uniform on [-2.5, 7) "
        f"({jd['bits_n']}) and categorical (64, 3) of {FPFH_LOGITS} equal "
        f"the CPU's, normal (39, 4) within {q_rel:.3g} relative; "
        "segment_plane from a CPU key draws on the card (one threefry2x32, "
        "one scan16) and equals a card key's plane")

    # (c) the kernels in turns with their plain versions, at the main
    # path's shapes: segment_plane's 3,072 counters, the 262,144-slot scan
    for name, fn in (("threefry2x32", lambda impl: KP.threefry2x32(
                         k5, m3, impl=impl)),
                     ("scan16", lambda impl: KP.scan16(p, impl=impl))):
        launches = drop_launches.get(name, 0)
        check(launches > 0, f"(c) the --drop-plane run launched no {name}: "
              f"{drop_launches}")
        times = time_in_turns(lambda fn=fn: fn("cuda"),
                              lambda fn=fn: fn("torch"))
        if name == "threefry2x32":
            # the key read once, one int64 word written a counter
            report(name, "pointcloud_stitching_tpu_torch/csrc/prng.cu",
                   "pointcloud_stitching_tpu/ops/sac.py:115", 0.0, times,
                   16 + 8 * m3, THREEFRY_OPS * m3, rate=INT32_INSTR_PER_S)
        else:
            # each float read once and written once; ~2 adds an element
            # (the blocks' inner sums, the add-back)
            lib_ms = cuda_ms(lambda: torch.cumsum(p, 0), 20)
            report(name, "pointcloud_stitching_tpu_torch/csrc/prng.cu",
                   "pointcloud_stitching_tpu/ops/sac.py:115",
                   float((c - c_plain).abs().max()), times, 8 * p.numel(),
                   2 * p.numel(), library_ms=lib_ms)
        kernels[name]["launches"] = launches

    # ms and device operations per draw
    parts = []
    for name, fn in draw_calls(dev, p).items():
        dev_ms, call_ms, ops, ours, launches = draw_profile(fn, kb)
        parts.append(f"{name}: {dev_ms:.4f} ms device, {call_ms:.4f} ms per "
                     f"call back to back, {ops:.0f} kernels in "
                     f"torch.profiler ({ours:.0f} of them the port's), "
                     f"wrapper launches {launches}")
    say(f"    (c) per draw ({card}): " + "; ".join(parts))
    say(f"    phase 15 took {time.perf_counter() - t_phase:.1f} s")


def commands_phase(dev, kb, card) -> None:
    """Phase 14: the port's own commands. (a) the loopback cluster
    launcher at the flagship rig, traced; (b) every entry point whose
    order once differed from the JAX package's, called on the card in the
    JAX order against its keyword call; (c) the pcs-torch-* targets of
    pyproject.toml in a process where JAX cannot be imported."""
    import tempfile
    import tomllib

    import torch
    from pointcloud_stitching_tpu_torch.io import load_ply

    t_phase = time.perf_counter()
    # (a) two runs: traced with --save-dir (the launcher's default zlib
    # codec), then untraced with snappy, as phase 9 streams
    with tempfile.TemporaryDirectory() as tmp:
        save, trace_dir = os.path.join(tmp, "clouds"), os.path.join(
            tmp, "trace")
        traced = run_cluster(dev, "traced", [],
                             f"--save-dir {save} --trace-dir {trace_dir}")
        plys = sorted(os.listdir(save))
        xyz, _ = load_ply(os.path.join(save, plys[0]))
        check(len(xyz) > 100_000 and np.isfinite(xyz).all(),
              f"(a) the saved cloud {plys[0]} has {len(xyz)} points")
        trace_file = os.path.join(trace_dir, "trace.json")
        seen = trace_launches(trace_file)
        for k, (kname, per_frame) in TRACE_KERNELS.items():
            check(seen[k] == per_frame * CLUSTER_FRAMES,
                  f"(a) the trace has {seen[k]} {kname} ({k}) launches, "
                  f"want {per_frame} per frame")
        trace_mib = os.path.getsize(trace_file) / 2 ** 20
    plain = run_cluster(dev, "snappy", ["--codec", "snappy"], "")
    say(f"[14/15 commands] {card}: (a) scripts/local_cluster_torch.py "
        f"--cameras {NCAM} --frames {CLUSTER_FRAMES} at {W}x{H}, servers "
        f"and stitch_cli as processes on loopback: traced (zlib, "
        f"--save-dir, --trace-dir) {traced['frames']} frames, fps "
        f"{traced['fps']:.2f} p50 {traced['p50_latency_ms']:.2f} ms under "
        f"the profiler, {len(plys)} clouds saved ({len(xyz)} points in "
        f"{plys[0]}), trace.json {trace_mib:.1f} MiB with launches "
        + ", ".join(f"{k} {TRACE_KERNELS[k][0]} {seen[k]}" for k in seen)
        + f"; untraced (snappy) {plain['frames']} frames, fps "
        f"{plain['fps']:.2f} p50 {plain['p50_latency_ms']:.2f} ms p99 "
        f"{plain['p99_latency_ms']:.2f} ms, points/s "
        f"{plain['points_per_sec']:.4g}, launcher wall {plain['wall_s']:.1f}"
        f" s (traced {traced['wall_s']:.1f} s)")

    # (b) the JAX positional order on the card
    kb.reset_launches()
    parts = []
    for name, pos, kw in positional_calls(dev):
        a = pos()
        b = kw()
        torch.cuda.synchronize()
        check(bitwise_equal(a, b), f"(b) {name}: the positional call "
                                   "differs from the keyword call")
        parts.append(name)
    launches = dict(kb.LAUNCHES)
    for k in ("segment_sum_from_flags", "segment_sum_sorted",
              "nn_batched_prepared", "nn_batched_prepared_ranged"):
        check(launches.get(k, 0) > 0, f"(b) the calls launched no {k}")
    say(f"    (b) JAX's positional order on the card, each call bit for "
        f"bit its keyword call: {', '.join(parts)}; launches "
        + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))

    # (c) the console scripts' targets, imported with JAX blocked
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    targets = sorted(v for k, v in scripts.items()
                     if k.startswith("pcs-torch-"))
    jax_cmds = [k for k, v in scripts.items()
                if v.startswith("pointcloud_stitching_tpu.")]
    check(len(targets) == len(jax_cmds) == 10
          and all(k.replace("pcs-", "pcs-torch-", 1) in scripts
                  for k in jax_cmds),
          f"(c) pyproject.toml's pcs-torch-* commands: {targets}")
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'pointcloud_stitching_tpu'):"
            "\n    sys.modules[m] = None\n"
            f"for t in {targets!r}:\n"
            "    mod, fn = t.split(':')\n"
            "    assert callable(getattr(importlib.import_module(mod), fn))\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"(c) a pcs-torch-* target did not import "
                                f"with jax blocked:\n{proc.stderr[-3000:]}")
    say(f"    (c) {len(targets)} pcs-torch-* targets imported with jax "
        f"blocked ({proc.stdout.split()[-1]} modules loaded)")
    say(f"    phase 14 took {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
