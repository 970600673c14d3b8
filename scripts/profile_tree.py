#!/usr/bin/env python3
"""Kernel times and stitch-stage spans of one source tree, on one NVIDIA GPU.

    python3 scripts/profile_tree.py [TREE]

imports ``pointcloud_stitching_tpu_torch`` from TREE (default: this
checkout; another checkout, such as an unpacked ``git archive`` of an
earlier commit, works the same way) and prints, on the flagship scene of
``chip_smoke.py`` (8 x 848x480 u16, ring point-to-plane ICP with 5
iterations, a 262144-slot 1 cm output grid):

  * K1 (the global pass at the saturated 1 cm leaf, and at the 6 cm leaf
    into a grid that holds every voxel),
    K2 (the ring-ICP shape and the per-camera 1 cm pass) and K3 (the ring
    shape) on ``chip_smoke.kernel_inputs``, and K4 on
    ``chip_smoke.k4_inputs`` (the first ICP iteration of the registration
    path, 131072 x 131072), timed by ``chip_smoke.time_in_turns``: device
    time, the card held by a spinning kernel while the calls are enqueued
    (20, for K4 5), and the time per call back to back; and the host time
    per call of the wrapper and of the plain version (calls enqueued, no
    sync: Python and launches alone). K2 is also timed on the camera
    pass's rows with ids that never repeat (no run crosses a tile), to set
    the cost of its look-back chains apart; and the ms per pruned ICP
    iteration (K3 coarse pass + K4 + solve) on the same clouds, with the
    device's busy time per iteration from ``torch.profiler``;
  * per stitch stage and frame, mean of 20 frames of the real
    ``StitchingPipeline`` with the kernels ('auto') and with the plain
    versions ('torch'): host ms and device span (CUDA events) of each call
    that ``stitch_step`` makes to ``deproject``, ``grid_normals``,
    ``voxel_downsample`` (first the ICP pass, then the global pass) and
    ``_ring_drift_correction``, timed by wrappers set on the stitcher
    module for the run, and within the ICP voxel pass its call to
    ``segment_sum_sorted`` (K2's wrapper or plain version); the rest of the
    frame (world transform, fuse, glue) is the frame less the stages;
  * ``torch.profiler`` over 5 'auto' frames: device operations per frame,
    device busy time per frame, the idle share of an unprofiled frame, and
    the device time of the port's kernels.

To compare two trees, run it on each in turns within one call (parent,
change, change, parent): times of host-bound code vary between calls.
It imports nothing of JAX and prints the card's name and power limit first.
"""
from __future__ import annotations

import collections
import importlib.util
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 20
STAGES = {"deproject": "deproject",
          "grid_normals": "grid normals (ICP grid)",
          "voxel_downsample": "ICP voxel pass (sort + K2)",
          "_ring_drift_correction": "ring ICP (5 x K3 + trim + solve)",
          "voxel_downsample#2": "global voxel pass (sort + K1)"}
# timed inside the ICP voxel pass, not a stage of its own
INNER = {"segment_sum_sorted": "  of which segment_sum_sorted"}


def host_ms(fn, reps: int = 20) -> float:
    """Host ms per call of ``fn`` over ``reps`` calls that are only
    enqueued (the card runs them after)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def stage_times(ST, V, pipe, depths):
    """{stage: (host ms, device span ms)} per frame over FRAMES frames of
    ``pipe``, with timers wrapped around the stage functions of the
    stitcher module ``ST`` and the INNER ones of the voxel module ``V``;
    'frame' is the whole call, 'rest' the frame less the stages. The
    pipeline runs its ICP stage eagerly here: a replayed stage calls none
    of the wrapped functions."""
    import torch
    calls = []
    pipe._icp_stage = ST._icp_stage

    def timed(name, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls.append((name, time.perf_counter() - t, a, b))
            b.record()
            return out
        return run

    names = [(ST, n) for n in STAGES if "#" not in n] + [(V, n) for n in INNER]
    real = {n: getattr(m, n) for m, n in names}
    host = collections.Counter()
    span = collections.Counter()
    try:
        for m, n in names:
            setattr(m, n, timed(n, real[n]))
        for f in range(FRAMES + 3):
            calls.clear()
            torch.cuda.synchronize()
            fa = torch.cuda.Event(enable_timing=True)
            fb = torch.cuda.Event(enable_timing=True)
            fa.record()
            t = time.perf_counter()
            pipe(depths)
            dt = time.perf_counter() - t
            fb.record()
            torch.cuda.synchronize()
            if f < 3:
                continue
            host["frame"] += dt
            span["frame"] += fa.elapsed_time(fb) / 1e3
            seen = collections.Counter()
            for name, h, a, b in calls:
                seen[name] += 1
                key = name if seen[name] == 1 else f"{name}#{seen[name]}"
                host[key] += h
                span[key] += a.elapsed_time(b) / 1e3
    finally:
        for m, n in names:
            setattr(m, n, real[n])
    for c in (host, span):
        c["rest"] = c["frame"] - sum(c[k] for k in STAGES)
    keys = [*list(STAGES)[:3], *INNER, *list(STAGES)[3:], "rest", "frame"]
    return {STAGES.get(k, INNER.get(k, k)): (host[k] * 1e3 / FRAMES,
                                             span[k] * 1e3 / FRAMES)
            for k in keys}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_tree: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(REPO, "tests"))    # oracle.py's scenes
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    import pointcloud_stitching_tpu_torch as P
    from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
        nn_batched_prepared, nn_batched_prepared_ranged)
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        segment_sum_from_flags, segment_sum_sorted)
    from pointcloud_stitching_tpu_torch.models import stitcher as ST
    from pointcloud_stitching_tpu_torch.ops import icp
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"tree {tree} (package {os.path.dirname(P.__file__)})",
          flush=True)
    dev = torch.device("cuda", 0)
    ki = CS.kernel_inputs(dev)
    P.StitchingPipeline(CS.flagship_cfg(P.StitchConfig), ki.intr, ki.ext_np,
                        device=dev)                     # TF32 off

    vals, flags = ki.k1
    q, _, _, refT = ki.k3
    # (name, fn(impl), timed calls per turn)
    vals6, flags6 = ki.k1_exact
    cases = [("K1 segment_sum_from_flags, 1 cm (packed, saturated)",
              lambda impl: segment_sum_from_flags(vals, flags, 262144,
                                                  impl=impl), 20),
             ("K1 segment_sum_from_flags, 6 cm (exact) into 2^21 slots: "
              "every row kept",
              lambda impl: segment_sum_from_flags(vals6, flags6, 2 ** 21,
                                                  impl=impl), 20)]
    for tag, v, s, c in ki.k2:
        cases.append((f"K2 segment_sum_sorted, {tag}",
                      lambda impl, v=v, s=s, c=c: segment_sum_sorted(
                          v, s, c, impl=impl), 20))
    _, v_cam, s_cam, c_cam = ki.k2[-1]
    s_flat = torch.arange(s_cam.numel(), dtype=torch.int32, device=dev)
    cases.append(("K2 segment_sum_sorted, camera pass's rows, ids that "
                  "never repeat", lambda impl: segment_sum_sorted(
                      v_cam, s_flat, c_cam, impl=impl), 20))
    cases.append(("K3 nn_batched_prepared, ring", lambda impl:
                  nn_batched_prepared(q, refT, impl=impl), 20))
    scene = CS.registration_scene(dev)
    k4 = CS.k4_inputs(dev, scene)
    cases.append(("K4 nn_batched_prepared_ranged, registration",
                  lambda impl: nn_batched_prepared_ranged(
                      k4.q, k4.refT, k4.jlo, k4.jhi,
                      query_tile=CS.K4_QUERY_TILE, ref_block=CS.K4_REF_BLOCK,
                      impl=impl), 5))
    print("kernels: device ms (card held) / per call back to back / plain "
          "device ms; host ms per call: wrapper / plain")
    for name, fn, reps in cases:
        ms, plain_ms, call_ms = CS.time_in_turns(lambda: fn("cuda"),
                                                 lambda: fn("torch"), reps)
        h_k = host_ms(lambda: fn("cuda"), reps)
        h_p = host_ms(lambda: fn("torch"), reps)
        print(f"    {name}: {ms:.4f} / {call_ms:.4f} / {plain_ms:.4f}; "
              f"host {h_k:.4f} / {h_p:.4f}", flush=True)

    # the pruned ICP iteration: host clock is noisy on a shared host, so
    # six readings, least and median; then one profiled call for the
    # device's share of it
    k = 5

    def icp_call():
        return icp(scene.src, scene.dst, init_T=k4.T0, iterations=k,
                   max_corr_dist=0.25, nn_impl="auto", prune=True)

    icp_call()
    torch.cuda.synchronize()
    reads = sorted(CS.cuda_ms(icp_call, 4, prefill=False) / k
                   for _ in range(6))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        icp_call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3 / k
    print(f"pruned ICP (K3 coarse + K4 + solve), ms per iteration at 131072 "
          f"x 131072 (CUDA events over {k}-iteration icp calls, 6 readings "
          f"of 4 calls): least {reads[0]:.3f}, median "
          f"{(reads[2] + reads[3]) / 2:.3f}, most {reads[-1]:.3f}; profiler "
          f"over one call: device busy {busy:.3f} ms per iteration in "
          f"{sum(e.count for e in kern) / k:.0f} device operations",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.device_time_total)[:4]:
        print(f"    {e.key[:60]}: {e.count / k:.1f} per iteration, "
              f"{e.device_time_total / e.count:.2f} us each")
    del ki.k2, vals, flags, vals6, flags6, cases, k4, scene, v_cam, s_cam
    del s_flat

    for impl in ("auto", "torch"):
        cfg = CS.flagship_cfg(P.StitchConfig, kernel_impl=impl)
        pipe = P.StitchingPipeline(cfg, ki.intr, ki.ext_np, device=dev,
                                   update_mode="track")
        res = stage_times(ST, V, pipe, ki.depths)
        print(f"stages, kernel_impl={impl!r}: host ms / device span ms per "
              f"frame (mean of {FRAMES})")
        for name, (h, sp) in res.items():
            print(f"    {name}: {h:.3f} / {sp:.3f}", flush=True)

    pipe = P.StitchingPipeline(CS.flagship_cfg(P.StitchConfig), ki.intr,
                               ki.ext_np, device=dev, update_mode="track")
    for _ in range(3):
        pipe(ki.depths)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(FRAMES):
        pipe(ki.depths)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t) * 1e3 / FRAMES
    frames = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            pipe(ki.depths)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3 / frames
    ops = sum(e.count for e in kern) / frames
    print(f"'auto' frames: {frame_ms:.3f} ms per frame unprofiled (mean of "
          f"{FRAMES}); profiler over {frames} frames: {ops:.0f} device "
          f"operations per frame, device busy {busy:.3f} ms per frame (idle "
          f"share {1 - busy / frame_ms:.3f} of the unprofiled frame)")
    for e in sorted(kern, key=lambda e: -e.device_time_total):
        if any(k in e.key for k in ("segsum", "tile_", "nn_batched",
                                    "nn_ranged")):
            print(f"    {e.key[:60]}: {e.count / frames:.0f} per frame, "
                  f"{e.device_time_total / e.count:.2f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
