#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one NVIDIA GPU: bench.py's rows.

Prints, as its last line, ONE JSON object with bench.py's keys:
  metric: stitched points/s of the 8-camera 848x480 flagship frame with 5
          ICP iterations per ring pair, through the port's ``stitch_step``
          with ``kernel_impl='auto'`` (K1, K2, K3 on the card);
  vs_baseline: the value over the reference's design point, 8 cameras x
          848x480 x 30 FPS = 97,689,600 points/s (bench.py:6-10);
  extras: bench.py's scalar extras under its names, the headline values of
          its nested blocks (``streaming_4cam``, ``tsdf``, ``roofline``) and
          ``card`` (``nvidia-smi --query-gpu=name,power.limit``).
The last line is at most 1800 characters. The per-turn times, the stream's
windows, stage means and probes, the whole TSDF block, the roofline's rows,
the kernels' launches and the build's seconds go on earlier lines, each one
JSON object with a "section" key.

The rows, in bench.py's order: the 8-camera flagship (refined extrinsics
fed back, 8 warm-up frames, 30 timed), 16 cameras, 8 cameras with colour,
the structured scene with the output-leaf autofit, the 4-camera p50
latency, the 4-camera loopback stream (fake camera servers, snappy where
the native codec builds, the pipelined client), the TSDF model (4 x
848x480 into 256^3 at 1 cm; the pruned K5 path, the dense path, colour,
raycast, track), the per-stage roofline (``scripts/roofline_torch.py``) and
the ratio to the CPU baseline of ``BENCH_CPU.json``.

Timing: every stitch row runs TURNS windows of frames, each closed by one
scalar pull and less one sync round trip (``sync_rtt_ms``: the pull of a
device scalar), as bench.py defines its windows; the row's seconds per
frame are the windows' summed time over their summed frames, so a stall
in any window counts. Host times spread on a shared host, so each
window's seconds per frame are printed too. A row that fails, or that launched none of its
kernels, ends the run with a non-zero exit.

Run on the card: ``python3 bench_torch.py`` (15-25 s after the build on
an H100). Without a GPU it exits non-zero before any work. It imports torch,
numpy and the port, never jax.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from bench_card import (FX, FY, TSDF_SCENE, _flagship, flagship_fields,
                        intrinsics, render_depth)
from pointcloud_stitching_tpu_torch import (Codec, FakeCameraServer,
                                            Intrinsics, MulticameraClient,
                                            StitchConfig, StitchingPipeline,
                                            native, stitch_step,
                                            synthetic_frames)
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.models import tsdf as TM
from pointcloud_stitching_tpu_torch.models.stitcher import autofit_out_leaf
from pointcloud_stitching_tpu_torch.utils.platform import (
    platform_device, set_full_fp32_matmul)

REPO = os.path.dirname(os.path.abspath(__file__))
METRIC = "stitched points/sec/chip (8cam 848x480, 5 ICP iters/pair/frame)"
DESIGN_POINT = 8 * 848 * 480 * 30   # the reference's implied realtime rate
MAX_LINE = 1800                     # the last line's length limit
TURNS = 3
# the kernels' names in kernels.build.LAUNCHES
K1, K2, K3, K5 = ("segment_sum_from_flags", "segment_sum_sorted",
                  "nn_batched_prepared", "patch_gather")
STITCH_KERNELS = (K1, K2, K3)


def occupied_1cm(depths: np.ndarray, ext: np.ndarray) -> int:
    """Occupied 1 cm voxels of a [ncam, h, w] uint16 scene seen from
    ``ext``, counted in numpy as bench.py counts them (the device grid is
    capacity-bounded and cannot say this itself)."""
    ncam, h, w = depths.shape
    zs = depths.astype(np.float32) * 0.001
    u = np.arange(w, dtype=np.float32) - w / 2.0
    v = np.arange(h, dtype=np.float32) - h / 2.0
    pts = []
    for i in range(ncam):
        z = zs[i]
        m = (z > 0.1) & (z < 10.0)
        p = np.stack([(u[None, :] * z) / FX, (v[:, None] * z) / FY, z],
                     -1)[m]
        pts.append(p @ ext[i, :3, :3].T + ext[i, :3, 3])
    ijk = np.floor(np.concatenate(pts) / 0.01).astype(np.int64)
    ijk -= ijk.min(axis=0)
    key = ((ijk[:, 0] * (ijk[:, 1].max() + 1) + ijk[:, 1])
           * (ijk[:, 2].max() + 1) + ijk[:, 2])
    return int(np.unique(key).size)


def _drain(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sync(out) -> int:
    """bench.py's sync: pull the frame's output count."""
    return int(out.metrics.points_out)


def sync_rtt_s(dev, reps: int = 6) -> float:
    """Median seconds of one pull of a device scalar (``.item()``)."""
    z = torch.zeros((), device=dev)
    vals = []
    for _ in range(reps):
        t = time.perf_counter()
        (z + 1.0).item()
        vals.append(time.perf_counter() - t)
    return float(np.median(vals))


def _turns(step, frames: int, turns: int, dev):
    """``turns`` windows of ``frames`` calls of ``step``, each closed by
    one pull and less one sync round trip. Returns (seconds per frame over
    all the windows: their summed time over their summed frames; each
    window's seconds per frame; the last output)."""
    windows, out = [], None
    for _ in range(turns):
        _drain(dev)
        t0 = time.perf_counter()
        for _ in range(frames):
            out = step()
        _sync(out)
        windows.append(time.perf_counter() - t0 - sync_rtt_s(dev))
    return (sum(windows) / (frames * turns), [t / frames for t in windows],
            out)


def flagship_row(dev, ncam: int = 8, h: int = 480, w: int = 848,
                 warmup: int = 8, frames: int = 30, turns: int = TURNS):
    """bench.py:350-381: the flagship frame, refined extrinsics fed back
    each frame. Returns (row, the refined extrinsics)."""
    cfg, intr, ext, depths = _flagship(ncam, h, w, dev)
    depths = torch.from_numpy(depths).to(dev)
    state = {"ext": torch.from_numpy(ext).to(dev)}

    def step():
        out = stitch_step(cfg, intr, state["ext"], depths)
        state["ext"] = out.extrinsics
        return out

    _drain(dev)
    t0 = time.perf_counter()
    _sync(step())
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        out = step()
    _sync(out)
    frame_s, per_turn, out = _turns(step, frames, turns, dev)
    row = dict(frame_s=frame_s, frame_s_turns=per_turn,
               pixels=ncam * h * w, compile_s=compile_s,
               fused_voxels=_sync(out), capacity=cfg.out_capacity)
    return row, state["ext"]


def _fixed_row(dev, cfg, intr, ext, depths, colors, frames: int,
               turns: int) -> dict:
    """Frames on fixed inputs after one warm frame (bench.py's 16-camera
    and coloured rows)."""
    def step():
        return stitch_step(cfg, intr, ext, depths, colors)

    _sync(step())
    frame_s, per_turn, _ = _turns(step, frames, turns, dev)
    return dict(frame_s=frame_s, frame_s_turns=per_turn,
                pixels=cfg.num_cameras * cfg.height * cfg.width)


def cams_row(dev, ncam: int = 16, h: int = 480, w: int = 848,
             frames: int = 15, turns: int = TURNS) -> dict:
    """bench.py:383-390: the flagship scene at ``ncam`` cameras."""
    cfg, intr, ext, depths = _flagship(ncam, h, w, dev)
    return _fixed_row(dev, cfg, intr, torch.from_numpy(ext).to(dev),
                      torch.from_numpy(depths).to(dev), None, frames, turns)


def colored_row(dev, ext, ncam: int = 8, h: int = 480, w: int = 848,
                frames: int = 15, turns: int = TURNS) -> dict:
    """bench.py:392-403: the flagship with uint8 colours from seed 1 (K1
    at 10 channels), at the refined extrinsics ``ext``."""
    cfg, intr, _, depths = _flagship(ncam, h, w, dev)
    cfg = dataclasses.replace(cfg, with_color=True)
    colors = np.random.default_rng(1).integers(0, 256, (ncam, h, w, 3),
                                               dtype=np.uint8)
    return _fixed_row(dev, cfg, intr, ext, torch.from_numpy(depths).to(dev),
                      torch.from_numpy(colors).to(dev), frames, turns)


def structured_row(dev, ncam: int = 8, h: int = 480, w: int = 848,
                   fit_frames: int = 12, frames: int = 15,
                   turns: int = TURNS, out_capacity: int | None = None,
                   ceil: float = 0.04) -> dict:
    """bench.py:405-457: ``synthetic_frames`` (seeds 0..ncam-1) at the
    flagship extrinsics, the output leaf a device scalar fed through
    ``autofit_out_leaf`` for ``fit_frames`` synced frames, then timed at
    the converged leaf; and the occupied 1 cm voxels of both scenes."""
    cfg, intr, ext_np, flag_depths = _flagship(ncam, h, w, dev)
    if out_capacity is not None:
        cfg = dataclasses.replace(cfg, out_capacity=out_capacity)
    sd_np = np.stack([synthetic_frames(1, h, w, seed=s)[0]
                      for s in range(ncam)])
    sd = torch.from_numpy(sd_np).to(dev)
    ext = torch.from_numpy(ext_np).to(dev)
    leaf = torch.full((), cfg.out_voxel_leaf, dtype=torch.float32,
                      device=dev)
    leaves, frames_to_fit = [], None
    for i in range(fit_frames):
        out = stitch_step(cfg, intr, ext, sd, out_leaf=leaf)
        n = _sync(out)   # a pull per frame: the convergence probe, untimed
        leaf = autofit_out_leaf(out.metrics.points_out, leaf,
                                capacity=cfg.out_capacity,
                                floor=cfg.out_voxel_leaf, ceil=ceil)
        leaves.append(float(leaf))
        if frames_to_fit is None and n < cfg.out_capacity:
            frames_to_fit = i + 1
    frame_s, per_turn, out = _turns(
        lambda: stitch_step(cfg, intr, ext, sd, out_leaf=leaf), frames,
        turns, dev)
    return dict(frame_s=frame_s, frame_s_turns=per_turn,
                fused_voxels=_sync(out), capacity=cfg.out_capacity,
                out_leaf=float(leaf), leaves=leaves,
                frames_to_fit=frames_to_fit,
                occupied={"flagship_scene": occupied_1cm(flag_depths, ext_np),
                          "structured_scene": occupied_1cm(sd_np, ext_np)})


def p50_row(dev, ncam: int = 4, h: int = 480, w: int = 848,
            frames: int = 10) -> dict:
    """bench.py:459-476: the p50 of synced frames at ``ncam`` cameras, and
    the sync round trip measured between them."""
    cfg, intr, ext, depths = _flagship(ncam, h, w, dev)
    ext = torch.from_numpy(ext).to(dev)
    depths = torch.from_numpy(depths).to(dev)
    _sync(stitch_step(cfg, intr, ext, depths))
    lats, rtts = [], []
    for _ in range(frames):
        t = time.perf_counter()
        _sync(stitch_step(cfg, intr, ext, depths))
        lats.append(time.perf_counter() - t)
        rtts.append(sync_rtt_s(dev, reps=1))
    p50_raw = float(np.median(lats)) * 1e3
    rtt = float(np.median(rtts)) * 1e3
    return dict(p50_raw_ms=p50_raw, rtt_ms=rtt,
                p50_device_ms=max(p50_raw - rtt, 0.0), latencies_s=lats)


def _probe_env(frame: np.ndarray, dev, reps: int = 4):
    """bench.py:70-95: (sync round trip s, host-to-device s per frame),
    the copy a fresh numpy frame to the device and a synced sum."""
    rtt = sync_rtt_s(dev, reps)
    ts = []
    for i in range(reps):
        fresh = frame + np.uint16(i + 1)   # defeat any host-side caching
        t0 = time.perf_counter()
        torch.from_numpy(fresh).to(dev).to(torch.int32).sum().item()
        ts.append(time.perf_counter() - t0)
    return rtt, max(float(np.median(ts)) - rtt, 1e-4)


def stream_row(dev, ncam: int = 4, h: int = 480, w: int = 848,
               rounds: int = 4, frames: int = 20,
               first_frames_s: float = 20.0) -> dict:
    """bench.py:27-201: loopback fake camera servers (snappy where the
    native codec builds) -> ``MulticameraClient`` -> the flagship pipeline,
    ``rounds`` rounds of a synced window (``sync_every=1``) and a pipelined
    one (``sync_every=8``), each bracketed by environment probes."""
    codec = Codec.SNAPPY if native.available() else Codec.RAW
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    for i in range(ncam):
        ext[i, :3, 3] = np.array([0.1 * i, -0.05 * i, 0.02 * i], np.float32)
    pipe = StitchingPipeline(StitchConfig(**flagship_fields(ncam, h, w)),
                             intrinsics(ncam, h, w, dev), ext, device=dev)
    frame = np.stack([synthetic_frames(1, h, w, seed=s)[0]
                      for s in range(ncam)])   # the benchmark's payload
    servers, client = [], None
    try:
        for s in range(ncam):
            servers.append(FakeCameraServer(
                synthetic_frames(8, h, w, seed=s), codec=codec).start())
        client = MulticameraClient([("127.0.0.1", srv.port)
                                    for srv in servers], pipe).start()
        if not client.wait_for_first_frames(timeout=first_frames_s):
            raise RuntimeError("no frames from the loopback servers: "
                               f"{client.camera_errors()}")
        if client.step() is None:
            raise RuntimeError("the warm-up step found no live camera")
        _probe_env(frame, dev)
        fps_sync, fps_pipe, p50s, rtts, h2ds = [], [], [], [], []
        eff_sync, eff_pipe = [], []
        stages_sync = stages_pipe = None
        # each window's efficiency divides by the probes bracketing it
        rtt_a, h2d_a = _probe_env(frame, dev)
        for _ in range(rounds):
            client.stages.reset()
            client.metrics.reset()
            s = client.run(num_frames=frames, overlap=True).summary()
            fps_sync.append(s["fps"])
            p50s.append(s["p50_latency_ms"])
            stages_sync = client.stages.summary()
            rtt_s, h2d_s = _probe_env(frame, dev)
            eff_sync.append(s["fps"] * ((h2d_a + h2d_s) / 2
                                        + (rtt_a + rtt_s) / 2))
            client.stages.reset()
            t0 = time.perf_counter()
            client.run(num_frames=frames, overlap=True, sync_every=8)
            dt = time.perf_counter() - t0   # run() drains the last frame
            fps_pipe.append(frames / dt)
            stages_pipe = client.stages.summary()
            rtt, h2d = _probe_env(frame, dev)
            eff_pipe.append((frames / dt) * (h2d_s + h2d) / 2)
            rtts.append((rtt_s + rtt) / 2)
            h2ds.append((h2d_s + h2d) / 2)
            rtt_a, h2d_a = rtt, h2d
    finally:
        if client is not None:
            client.stop()
        for srv in servers:
            srv.stop()
    rtt, h2d = float(np.median(rtts)), float(np.median(h2ds))
    return {
        "fps_e2e": float(np.median(fps_sync)),
        "fps_e2e_windows": fps_sync,
        "fps_e2e_pipelined": float(np.median(fps_pipe)),
        "fps_e2e_pipelined_windows": fps_pipe,
        "p50_latency_ms_e2e": float(np.median(p50s)),
        "codec": codec.name.lower(),
        "stages_ms": stages_sync,
        "stages_ms_pipelined": stages_pipe,
        "env_bounds": {
            "bytes_per_frame": int(frame.nbytes),
            "h2d_ms_per_frame": h2d * 1e3,
            "h2d_mbps": frame.nbytes / 2 ** 20 / h2d,
            "sync_rtt_ms": rtt * 1e3,
            "fps_bound_sync_each_frame": 1.0 / (h2d + rtt),
            "fps_bound_pipelined": 1.0 / h2d,
        },
        "efficiency_vs_bound_sync": float(np.median(eff_sync)),
        "efficiency_vs_bound_pipelined": float(np.median(eff_pipe)),
    }


def tsdf_scene(ncam: int = 4, h: int = 480, w: int = 848):
    """bench.py:226-244: ``ncam`` cameras 25 cm apart, each turned 0.12
    rad about y from its neighbour, one dead rectangle each. Returns
    (extrinsics [ncam, 4, 4] float32, depth [ncam, h, w] uint16 mm)."""
    exts, ds = [], []
    for i in range(ncam):
        ang = 0.12 * (i - 1.5)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                              [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        T[:3, 3] = [0.25 * (i - 1.5), 0.0, -0.05 * i]
        d = render_depth(FX, FY, w / 2.0, h / 2.0, w, h, T, **TSDF_SCENE)
        d[140 + 30 * i:220 + 30 * i, 280:420] = 0.0   # dead rectangle
        exts.append(T)
        ds.append(d)
    return np.stack(exts), (np.stack(ds) * 1000.0).astype(np.uint16)


def tsdf_row(dev, ncam: int = 4, h: int = 480, w: int = 848,
             grid=(256, 256, 256), leaf: float = 0.01,
             origin=(-1.28, -0.6, 0.2), reps=(6, 4, 4, 4, 4, 3)) -> dict:
    """bench.py:204-313: integrate by the pruned path ('mxu_pallas', K5),
    the dense path and the pruned path with colour; the pruned volume
    against the dense one bit for bit; raycast with and without the
    prior; track. Each time is the median of synced calls, less one sync
    round trip."""
    ext_np, depth_np = tsdf_scene(ncam, h, w)
    ext = torch.from_numpy(ext_np).to(dev)
    depth = torch.from_numpy(depth_np).to(dev)
    intr = intrinsics(ncam, h, w, dev)
    i1 = Intrinsics.create(fx=FX, fy=FY, ppx=w / 2.0, ppy=h / 2.0, width=w,
                           height=h, device=dev)
    color = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (ncam, h, w, 3), dtype=np.uint8)).to(dev)

    def volume(with_rgb=False):
        return TM.TSDFVolume.create(grid, leaf, origin=origin,
                                    with_rgb=with_rgb, device=dev)

    def timeit(step, n):
        step()                          # first run
        float(step().sum())             # one synced warm call
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            float(step().sum())
            ts.append(time.perf_counter() - t0)
        return max(0.0, float(np.median(ts)) - sync_rtt_s(dev)) * 1e3

    def integ(method, with_rgb):
        state = {"v": volume(with_rgb)}

        def step():
            state["v"] = TM.integrate(state["v"], depth, intr, ext,
                                      method=method,
                                      color=color if with_rgb else None)
            return state["v"].tsdf
        return step

    res = {"integrate_ms_mxu_pallas": timeit(integ("mxu_pallas", False),
                                             reps[0]),
           "integrate_ms_dense": timeit(integ("dense", False), reps[1]),
           "integrate_ms_mxu_pallas_rgb": timeit(integ("mxu_pallas", True),
                                                 reps[2])}
    vd = TM.integrate(volume(), depth, intr, ext, method="dense")
    vm = TM.integrate(volume(), depth, intr, ext, method="mxu_pallas")
    res["integrate_bitwise_mxu_vs_dense"] = bool(
        torch.equal(vd.tsdf, vm.tsdf) and torch.equal(vd.weight, vm.weight))
    T0, d0 = ext[0], depth[0]
    res["raycast_prior_ms"] = timeit(
        lambda: TM.raycast(vm, i1, T0, stride=2, prior_depth=d0).depth,
        reps[3])
    res["raycast_full_ms"] = timeit(
        lambda: TM.raycast(vm, i1, T0, stride=2).depth, reps[4])
    res["track_ms"] = timeit(
        lambda: TM.track(vm, d0, i1, T0, prior_window=0.3).T, reps[5])
    return res


def roofline_row(dev) -> dict:
    """bench.py:496-501: scripts/roofline_torch.py's quick collect."""
    spec = importlib.util.spec_from_file_location(
        "roofline_torch", os.path.join(REPO, "scripts", "roofline_torch.py"))
    roofline_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline_torch)
    return roofline_torch.collect(quick=True, device=dev)


def cpu_baseline_pps():
    """bench.py:505-516: BENCH_CPU.json's cpu_pps, or None."""
    path = os.path.join(REPO, "BENCH_CPU.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("cpu_pps")


def last_line(r: dict) -> str:
    """bench.py's last line from the rows' results ``r`` (keys: flagship,
    cams16, colored, structured, p50, sync_rtt_s, stream, tsdf, roofline,
    cpu_pps, card), at most MAX_LINE characters."""
    f, c16, col, st = r["flagship"], r["cams16"], r["colored"], \
        r["structured"]
    dt, dt16, dt8c, dts = (f["frame_s"], c16["frame_s"], col["frame_s"],
                           st["frame_s"])
    pps = f["pixels"] / dt
    cpu = r["cpu_pps"]
    s = r["stream"]
    full = r["roofline"]["rows"][-1]
    line = json.dumps({
        "metric": METRIC,
        "value": round(pps, 0),
        "unit": "points/s",
        "vs_baseline": round(pps / DESIGN_POINT, 3),
        "extras": {
            "vs_cpu_baseline": round(pps / cpu, 1) if cpu else None,
            "cpu_baseline_pps": cpu,
            "frame_time_ms_8cam": round(dt * 1e3, 2),
            "fps_8cam": round(1.0 / dt, 2),
            "p50_latency_ms_4cam_device": round(r["p50"]["p50_device_ms"], 2),
            "p50_latency_ms_4cam_raw": round(r["p50"]["p50_raw_ms"], 2),
            "sync_rtt_ms": round(r["sync_rtt_s"] * 1e3, 3),
            "sync_rtt_ms_at_p50_stage": round(r["p50"]["rtt_ms"], 3),
            "compile_s": round(f["compile_s"], 2),
            "fused_voxels": f["fused_voxels"],
            "fused_voxels_at_capacity": f["fused_voxels"] >= f["capacity"],
            "occupied_1cm_voxels": st["occupied"],
            "frame_time_ms_8cam_structured": round(dts * 1e3, 2),
            "fps_8cam_structured": round(1.0 / dts, 2),
            "fused_voxels_structured": st["fused_voxels"],
            "structured_unsaturated": st["fused_voxels"] < st["capacity"],
            "out_leaf_structured_m": round(st["out_leaf"], 5),
            "autofit_frames_to_fit": st["frames_to_fit"],
            "frame_time_ms_16cam": round(dt16 * 1e3, 2),
            "fps_16cam": round(1.0 / dt16, 2),
            "pps_16cam": round(c16["pixels"] / dt16, 0),
            "frame_time_ms_8cam_colored": round(dt8c * 1e3, 2),
            "fps_8cam_colored": round(1.0 / dt8c, 2),
            "streaming_4cam": {
                "fps_e2e": round(s["fps_e2e"], 2),
                "fps_e2e_pipelined": round(s["fps_e2e_pipelined"], 2),
                "p50_latency_ms_e2e": round(s["p50_latency_ms_e2e"], 2),
                "codec": s["codec"],
                "efficiency_vs_bound_sync":
                    round(s["efficiency_vs_bound_sync"], 4),
                "efficiency_vs_bound_pipelined":
                    round(s["efficiency_vs_bound_pipelined"], 4)},
            "tsdf": {k: (v if isinstance(v, bool) else round(v, 2))
                     for k, v in r["tsdf"].items()},
            "roofline": {k: round(full[k], 4)
                         for k in ("ms", "sol_ms", "alg_ms", "x_alg")},
            "card": r["card"],
        },
    })
    if len(line) > MAX_LINE:
        raise ValueError(f"the last line has {len(line)} characters, more "
                         f"than {MAX_LINE}")
    return line


def emit(section: str, **body) -> None:
    print(json.dumps({"section": section, **body}), flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        dev = platform_device()
    except (RuntimeError, ValueError) as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 2
    if dev.type != "cuda":
        print("bench_torch: times the card; PCS_PLATFORM=cpu runs its row "
              "functions at small sizes only (tests/test_torch_bench.py)",
              file=sys.stderr)
        return 2
    set_full_fp32_matmul()
    card = card_line()
    t0 = time.perf_counter()
    info = kb.build()
    kb.library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_s=info.seconds,
         cached=info.cached, device=torch.cuda.get_device_name(dev),
         card=card, torch=torch.__version__, cuda=torch.version.cuda)

    t_run = time.perf_counter()
    launches, expect = {}, {}

    def row(name, kernels, fn, *args):
        kb.reset_launches()
        out = fn(*args)
        _drain(dev)
        launches[name], expect[name] = dict(kb.LAUNCHES), kernels
        return out

    r = {"card": card, "sync_rtt_s": sync_rtt_s(dev, reps=10)}
    r["flagship"], ext_cur = row("flagship_8cam", STITCH_KERNELS,
                                 flagship_row, dev)
    r["cams16"] = row("cams_16", STITCH_KERNELS, cams_row, dev)
    r["colored"] = row("colored_8cam", STITCH_KERNELS, colored_row, dev,
                       ext_cur)
    r["structured"] = row("structured_8cam", STITCH_KERNELS, structured_row,
                          dev)
    r["p50"] = row("p50_4cam", STITCH_KERNELS, p50_row, dev)
    r["stream"] = row("streaming_4cam", STITCH_KERNELS, stream_row, dev)
    r["tsdf"] = row("tsdf", (K5,), tsdf_row, dev)
    r["roofline"] = row("roofline", STITCH_KERNELS, roofline_row, dev)
    r["cpu_pps"] = cpu_baseline_pps()

    emit("turns", **{k: r[k]["frame_s_turns"] for k in
                     ("flagship", "cams16", "colored", "structured")},
         structured_leaves=r["structured"]["leaves"],
         p50_latencies_s=r["p50"]["latencies_s"])
    emit("streaming_4cam", **r["stream"])
    emit("tsdf", grid="256^3 @ 1 cm", frame="4x848x480 u16", **r["tsdf"])
    emit("roofline", **r["roofline"])
    emit("launches", **launches)
    missing = [f"{name}: {k}" for name, ks in expect.items() for k in ks
               if launches[name].get(k, 0) == 0]
    if missing:
        print(f"bench_torch: kernels not launched: {missing}",
              file=sys.stderr)
        return 1
    if not r["tsdf"]["integrate_bitwise_mxu_vs_dense"]:
        print("bench_torch: the pruned integrate differs from the dense one",
              file=sys.stderr)
        return 1
    line = last_line(r)
    emit("run", seconds_after_build=time.perf_counter() - t_run,
         last_line_chars=len(line))
    print(card, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
