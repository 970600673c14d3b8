"""The card's bounds and timers, and the flagship and TSDF scenes.

Shared by ``scripts/roofline_torch.py`` and ``chip_smoke.py``; it holds no
driver logic. It imports torch, numpy and the port, never jax.
"""
from __future__ import annotations

import numpy as np
import torch

from pointcloud_stitching_tpu_torch import Intrinsics, StitchConfig

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA's data sheet)
# H100 SXM float32 instructions per second outside the tensor cores:
# 132 SMs x 128 lanes x 1.98 GHz boost (67 TFLOP/s counts an FMA as two)
F32_INSTR_PER_S = 132 * 128 * 1.98e9
PREFILL_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at 1.98 GHz
FX, FY = 421.5, 421.1        # the flagship's and the TSDF scene's focal px
# bench.py's TSDF scene: three spheres and two planes (n . p = off)
TSDF_SCENE = dict(
    spheres=[((-0.4, 0.1, 1.4), 0.35), ((0.5, -0.2, 1.8), 0.3),
             ((0.0, 0.45, 1.1), 0.2)],
    planes=[((0.0, 0.0, -1.0), -2.4), ((0.0, -1.0, 0.0), -0.8)])


def bound(nbytes: float, ops: float, rate: float = F32_INSTR_PER_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and issue ``ops`` instructions at ``rate`` a second
    (float32 by default)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def cuda_ms(fn, reps: int, prefill: bool = True) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls, by CUDA events.

    With ``prefill`` a spinning kernel holds the card while the host
    enqueues the calls, so the events time the device work back to back
    and not the wrapper's Python; without it the time per call is the
    larger of the two (what a host-bound caller sees)."""
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


def flagship_fields(ncam: int, h: int = 480, w: int = 848) -> dict:
    """bench.py's and __graft_entry__.py's flagship StitchConfig fields."""
    return dict(num_cameras=ncam, height=h, width=w,
                cam_voxel_leaf=0.01, cam_capacity=131072,
                out_voxel_leaf=0.01, out_capacity=262144,
                icp_enabled=True, icp_stride=6, icp_voxel_leaf=0.07,
                icp_capacity=2048, icp_iterations=5, icp_max_corr_dist=0.1,
                icp_query_tile=1024, icp_ref_tile=4096)


def _flagship(ncam: int, h: int = 480, w: int = 848, device="cpu"):
    """__graft_entry__._flagship's scene in numpy, bit for bit: (cfg,
    intr on ``device``, extrinsics [ncam, 4, 4] float32, depths [ncam, h,
    w] uint16): seed 0, translations uniform in [-0.3, 0.3), depths in
    [200, 4000) with 7% zeros."""
    cfg = StitchConfig(**flagship_fields(ncam, h, w))
    rng = np.random.default_rng(0)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[:, :3, 3] = rng.uniform(-0.3, 0.3, (ncam, 3)).astype(np.float32)
    depths = rng.integers(200, 4000, size=(ncam, h, w), dtype=np.uint16)
    depths[rng.random((ncam, h, w)) < 0.07] = 0
    i0 = Intrinsics.create(fx=FX, fy=FY, ppx=w / 2.0, ppy=h / 2.0, width=w,
                           height=h, device=device)
    return cfg, i0.stack([i0] * (ncam - 1)), ext, depths


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
