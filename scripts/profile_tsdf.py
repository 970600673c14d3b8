#!/usr/bin/env python3
"""Where the time of the port's TSDF integrate goes, on one NVIDIA GPU.

Runs ``models.tsdf.integrate`` of the PyTorch port at ``chip_smoke.py``'s
phase-8 design point (4 x 848x480 u16 depth into a 256^3 volume at 1 cm)
and prints, for 'auto' (the brick-pruned path through K5), 'auto' with
uint8 colour and 'dense':

  * the median ms of synced calls, host clock;
  * the host syncs of one call, by source line;
  * a ``torch.profiler`` trace of 3 calls: device busy time and idle share
    per call, kernel launches per call, and the kernels that take the most
    device time.

Run from the repo root on a machine with a GPU:
``python3 scripts/profile_tsdf.py``. It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_tsdf: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.models import tsdf as TM
    from pointcloud_stitching_tpu_torch.utils.platform import (
        set_full_fp32_matmul)

    set_full_fp32_matmul()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}")
    i1 = Intrinsics.create(fx=cs.FX, fy=cs.FY, ppx=cs.W / 2.0,
                           ppy=cs.H / 2.0, width=cs.W, height=cs.H,
                           device=dev)
    intr = i1.stack([i1] * (cs.TSDF_NCAM - 1))
    ext_np, depth_np = cs.tsdf_rig(0)
    ext = torch.from_numpy(ext_np).to(dev)
    depth = torch.from_numpy(depth_np).to(dev)
    color = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (cs.TSDF_NCAM, cs.H, cs.W, 3), dtype=np.uint8)).to(dev)

    for tag, method, with_rgb in (("auto", "auto", False),
                                  ("auto+colour", "auto", True),
                                  ("dense", "dense", False)):
        vol = TM.TSDFVolume.create(cs.TSDF_GRID, cs.TSDF_LEAF,
                                   origin=cs.TSDF_ORIGIN, with_rgb=with_rgb,
                                   device=dev)
        state = {"v": vol}

        def step():
            state["v"] = TM.integrate(state["v"], depth, intr, ext,
                                      color=color if with_rgb else None,
                                      method=method)

        ms = cs.median_ms(step, 7)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sites = collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message))

        calls = 3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / calls
        kern = collections.defaultdict(lambda: [0.0, 0])
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                k = kern[ev.name]
                k[0] += ev.device_time_total / 1e3 / calls   # ms per call
                k[1] += 1
        busy = sum(v[0] for v in kern.values())
        launches = sum(v[1] for v in kern.values()) / calls
        print(f"[{tag}] {card}: {ms:.3f} ms per integrate (median of 7, "
              f"synced); host syncs {sum(sites.values())} {dict(sites)}; "
              f"under the profiler {wall:.3f} ms wall, device busy "
              f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}), "
              f"{launches:.0f} kernel launches per call")
        for name, (t_ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0]
                                      )[:12]:
            print(f"    {t_ms:8.3f} ms  {n / calls:6.0f} x  {name[:100]}")
        del state, vol
    return 0


if __name__ == "__main__":
    sys.exit(main())
