#!/usr/bin/env python3
"""Where the registration extras spend their time, on one NVIDIA GPU.

    python3 scripts/profile_extras.py

On the registration cell of ``chip_smoke.py`` (phase 7's clouds: 113,301
points of one synthetic 848x480 frame in 131,072 slots, dst moved by 0.05
rad / 5 cm with 1 mm noise) it runs ``torch.profiler`` over one call each
of ``estimate_normals`` (r = 5 cm), ``iss_keypoints`` (6 and 4 leaves),
10 GICP iterations (epsilon 0, from the true pose) and ``ndt`` (0.5 m
cells, from identity), and prints per call: the wall ms, the device busy
ms and idle share, the kernel launches, and the device kernels that take
the most time. Last, which batch sizes of 3x3 matrices
``torch.linalg.eigh`` takes on the card (cuSOLVER's batched syev refuses
large batches; ``utils/linalg.py`` cuts them to ``EIGH_BATCH``). It
imports nothing of JAX and prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_extras: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import chip_smoke as C
    from pointcloud_stitching_tpu_torch.ops import (estimate_normals, gicp,
                                                    iss_keypoints, ndt)
    from pointcloud_stitching_tpu_torch.ops.sweep import chunk_rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    dev = torch.device("cuda", 0)
    sc = C.registration_scene(dev)
    src, dst = sc.src, sc.dst
    n = src.xyz.shape[0]
    ns, oks = estimate_normals(src, 0.05)
    nd, okd = estimate_normals(dst, 0.05)
    T = torch.from_numpy(sc.T_true).to(dev)
    runs = {
        f"estimate_normals r 0.05 ({n} slots, chunks of "
        f"{chunk_rows(n, n, 512, 1024)} queries)":
            lambda: estimate_normals(src, 0.05),
        f"iss_keypoints ({chunk_rows(n, n, 256, 512)} queries a chunk)":
            lambda: iss_keypoints(src, 6 * sc.leaf, 4 * sc.leaf),
        "gicp, 10 iterations": lambda: gicp(
            src, dst, ns, nd, oks, okd, init_T=T, max_iterations=10,
            transformation_epsilon=0.0),
        "ndt 0.5 m from identity": lambda: ndt(src, dst, 0.5),
    }
    for name, fn in runs.items():
        fn()
        wall, busy, launches, top = C.device_profile(fn, calls=1)
        print(f"{name}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"(idle share {max(0.0, 1 - busy / wall):.3f}), "
              f"{launches:.0f} launches", flush=True)
        for t, k, kname in top[:8]:
            print(f"    {t:9.3f} ms x{k:.0f} {kname[:110]}", flush=True)
    g = torch.Generator().manual_seed(0)
    for b in (16384, 16385, 32767, 32768, 131072):
        a = torch.randn(b, 3, 3, generator=g).to(dev)
        try:
            torch.linalg.eigh(a @ a.transpose(1, 2))
            print(f"eigh of {b} 3x3 matrices: ok", flush=True)
        except RuntimeError as e:
            print(f"eigh of {b} 3x3 matrices: {str(e)[:60]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
