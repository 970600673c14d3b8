#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 13 alone, on NVIDIA GPUs.

Builds the kernels (as phase 2 does), then runs ``parallel/`` with every
check and time of the phase (see ``chip_smoke.parallel_phase``): on one
GPU in a world of 1 rank over NCCL and a world of 4 ranks over gloo
sharing the card; where four or more GPUs are visible, in a world of 1
over NCCL and a world of 4 over NCCL, one GPU a rank (the path a 4-GPU
host runs). Phase 6's unsharded ms per frame is not measured here. About
50 s on one GPU.

Run from the repo root: ``python3 scripts/parallel_smoke.py``. It imports
nothing of JAX and exits non-zero when a check fails.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("parallel_smoke: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.join(REPO, "tests"))
    import chip_smoke as cs
    from pointcloud_stitching_tpu_torch.kernels import build as kb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t = time.perf_counter()
    info = kb.build()
    kb.library()
    print(f"build: nvcc {info.seconds:.2f} s "
          f"({'cached' if info.cached else 'built'})", flush=True)
    dev = torch.device("cuda", 0)
    worlds = None               # one card: chip_smoke's worlds
    n = torch.cuda.device_count()
    if n >= cs.SHARD_GLOO:
        worlds = [("nccl", "nccl", [dev]),
                  ("nccl, one GPU a rank", "nccl",
                   [torch.device("cuda", r) for r in range(cs.SHARD_GLOO)])]
    print(f"{n} GPU(s) visible", flush=True)
    cs.parallel_phase(dev, card, float("nan"), worlds)
    print(f"parallel_smoke took {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
