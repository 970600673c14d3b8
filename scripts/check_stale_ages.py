"""How old a healthy loopback camera's frame gets before stitch_cli's client
snapshots it, with the in-process view and the profiler on.

The client drops a camera from a frame's batch when its newest frame is
older than ``stale_timeout`` (0.5 s by default), and a frame stitched
without a camera is not the full rig's cloud. This script drives
``chip_smoke.py`` phase 12's rig (8 fake servers in this process, 480x848,
snappy) the way that phase does: a 30-frame ``stitch_cli`` run, then a
5-frame run with ``--view --view-dir`` and ``--trace-dir``, ``--rounds``
times. Each snapshot's oldest frame age and its count of live cameras are
recorded, and every saved cloud of the second run is held against the
direct call on all cameras.

Run on a GPU from the repo root:

    python scripts/check_stale_ages.py [--rounds 14] [--stale 0.5]

It prints one line per round and a summary; it exits 1 if a camera was
dropped or a saved cloud differs.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=14)
    ap.add_argument("--stale", type=float, default=0.5,
                    help="the client's stale_timeout in seconds")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as C
    from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                                StitchingPipeline)
    from pointcloud_stitching_tpu_torch.io import load_ply
    from pointcloud_stitching_tpu_torch.runtime import (Codec,
                                                        FakeCameraServer,
                                                        stitch_cli)
    from pointcloud_stitching_tpu_torch.runtime import client as CL

    dev = torch.device("cuda")
    ncam, h, w = C.NCAM, C.H, C.W
    frames, _ = C.stream_rig()
    d_rig = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    i_d = Intrinsics.d435_default(width=w, height=h, device=dev)
    ref = StitchingPipeline(
        StitchConfig(num_cameras=ncam, height=h, width=w),
        i_d.stack([i_d] * (ncam - 1)),
        np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1)),
        device=dev)(d_rig).cloud
    want = ref.xyz[ref.mask].cpu().numpy()

    ages, live = [], []
    real_init, real_snapshot = (CL.MulticameraClient.__init__,
                                CL.MulticameraClient._snapshot)

    def init(self, *a, **kw):
        real_init(self, *a, **{**kw, "stale_timeout": args.stale})

    def snapshot(self, *a, **kw):
        now = time.time()
        ages.append(max(now - s.stamp for s in self._slots))
        stage, n = real_snapshot(self, *a, **kw)
        live.append(n)
        return stage, n

    CL.MulticameraClient.__init__ = init
    CL.MulticameraClient._snapshot = snapshot
    for k in ("DISPLAY", "WAYLAND_DISPLAY"):
        os.environ.pop(k, None)
    servers = [FakeCameraServer(f, codec=Codec.SNAPPY).start()
               for f in frames]
    cams = sum((["--camera", f"127.0.0.1:{s.port}"] for s in servers), [])
    base = cams + ["--height", str(h), "--width", str(w), "--print-every",
                   "0"]
    worst, dropped, differ = 0.0, 0, 0
    try:
        for r in range(args.rounds):
            with tempfile.TemporaryDirectory() as tmp:
                with contextlib.redirect_stdout(io.StringIO()):
                    stitch_cli.main(base + ["--frames", "30", "--save-dir",
                                            os.path.join(tmp, "b")])
                    ages.clear()
                    live.clear()
                    stitch_cli.main(base + [
                        "--frames", "5", "--save-every", "1",
                        "--save-dir", os.path.join(tmp, "g"), "--view",
                        "--view-dir", os.path.join(tmp, "view"),
                        "--view-every", "2",
                        "--trace-dir", os.path.join(tmp, "trace")])
                g = os.path.join(tmp, "g")
                same = [np.array_equal(load_ply(os.path.join(g, f))[0], want)
                        for f in sorted(os.listdir(g))]
            worst = max(worst, max(ages))
            dropped += sum(n < ncam for n in live)
            differ += same.count(False)
            print(f"round {r}: oldest frame at each snapshot "
                  f"{[f'{a:.3f}' for a in ages]} s, live cameras {live}, "
                  f"saved clouds equal to the direct call {same}",
                  flush=True)
    finally:
        CL.MulticameraClient.__init__ = real_init
        CL.MulticameraClient._snapshot = real_snapshot
        for s in servers:
            s.stop()
    print(f"stale_timeout {args.stale} s, {args.rounds} rounds: oldest frame "
          f"{worst:.3f} s, {dropped} snapshots without every camera, "
          f"{differ} saved clouds differ")
    return 1 if dropped or differ else 0


if __name__ == "__main__":
    sys.exit(main())
