"""Single-camera test harness: pull frames from one server, print timing.

Port of ``pointcloud_stitching_tpu/runtime/camera_test.py`` (the reference's
pcs-camera-test: a loopback test of one camera with FPS/latency, without
the full cluster). ``--deproject`` also deprojects each frame with the
port's ``deproject`` on the device that ``PCS_PLATFORM`` names (default the
first GPU; ``cpu`` for the CPU).

CLI:
  python -m pointcloud_stitching_tpu_torch.runtime.camera_test \\
      --host 127.0.0.1 --port 8000 --frames 120 [--deproject]
"""
from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from ..utils.metrics import FrameMetrics
from .wire import Kind, recv_frame, send_pull


def run(host: str, port: int, frames: int, deproject: bool = False,
        quiet: bool = False, device=None) -> FrameMetrics:
    """Pull ``frames`` frames; with ``deproject`` deproject each on
    ``device`` (default ``utils.platform.platform_device()``)."""
    metrics = FrameMetrics()
    dep_fn = None
    if deproject:
        import torch

        from ..ops.deproject import deproject as dep
        from ..utils.platform import platform_device
        from ..utils.types import Intrinsics
        dev = platform_device() if device is None else torch.device(device)
        intr = Intrinsics.d435_default(device=dev)
        dep_fn = lambda d: dep(torch.from_numpy(d.copy()).to(dev), intr)  # noqa: E731

    sock = socket.create_connection((host, port), timeout=10)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        for i in range(frames):
            t0 = time.time()
            send_pull(sock)
            kind, seq, payload = recv_frame(sock)
            if kind != Kind.DEPTH16:
                raise ValueError(f"unexpected kind {kind}")
            npts = int(np.count_nonzero(payload))
            if dep_fn is not None:
                npts = int(dep_fn(payload).count())
            metrics.record(time.time() - t0, points=payload.size)
            if not quiet and i > 0 and i % 30 == 0:
                print(f"frame {i}: {metrics.fps:.1f} FPS, "
                      f"p50 {metrics.latency_ms(50):.1f} ms, "
                      f"{npts} valid points", flush=True)
    finally:
        sock.close()
    return metrics


def main(argv=None) -> int:
    """The command: stream, print the metrics, exit status 0 (``run``
    returns them)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--deproject", action="store_true",
                    help="also deproject each frame on the device")
    args = ap.parse_args(argv)
    print(run(args.host, args.port, args.frames, args.deproject))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
