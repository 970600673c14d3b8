#!/usr/bin/env python
"""Launch a loopback camera cluster on the PyTorch port: N fake camera
servers + the port's stitching client.

The port's counterpart of scripts/local_cluster.py, with the same flags:
the servers are ``pointcloud_stitching_tpu_torch.runtime.fake_server``
processes on localhost and the client is the port's ``stitch_cli``. The
client runs on the GPU; ``PCS_PLATFORM=cpu`` in the environment (which
every process inherits) runs it on the CPU. For real remote hosts use
scripts/start_cameras_torch.sh.

A server that does not come up is an error. The exit code is the
client's; the servers are stopped whatever happens.

Usage:
  python scripts/local_cluster_torch.py --cameras 4 --frames 120 [--fps 30]
  PCS_PLATFORM=cpu python scripts/local_cluster_torch.py --cameras 2 \\
      --frames 3 --height 120 --width 212
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER = "pointcloud_stitching_tpu_torch.runtime.fake_server"
CLIENT = "pointcloud_stitching_tpu_torch.runtime.stitch_cli"
READY = "fake camera server on "     # the server's first line
STOP_TIMEOUT = 10.0                  # seconds a server gets to exit


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--base-port", type=int, default=18800)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=848)
    ap.add_argument("--codec", default="zlib")
    ap.add_argument("--points", action="store_true",
                    help="legacy mode: servers send packed points")
    ap.add_argument("--color", action="store_true",
                    help="colored streams (depth-aligned RGB)")
    ap.add_argument("--client-args", default="",
                    help="extra args forwarded to stitch_cli")
    return ap.parse_args(argv)


def server_command(args, i: int) -> list[str]:
    cmd = [sys.executable, "-m", SERVER,
           "--port", str(args.base_port + i), "--synthetic",
           "--seed", str(i), "--height", str(args.height),
           "--width", str(args.width), "--codec", args.codec]
    if args.fps:
        cmd += ["--fps", str(args.fps)]
    if args.points:
        cmd += ["--points"]
    if args.color:
        cmd += ["--color"]
    return cmd


def client_command(args) -> list[str]:
    cmd = [sys.executable, "-m", CLIENT, "--frames", str(args.frames),
           "--height", str(args.height), "--width", str(args.width)]
    for i in range(args.cameras):
        cmd += ["--camera", f"127.0.0.1:{args.base_port + i}"]
    if args.points:
        cmd += ["--payload", "points"]
    if args.color:
        cmd += ["--color"]
    return cmd + args.client_args.split()


def child_env() -> dict:
    """This environment (PCS_PLATFORM and the rest), with the checkout
    first on PYTHONPATH so that ``-m`` finds the port from any directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def start_servers(args, env: dict, servers: list) -> None:
    """Start every server at once, then wait for each one's first line.
    Each process goes into ``servers`` as it starts, so the caller stops
    them all."""
    for i in range(args.cameras):
        servers.append(subprocess.Popen(server_command(args, i),
                                        stdout=subprocess.PIPE, text=True,
                                        env=env))
    for i, p in enumerate(servers):
        line = p.stdout.readline()
        if not line.startswith(READY):
            raise RuntimeError(
                f"camera server {i} (port {args.base_port + i}) did not come "
                f"up: exit code {p.poll()}, first line {line!r}")
        print(line.strip(), flush=True)


def stop_servers(servers: list) -> None:
    for p in servers:
        if p.poll() is None:
            p.terminate()
    for p in servers:
        try:
            p.wait(timeout=STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.stdout is not None:
            p.stdout.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cameras < 1:
        raise SystemExit("--cameras must be >= 1")
    env = child_env()
    servers: list = []
    try:
        start_servers(args, env, servers)
        return subprocess.call(client_command(args), env=env)
    finally:
        stop_servers(servers)


if __name__ == "__main__":
    sys.exit(main())
