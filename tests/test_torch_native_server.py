"""The port's wire reader and pipelined client against the C++ camera
server (native/camera_server.cc), the counterpart of
tests/test_native_server.py. The server is built with g++ as that file
builds it (into a temporary directory), and the tests skip where the
toolchain fails."""
import os
import socket
import subprocess

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                            StitchingPipeline)
from pointcloud_stitching_tpu_torch.runtime import (Kind, MulticameraClient,
                                                    recv_frame)
from pointcloud_stitching_tpu_torch.runtime.wire import send_pull
from test_torch_runtime import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("native") / "pcs-camera-server")
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-o", out,
         os.path.join(REPO, "native", "camera_server.cc"),
         os.path.join(REPO, "native", "snappy.cc"), "-lpthread"],
        capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"native toolchain failed: {r.stderr[:500]}")
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Servers:
    """Start servers with ``start(*args)``; all stop at teardown."""

    def __init__(self, binary):
        self.binary, self.procs = binary, []

    def start(self, *args) -> int:
        port = _free_port()
        p = subprocess.Popen([self.binary, "--port", str(port), *args],
                             stderr=subprocess.PIPE, text=True)
        self.procs.append(p)
        # the ready banner arrives on stderr once the socket listens
        line = p.stderr.readline()
        assert "native camera server" in line, line
        return port

    def stop(self):
        for p in self.procs:
            p.terminate()
            p.wait(timeout=10)
            p.stderr.close()


@pytest.fixture
def servers(server_bin):
    s = _Servers(server_bin)
    yield s
    s.stop()


def _pull(port, n):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        out = []
        for _ in range(n):
            send_pull(s)
            out.append(recv_frame(s))
        return out


def test_snappy_stream_loops(servers):
    port = servers.start("--synthetic", "--n-frames", "4", "--height", "48",
                         "--width", "128")
    frames = _pull(port, 6)              # loops past the 4 recorded frames
    for i, (kind, seq, depth) in enumerate(frames):
        assert kind == Kind.DEPTH16 and seq == i
        assert depth.shape == (48, 128) and depth.dtype == np.uint16
    np.testing.assert_array_equal(frames[0][2], frames[4][2])
    assert (frames[0][2] == 0).mean() > 0.03          # the 7% holes


def test_color_stream(servers):
    port = servers.start("--synthetic", "--n-frames", "3", "--height", "48",
                         "--width", "128", "--color")
    for i, (kind, seq, (depth, rgb)) in enumerate(_pull(port, 3)):
        assert kind == Kind.DEPTH16_COLOR and seq == i
        d = depth.astype(np.float32)
        np.testing.assert_array_equal(
            rgb[..., 0], np.clip(d / 16.0, 0, 255).astype(np.uint8))
        np.testing.assert_array_equal(
            rgb[..., 1], np.clip(255 - d / 16.0, 0, 255).astype(np.uint8))
        assert (rgb[..., 2] == 128).all()


def test_npy_replay(servers, tmp_path):
    frames = (np.arange(3 * 16 * 32) % 2000).reshape(3, 16, 32).astype(
        np.uint16)
    np.save(tmp_path / "rec.npy", frames)
    port = servers.start("--file", str(tmp_path / "rec.npy"))
    for i, (_, seq, depth) in enumerate(_pull(port, 3)):
        assert seq == i
        np.testing.assert_array_equal(depth, frames[i])


@time_limit(60)
@pytest.mark.parametrize("color", [False, True])
def test_client_stitches_native_cameras(servers, color):
    """Two C++ servers feed the port's pipelined client on the CPU: every
    stitched frame equals a direct pipeline call on the frames the client
    received, bit for bit."""
    h, w, ncam = 48, 128, 2
    extra = ("--color",) if color else ()
    ports = [servers.start("--synthetic", "--n-frames", "3", "--seed",
                           str(s), "--height", str(h), "--width", str(w),
                           *extra) for s in range(ncam)]
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       out_voxel_leaf=0.02, out_capacity=16384,
                       icp_voxel_leaf=0.1, icp_capacity=512,
                       icp_iterations=3, icp_max_corr_dist=0.3,
                       with_color=color)
    i0 = Intrinsics.create(fx=60.0, fy=60.0, ppx=w / 2, ppy=h / 2, width=w,
                           height=h)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[1, 0, 3] = 0.05
    pipe = StitchingPipeline(cfg, i0.stack([i0]), ext, device="cpu")
    client = MulticameraClient([("127.0.0.1", p) for p in ports],
                               pipe).start()
    try:
        assert client.wait_for_first_frames(timeout=10)
        outs = []
        m = client.run(num_frames=3, on_frame=lambda i, o: outs.append(o))
    finally:
        client.stop()
    assert m.total_frames == 3 and len(outs) == 3
    for out in outs:
        assert out.depth.shape == (ncam, h, w)
        want = pipe(out.depth, out.color, out.cam_mask)
        assert int(want.metrics.points_out) > 100
        for name in ("xyz", "mask", "rgb"):
            a, b = getattr(out.cloud, name), getattr(want.cloud, name)
            assert (a is None) == (b is None) and (a is None
                                                   or torch.equal(a, b))
        if color:
            assert out.color.shape == (ncam, h, w, 3)
