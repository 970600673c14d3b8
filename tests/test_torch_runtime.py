"""The port's streaming runtime on a CPU loopback rig.

Wire frames against the JAX package's (byte for byte), the fake server's
frames, the native codecs, the pipelined client against direct pipeline
calls (bit for bit), the client's behaviour under faults (from
tests/test_runtime.py), the stitch CLI and the camera test. Everything runs
on the CPU with fake camera servers on localhost; every test has a time
limit of its own, so a socket that hangs fails the test instead of eating
the suite's clock.
"""
import functools
import json
import os
import signal
import socket
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu.runtime import fake_server as jax_fake
from pointcloud_stitching_tpu.runtime import wire as jax_wire
from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                            StitchingPipeline)
from pointcloud_stitching_tpu_torch import native
from pointcloud_stitching_tpu_torch.io import lzf as py_lzf
from pointcloud_stitching_tpu_torch.io import load_ply
from pointcloud_stitching_tpu_torch.models.tsdf import load_volume
from pointcloud_stitching_tpu_torch.utils import prng
from pointcloud_stitching_tpu_torch.native import lzf as native_lzf
from pointcloud_stitching_tpu_torch.runtime import (
    Codec, FakeCameraServer, Kind, MulticameraClient, camera_test, stitch_cli,
    synthetic_frames, wire)

NCAM, H, W = 3, 60, 106


def time_limit(seconds: float):
    """Fail the test with TimeoutError once it has run ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s "
                                   "limit")
            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco


@pytest.fixture
def rig():
    """Start fake servers through ``rig(frames, **kw)``; stops them (and
    any client handed to ``rig.client``) at teardown."""
    servers, clients = [], []

    def start(frames, **kw):
        srv = FakeCameraServer(frames, **kw).start()
        servers.append(srv)
        return srv

    start.client = lambda c: clients.append(c) or c
    yield start
    for c in clients:
        c.stop()
    for s in servers:
        s.stop()


def _pipeline(ncam=NCAM, h=H, w=W, icp=True, **kw):
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.02, out_capacity=16384,
                       icp_enabled=icp, icp_voxel_leaf=0.1, icp_capacity=512,
                       icp_iterations=3, icp_max_corr_dist=0.3, **kw)
    i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[:, :3, 3] = np.random.default_rng(3).uniform(-0.1, 0.1, (ncam, 3))
    return StitchingPipeline(cfg, i0.stack([i0] * (ncam - 1)), ext,
                             device="cpu")


# --- wire, fake server, codecs ------------------------------------------

def test_native_library_builds_here():
    """g++ exists here: the port's codecs must build, never fall back."""
    assert native.available()
    assert native.lib_path().is_file()
    assert "_build" in native.lib_path().parts


@time_limit(60)
@pytest.mark.parametrize("codec", [Codec.RAW, Codec.ZLIB, Codec.SNAPPY])
@pytest.mark.parametrize("kind", ["depth", "aligned", "native", "points",
                                  "points_rgb"])
def test_wire_frames_byte_identical_to_jax(codec, kind):
    rng = np.random.default_rng(60 + int(codec))
    depth = rng.integers(0, 4000, (H, W)).astype(np.uint16)
    depth[rng.random((H, W)) < 0.3] = 0
    color = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    color_n = rng.integers(0, 256, (45, 80, 3)).astype(np.uint8)
    xyz = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (700, 3)).astype(np.uint8)
    jcodec = jax_wire.Codec(int(codec))
    if kind.startswith("points"):
        c = rgb if kind == "points_rgb" else None
        payload = wire.pack_points_i16mm(xyz, c)
        assert payload == jax_wire.pack_points_i16mm(xyz, c)
        flags = wire.FLAG_HAS_RGB if c is not None else 0
        got = wire.encode_frame(payload, Kind.POINTS_I16MM, codec, 9,
                                flags=flags)
        want = jax_wire.encode_frame(payload, jax_wire.Kind.POINTS_I16MM,
                                     jcodec, 9, flags=flags)
    else:
        c = {"depth": None, "aligned": color, "native": color_n}[kind]
        got = wire.encode_depth_frame(depth, 9, codec, color=c)
        want = jax_wire.encode_depth_frame(depth, 9, jcodec, color=c)
    assert got == want
    k, seq, out = wire.decode_frame(got[:wire.HEADER_SIZE],
                                    got[wire.HEADER_SIZE:])
    assert seq == 9
    if kind.startswith("points"):
        np.testing.assert_allclose(out[0], xyz, atol=5.1e-4)
        if kind == "points_rgb":
            np.testing.assert_array_equal(out[1], rgb)
    elif kind == "depth":
        np.testing.assert_array_equal(out, depth)
    else:
        np.testing.assert_array_equal(out[0], depth)
        np.testing.assert_array_equal(out[1], c)


def test_wire_bounds_and_missing_snappy(monkeypatch):
    """Decoding bounds the decompressed size; a snappy stream where the
    native codec cannot be built raises (no quiet fallback to RAW)."""
    bomb = zlib.compress(b"\x00" * 200_000, 9)
    with pytest.raises(ValueError, match="exceeds"):
        wire.decompress(bomb, Codec.ZLIB, max_out=100_000)
    data = b"abc" * 1000
    assert wire.decompress(zlib.compress(data), Codec.ZLIB,
                           max_out=10_000) == data
    with pytest.raises(ValueError, match="claims"):
        wire.decompress(b"\xff\xff\xff\xff\x0f" + b"\x00" * 16,
                        Codec.SNAPPY, max_out=1 << 20)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="snappy"):
        wire.compress(b"abc", Codec.SNAPPY)
    with pytest.raises(RuntimeError, match="snappy"):
        wire.decompress(b"\x03abc", Codec.SNAPPY)


@pytest.mark.parametrize("n,h,w,seed", [(3, 60, 106, 0), (2, 48, 64, 5),
                                        (1, 480, 848, 1)])
def test_synthetic_frames_equal_jax(n, h, w, seed):
    np.testing.assert_array_equal(synthetic_frames(n, h, w, seed),
                                  jax_fake.synthetic_frames(n, h, w, seed))


@pytest.mark.parametrize("size", [0, 1, 100, 70_000])
def test_native_lzf_round_trips_and_agrees_with_python(size):
    rng = np.random.default_rng(70 + size % 7)
    data = (rng.integers(0, 8, size).astype(np.uint8).tobytes()
            if size % 2 == 0 else rng.bytes(size))
    enc_n = native_lzf.compress(data)
    enc_p = py_lzf.compress(data)
    for enc in (enc_n, enc_p):
        assert native_lzf.decompress(enc, size) == data
        assert py_lzf.decompress(enc, size) == data
        assert native_lzf.decompress(enc, size, force_python=True) == data
    if size:
        with pytest.raises(ValueError):
            native_lzf.decompress(enc_n, size + 1)
    else:
        with pytest.raises(ValueError):
            native_lzf.decompress(b"\x00x", 0)


@time_limit(20)
def test_fake_server_serves_and_refuses(rig):
    frames = synthetic_frames(4, H, W, seed=1)
    srv = rig(frames, codec=Codec.SNAPPY)
    with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as s:
        for i in range(6):  # loops past the end
            wire.send_pull(s)
            kind, seq, payload = wire.recv_frame(s)
            assert kind == Kind.DEPTH16 and seq == i
            np.testing.assert_array_equal(payload, frames[i % 4])
    with pytest.raises(ValueError, match="depth-aligned"):
        FakeCameraServer(frames, points=True, color=True,
                         color_shape=(48, 64))


# --- the client against direct pipeline calls ----------------------------

def _direct(pipe, servers, payload):
    """The pipeline on the frames the servers serve (static, frame 0)."""
    mask = torch.ones(NCAM, dtype=torch.bool)
    if payload == "points":
        cap = H * W
        xyz = np.zeros((NCAM, cap, 3), np.float32)
        pmask = np.zeros((NCAM, cap), bool)
        rgb = np.zeros((NCAM, cap, 3), np.uint8)
        for i, s in enumerate(servers):
            p, c = wire.unpack_points_i16mm(s.points_payloads[0],
                                            with_rgb=s.points_have_rgb)
            xyz[i, :len(p)], pmask[i, :len(p)] = p, True
            if c is not None:
                rgb[i, :len(c)] = c
        return pipe.step_points(torch.from_numpy(xyz),
                                torch.from_numpy(pmask),
                                rgb=(torch.from_numpy(rgb)
                                     if pipe.cfg.with_color else None),
                                cam_mask=mask)
    depths = torch.from_numpy(np.stack([s.frames[0] for s in servers]))
    colors = (torch.from_numpy(np.stack([s.colors[0] for s in servers]))
              if pipe.cfg.with_color else None)
    return pipe(depths, colors, mask)


def _assert_same(a, b):
    for name in ("xyz", "mask", "rgb"):
        x, y = getattr(a.cloud, name), getattr(b.cloud, name)
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name
    assert torch.equal(a.extrinsics, b.extrinsics)
    for name in ("points_in", "points_out", "icp_mean_error", "icp_inliers"):
        assert torch.equal(getattr(a.metrics, name),
                           getattr(b.metrics, name)), name


@time_limit(60)
@pytest.mark.parametrize("overlap,sync_every", [(False, 1), (False, 3),
                                                (True, 1), (True, 3)])
@pytest.mark.parametrize("payload", ["depth", "color", "points"])
def test_loopback_stream_equals_direct_calls(rig, payload, overlap,
                                             sync_every):
    """3 static cameras, anchored mode, ring ICP on: every streamed output
    equals a direct pipeline call on the same frames, bit for bit (snappy
    codec for the depth kinds, zlib for points)."""
    color = payload == "color"
    points = payload == "points"
    servers = [rig(synthetic_frames(1, H, W, seed=s), color=color,
                   points=points, intrinsics=(53.0, 53.0, None, None),
                   codec=Codec.ZLIB if points else Codec.SNAPPY)
               for s in range(NCAM)]
    pipe = _pipeline(with_color=color)
    client = rig.client(MulticameraClient(
        [("127.0.0.1", s.port) for s in servers], pipe,
        payload="points" if points else "depth").start())
    assert client.wait_for_first_frames(timeout=10)
    outs = []
    m = client.run(num_frames=4, overlap=overlap, sync_every=sync_every,
                   on_frame=lambda i, o: outs.append((i, o)))
    assert m.total_frames == 4 and [i for i, _ in outs] == list(range(4))
    want = _direct(pipe, servers, "points" if points else "depth")
    assert int(want.metrics.points_out) > 100
    if color:
        assert want.cloud.rgb is not None
    for _, out in outs:
        _assert_same(out, want)
        if not points:
            assert torch.equal(out.depth, torch.from_numpy(
                np.stack([s.frames[0] for s in servers])))
            assert bool(out.cam_mask.all())
    assert "sync_wait" in client.stages.stages or not overlap
    if overlap:
        assert len(m.latencies) == (2 if sync_every == 3 else 4)


class _CopyGuard:
    """Stands in for a ring slot's CUDA event on the CPU: after ``record``
    (a copy was enqueued that reads the slot) the slot's arrays are
    read-only until ``synchronize`` (the copy has completed), so a snapshot
    that writes a slot before waiting on its copy raises."""

    def __init__(self, stage):
        self.stage, self.saved = stage, None
        self.waits = 0

    def record(self, stream=None):
        self.saved = dict(self.stage.np)
        for k, v in self.saved.items():
            if v is not None:
                ro = v.view()
                ro.flags.writeable = False
                self.stage.np[k] = ro

    def synchronize(self):
        self.waits += 1
        if self.saved is not None:
            self.stage.np.update(self.saved)
            self.saved = None


@time_limit(60)
@pytest.mark.parametrize("wait", [True, False], ids=["waits", "no_wait"])
def test_staging_ring_cannot_tear_a_frame(rig, monkeypatch, wait):
    """With sync_every=3 the ring is reused while copies may be in flight.
    A slot is written only after its last copy completed: with the wait in
    place every output is a direct call on whole served frames; without it
    (the control) a snapshot writes into a slot a copy still reads."""
    seqs = [synthetic_frames(5, H, W, seed=10 + s) for s in range(NCAM)]
    for s, f in enumerate(seqs):       # make every frame unique
        f[:, 0, 0] = np.arange(5, dtype=np.uint16) + 100 * s + 1
    servers = [rig(f) for f in seqs]
    pipe = _pipeline()
    client = rig.client(MulticameraClient(
        [("127.0.0.1", s.port) for s in servers], pipe).start())
    client._ensure_stage_ring(5)
    for st in client._stage_ring:
        st.copied = _CopyGuard(st)
    real = client._transfer

    def transfer(stage):
        dev = real(stage)
        stage.copied.record()
        return dev

    monkeypatch.setattr(client, "_transfer", transfer)
    if not wait:
        monkeypatch.setattr(type(client._stage_ring[0]), "wait_copied",
                            lambda self: None)
    assert client.wait_for_first_frames(timeout=10)
    outs = []
    if not wait:
        with pytest.raises(ValueError, match="read-only"):
            client.run(num_frames=9, overlap=True, sync_every=3)
        return
    client.run(num_frames=9, overlap=True, sync_every=3,
               on_frame=lambda i, o: outs.append(o))
    assert len(outs) == 9
    assert sum(st.copied.waits for st in client._stage_ring) >= 9
    for out in outs:
        for c in range(NCAM):
            tag = int(out.depth[c, 0, 0])
            k = tag - 100 * c - 1
            assert 0 <= k < 5
            assert torch.equal(out.depth[c], torch.from_numpy(seqs[c][k]))
        _assert_same(out, pipe(out.depth, None, out.cam_mask))


# --- behaviour under faults (tests/test_runtime.py) -----------------------

@time_limit(30)
@pytest.mark.parametrize("alive", [1, 0])
def test_dead_cameras_are_dropped(rig, alive):
    """A server that dies is dropped from the batch; with none left a tick
    returns None."""
    servers = [rig(synthetic_frames(4, H, W, seed=0))] if alive else []
    servers.append(rig(synthetic_frames(4, H, W, seed=1), die_after=2))
    client = rig.client(MulticameraClient(
        [("127.0.0.1", s.port) for s in servers],
        _pipeline(len(servers), icp=False), stale_timeout=0.3).start())
    client.wait_for_first_frames(timeout=10)
    time.sleep(0.6)  # the dying camera dies and goes stale
    out = client.step()
    if alive:
        assert out is not None and client.metrics.dropped_cameras == 1
        assert not bool(out.cam_mask[1]) and bool(out.cam_mask[0])
    else:
        assert out is None


@time_limit(30)
def test_bounded_run_dispatches_exactly_n(rig):
    servers = [rig(synthetic_frames(8, H, W, seed=s)) for s in range(2)]
    client = rig.client(MulticameraClient(
        [("127.0.0.1", s.port) for s in servers],
        _pipeline(2, icp=False)).start())
    calls = {"n": 0}
    real = client._dispatch

    def counted(dev):
        calls["n"] += 1
        return real(dev)

    client._dispatch = counted
    assert client.wait_for_first_frames(timeout=10)
    for overlap in (True, False):
        calls["n"] = 0
        client.metrics.reset()
        m = client.run(num_frames=5, overlap=overlap)
        assert m.total_frames == 5 and calls["n"] == 5, (overlap, calls)
    assert client.run(num_frames=0).total_frames == 5  # returns at once


@time_limit(30)
def test_run_fps_paces_the_loop(rig):
    srv = rig(synthetic_frames(8, 48, 64, seed=0))
    client = rig.client(MulticameraClient(
        [("127.0.0.1", srv.port)], _pipeline(1, 48, 64, icp=False)).start())
    assert client.wait_for_first_frames(timeout=10)
    client.run(num_frames=2)
    for overlap in (True, False):
        t0 = time.time()
        m = client.run(num_frames=10, overlap=overlap, fps=50.0)
        dt = time.time() - t0
        assert m.total_frames >= 10
        assert 9 / 50.0 <= dt < 10 * (2 / 50.0) + 1.0, (overlap, dt)


@time_limit(40)
def test_camera_reconnects_after_server_restart(rig):
    frames = synthetic_frames(4, H, W, seed=2)
    srv = rig(frames, die_after=2)
    port = srv.port
    client = rig.client(MulticameraClient(
        [("127.0.0.1", port)], _pipeline(1, icp=False),
        stale_timeout=0.3).start())
    assert client.wait_for_first_frames(timeout=10)
    time.sleep(0.8)  # the server dies after 2 frames; the slot goes stale
    assert client.step() is None
    srv.stop()
    rig(frames, port=port)
    deadline = time.time() + 15
    out = None
    while out is None and time.time() < deadline:
        time.sleep(0.2)
        out = client.step()
    assert out is not None, "camera did not resurrect"


def _listener():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    return srv


@time_limit(40)
@pytest.mark.parametrize("fault", ["corrupt_frame", "garbage"])
def test_bad_bytes_kill_only_the_camera(rig, fault):
    """A corrupt compressed body (zlib.error) marks the slot dead and the
    reconnect loop brings it back; a server speaking garbage kills only its
    slot, with a readable error, and a tick returns None."""
    h, w = H, W
    frame = (np.random.default_rng(80).random((h, w)) * 4000).astype(
        np.uint16)
    good = wire.encode_depth_frame(frame, 0, codec=Codec.ZLIB)
    bad = bytearray(good)
    for i in range(wire.HEADER_SIZE + 4, min(len(bad),
                                             wire.HEADER_SIZE + 64)):
        bad[i] ^= 0xFF                  # corrupt the zlib body, keep size
    srv = _listener()
    port = srv.getsockname()[1]
    state = {"conns": 0}

    def serve():
        while state["conns"] < 4:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            state["conns"] += 1
            first = state["conns"] == 1
            try:
                while True:
                    wire.recv_exact(conn, 1)
                    if fault == "garbage":
                        conn.sendall(b"\xde\xad\xbe\xef" * 64)
                        time.sleep(1)
                        break
                    conn.sendall(bytes(bad) if first else good)
                    if first:
                        break           # one poisoned frame, then hang up
            except OSError:
                pass
            finally:
                conn.close()

    threading.Thread(target=serve, daemon=True).start()
    try:
        client = rig.client(MulticameraClient(
            [("127.0.0.1", port)], _pipeline(1, h, w, icp=False),
            stale_timeout=0.5, reconnect=fault != "garbage").start())
        if fault == "garbage":
            deadline = time.time() + 5
            while client._slots[0].alive and time.time() < deadline:
                time.sleep(0.05)
            assert not client._slots[0].alive
            assert client.camera_errors()
            assert client.step() is None
            return
        deadline = time.time() + 15
        out = None
        while out is None and time.time() < deadline:
            time.sleep(0.2)
            out = client.step()
        assert out is not None, client.camera_errors()
        assert state["conns"] >= 2      # it reconnected
    finally:
        srv.close()


@time_limit(30)
@pytest.mark.parametrize("bounded", [True, False])
def test_dead_timeout_bounds_only_bounded_runs(rig, bounded):
    """With every camera dead a bounded run returns after dead_timeout; an
    unbounded run keeps waiting until stop()."""
    srv = rig(synthetic_frames(4, H, W), die_after=1)
    client = rig.client(MulticameraClient(
        [("127.0.0.1", srv.port)], _pipeline(1, icp=False),
        stale_timeout=0.2, reconnect=False).start())
    client.wait_for_first_frames(timeout=10)
    time.sleep(0.5)  # the camera dies and goes stale
    if bounded:
        t0 = time.time()
        m = client.run(num_frames=100, overlap=True, dead_timeout=1.0)
        assert time.time() - t0 < 10.0 and m.total_frames < 100
        return
    done = threading.Event()

    def run():
        client.run(num_frames=None, overlap=True, dead_timeout=0.3)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    assert not done.wait(timeout=1.5)
    client.stop()
    assert done.wait(timeout=5.0)


# --- the CLIs -------------------------------------------------------------

@time_limit(90)
def test_stitch_cli_saves_clouds_and_tsdf(rig, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    servers = [rig(synthetic_frames(2, H, W, seed=s), color=True,
                   codec=Codec.SNAPPY) for s in range(2)]
    out_dir, npz = tmp_path / "clouds", tmp_path / "scene.npz"
    argv = sum((["--camera", f"127.0.0.1:{s.port}"] for s in servers), [])
    argv += ["--height", str(H), "--width", str(W), "--frames", "5",
             "--color", "--save-dir", str(out_dir), "--save-every", "2",
             "--tsdf-leaf", "0.05", "--tsdf-shape", "48,48,48",
             "--tsdf-every", "2", "--tsdf-out", str(npz),
             "--print-every", "2", "--timing"]
    m = stitch_cli._run(argv)
    assert m.total_frames == 5
    plys = sorted(os.listdir(out_dir))
    assert plys == ["cloud_000000.ply", "cloud_000002.ply",
                    "cloud_000004.ply"]
    xyz, rgb = load_ply(str(out_dir / plys[-1]))
    assert len(xyz) > 100 and rgb is not None and rgb.std() > 1.0
    vol = load_volume(str(npz), device="cpu")
    assert int((vol.weight > 0).sum()) > 0 and vol.rgb is not None
    text = capsys.readouterr().out
    assert "saved TSDF volume (3 keyframes" in text and "stages(ms)" in text


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _subscribe(port: int, frames: int, got: dict):
    """A StreamViewer thread that connects to the publisher on ``port`` as
    soon as it listens and keeps the clouds of ``frames`` frames."""
    from pointcloud_stitching_tpu_torch.runtime import StreamViewer

    def run():
        viewer = StreamViewer(("127.0.0.1", port), size=64)
        clouds = []

        def sink(i, img):
            clouds.append(viewer._last_cloud)
            return True

        for _ in range(500):
            try:
                got["frames"] = viewer.run(sink, num_frames=frames)
                got["clouds"] = clouds
                return
            except ConnectionRefusedError:
                time.sleep(0.01)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


@time_limit(90)
@pytest.mark.parametrize("argv,entry", [
    (["--view-dir", "v"], 10), (["--view-every", "2"], 10),
    (["--drop-plane", "0.02"], 8), (["--publish-port", "9000"], 10),
    (["--view"], 10), (["--trace-dir", "t"], 10)])
def test_stitch_cli_refuses_unported_flags(rig, tmp_path, monkeypatch,
                                           argv, entry):
    """Each flag this test once pinned as refused (its module was not
    ported; ``entry`` is the ROADMAP §1 entry that ported it) now runs end
    to end on a 2-camera loopback rig and has its effect: --view writes
    the image sequence (no display here), --view-every renders every K-th
    frame and acts on the window's p (snapshot) and q (close) keys,
    --drop-plane saves clouds equal to a direct pipeline call followed by
    segment_plane/extract_plane from key 0, --publish-port
    feeds a StreamViewer subscriber the saved cloud in int16 mm, and
    --trace-dir writes a Chrome trace."""
    from pointcloud_stitching_tpu_torch.ops import extract_plane, segment_plane
    from pointcloud_stitching_tpu_torch.runtime import view_cli
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.chdir(tmp_path)
    frames = [synthetic_frames(1, H, W, seed=s) for s in range(2)]
    servers = [rig(f, codec=Codec.SNAPPY) for f in frames]
    nframes = 8
    # a 16,384-slot output grid: the default 262,144 makes the CPU's plane
    # search take seconds a frame
    cfg = StitchConfig(num_cameras=2, height=H, width=W, out_capacity=16384)
    cfg.save(str(tmp_path / "cfg.json"))
    cli = sum((["--camera", f"127.0.0.1:{s.port}"] for s in servers), [])
    cli += ["--config", "cfg.json", "--frames", str(nframes),
            "--print-every", "0", "--save-dir", "clouds", "--save-every", "1"]
    flag = argv[0]
    calls, got, sub = [], {}, None
    if flag == "--view-dir":
        argv = ["--view", "--view-dir", str(tmp_path / "v"), "--view-size",
                "128"]
    elif flag == "--view":
        argv = ["--view", "--view-size", "128"]
    elif flag == "--view-every":
        keys = {0: "snap", 2: "az+", 4: "quit"}

        def sink(i, img):
            calls.append((i, img.shape))
            return keys.get(i, True)

        monkeypatch.setattr(view_cli, "_window_sink", lambda: sink)
        argv = ["--view", "--view-every", "2", "--view-size", "96",
                "--view-dir", "snaps"]
    elif flag == "--publish-port":
        port = _free_port()
        argv = ["--publish-port", str(port), "--fps", "20"]
        sub = _subscribe(port, 3, got)
    m = stitch_cli._run(cli + argv)
    assert m.total_frames == nframes
    saved = [load_ply(str(tmp_path / "clouds" / f"cloud_{i:06d}.ply"))[0]
             for i in range(nframes)]
    for xyz in saved[1:]:
        np.testing.assert_array_equal(xyz, saved[0])   # static frames

    if flag in ("--view-dir", "--view"):
        d = tmp_path / ("v" if flag == "--view-dir" else "viewer_out")
        names = sorted(os.listdir(d))
        assert [x.split(".")[0] for x in names] == (
            [f"frame_{i:05d}" for i in range(nframes)] + ["latest"])
    elif flag == "--view-every":
        # rendered at 0, 2, 4; q at 4 closed the view; p at 0 saved frame 0
        assert calls == [(i, (96, 96, 3)) for i in (0, 2, 4)]
        snap, _ = load_ply(str(tmp_path / "snaps" / "snapshot_00000.ply"))
        np.testing.assert_array_equal(snap, saved[0])
    elif flag == "--drop-plane":
        i0 = Intrinsics.d435_default(width=W, height=H)
        pipe = StitchingPipeline(cfg, i0.stack([i0]), np.tile(
            np.eye(4, dtype=np.float32), (2, 1, 1)), device="cpu")
        out = pipe(torch.from_numpy(np.stack([f[0] for f in frames])))
        model, _, count = segment_plane(out.cloud, 0.02, prng.key(0))
        want = extract_plane(out.cloud, model, 0.02)
        assert int(count) > 100
        np.testing.assert_array_equal(saved[0], want.xyz[want.mask].numpy())
        assert len(saved[0]) == int(out.cloud.mask.sum()) - int(count)
    elif flag == "--publish-port":
        sub.join(timeout=30)
        assert not sub.is_alive() and got["frames"] == 3
        packed = wire.unpack_points_i16mm(wire.pack_points_i16mm(saved[0]))
        for xyz, rgb in got["clouds"]:
            np.testing.assert_array_equal(xyz, packed[0])
            assert rgb is None
    else:
        with open(tmp_path / "t" / "trace.json") as f:
            trace = json.load(f)
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert "aten::sort" in names, sorted(names)[:20]


@time_limit(90)
def test_stitch_cli_voxel_map_equals_direct_accumulation(rig, tmp_path,
                                                         monkeypatch, capsys):
    """--map-leaf/--map-out .npz over a few loopback frames saves the map a
    direct TemporalAccumulator makes from direct pipeline calls on the same
    frames (bit for bit); --map-in resumes it (resized, saved as .ply) and
    refuses a rig whose colour does not match the checkpoint."""
    from pointcloud_stitching_tpu_torch.models.voxel_map import (
        TemporalAccumulator, load_map)
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    frames = [synthetic_frames(1, H, W, seed=s) for s in range(2)]
    servers = [rig(f, codec=Codec.SNAPPY) for f in frames]
    cams = sum((["--camera", f"127.0.0.1:{s.port}"] for s in servers), [])
    base = cams + ["--height", str(H), "--width", str(W), "--frames", "4",
                   "--print-every", "0"]
    npz = str(tmp_path / "scene.npz")
    stitch_cli.main(base + ["--map-leaf", "0.05", "--map-out", npz,
                            "--map-decay", "0.9", "--map-capacity", "4096"])
    assert "saved accumulated map (" in capsys.readouterr().out

    cfg = StitchConfig(num_cameras=2, height=H, width=W)
    i0 = Intrinsics.d435_default(width=W, height=H)
    pipe = StitchingPipeline(cfg, i0.stack([i0]),
                             np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
                             device="cpu")
    depth = torch.from_numpy(np.stack([f[0] for f in frames]))
    acc = TemporalAccumulator(capacity=4096, leaf=0.05, decay=0.9,
                              device="cpu")
    for _ in range(4):
        acc.update(pipe(depth).cloud)
    got = load_map(npz, device="cpu")
    for k in ("ijk", "sums", "weight", "leaf"):
        assert torch.equal(getattr(got, k), getattr(acc.state, k)), k
    assert got.rgb_sums is None and int(got.count()) > 100

    ply = str(tmp_path / "map.ply")
    stitch_cli.main(base + ["--map-in", npz, "--map-capacity", "8192",
                            "--map-out", ply])
    assert f"to {ply}" in capsys.readouterr().out
    xyz, _ = load_ply(ply)
    assert len(xyz) >= int(got.count())
    with pytest.raises(ValueError, match="without color"):
        stitch_cli.main(base + ["--map-in", npz, "--color"])


@time_limit(30)
def test_camera_test_deprojects_on_the_cpu(rig, monkeypatch, capsys):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    srv = rig(synthetic_frames(3, 480, 848, seed=4), codec=Codec.SNAPPY)
    assert camera_test.main(["--port", str(srv.port), "--frames", "4",
                             "--deproject"]) == 0
    assert '"frames": 4' in capsys.readouterr().out
