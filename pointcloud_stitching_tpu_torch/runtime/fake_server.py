"""Fake camera server: replays recorded or synthetic depth streams over TCP.

The cluster-without-hardware harness (SURVEY.md §4 'distributed without a
cluster'): plays the role of the reference's per-NUC pcs-camera-server
(src/pcs-camera-server.cpp) — bind/listen/accept, then serve one frame per
1-byte pull request — but sources frames from an .npy recording or the
synthetic scene generator instead of a RealSense pipeline. Doubles as the
fault injector: it can drop connections or stall on demand.

Copy of ``pointcloud_stitching_tpu/runtime/fake_server.py`` (numpy only);
``synthetic_frames`` gives the same frames bit for bit.

CLI:
  python -m pointcloud_stitching_tpu_torch.runtime.fake_server \
      --port 8000 --frames path.npy | --synthetic --seed 0 [--fps 30] \
      [--codec zlib] [--stall-after N] [--die-after N]
"""
from __future__ import annotations

import argparse
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from .wire import (Codec, FLAG_HAS_RGB, Kind, encode_depth_frame,
                   encode_frame, pack_points_i16mm, recv_exact)


class FakeCameraServer:
    """Serves a fixed sequence of depth frames, pull-based, forever (loops).

    ``points=True`` switches to the reference's legacy payload: the server
    deprojects on the camera node and sends packed int16-mm XYZ points
    (reference: the pack loop in src/pcs-camera-server.cpp — SURVEY.md §3.1),
    exercising interop with reference-style camera servers.
    """

    def __init__(self, frames: np.ndarray, port: int = 0,
                 host: str = "127.0.0.1", fps: Optional[float] = None,
                 codec: Codec = Codec.ZLIB,
                 stall_after: Optional[int] = None,
                 die_after: Optional[int] = None,
                 points: bool = False,
                 color: bool = False,
                 color_shape: Optional[tuple] = None,
                 color_frames: Optional[np.ndarray] = None,
                 intrinsics: tuple = (421.5, 421.1, None, None),
                 depth_scale: float = 0.001):
        """``color_shape=(Hc, Wc)`` serves color at its own resolution
        (DEPTH16_COLOR_NATIVE — an unaligned rs2 color stream); None keeps
        depth-aligned color (DEPTH16_COLOR). ``color_frames`` replays a
        recorded [T, Hc, Wc, 3] u8 stream (what save_recording writes)
        instead of synthesising color from depth."""
        if frames.ndim != 3 or frames.dtype != np.uint16:
            raise ValueError("frames must be [T, H, W] uint16")
        self.frames = frames
        self.color = color or color_frames is not None
        self.colors: Optional[np.ndarray] = None
        color = self.color
        if color_frames is not None:
            if color_frames.ndim != 4 or color_frames.shape[0] != len(frames):
                raise ValueError("color_frames must be [T, Hc, Wc, 3]")
            self.colors = np.ascontiguousarray(color_frames, np.uint8)
        elif color:
            # synthetic depth-aligned RGB: hue from depth, stable per pixel
            d = frames.astype(np.float32)
            if color_shape is not None:
                # resample to the color stream's own grid (nearest)
                hc, wc = color_shape
                h, w = frames.shape[1:]
                vi = (np.arange(hc) * h // hc)
                ui = (np.arange(wc) * w // wc)
                d = d[:, vi][:, :, ui]
            self.colors = np.stack([
                np.clip(d / 16.0, 0, 255),
                np.clip(255 - d / 16.0, 0, 255),
                np.full_like(d, 128.0)], axis=-1).astype(np.uint8)
        self.points_payloads: Optional[list[bytes]] = None
        self.points_have_rgb = points and color
        if points and color and self.colors is not None and \
                self.colors.shape[1:3] != frames.shape[1:]:
            # the points payload textures each depth pixel with its own
            # color pixel; a native-resolution color grid has no such
            # per-depth alignment (the reference's points path is
            # depth-aligned too) — without this check the valid-mask
            # indexing below fails with an opaque IndexError
            raise ValueError(
                "points=True needs depth-aligned color; got color "
                f"{self.colors.shape[1:3]} vs depth {frames.shape[1:]} "
                "(drop color_shape / pass depth-aligned color_frames)")
        if points:
            h, w = frames.shape[1:]
            fx, fy, ppx, ppy = intrinsics
            ppx = w / 2.0 if ppx is None else ppx
            ppy = h / 2.0 if ppy is None else ppy
            u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                               np.arange(h, dtype=np.float32))
            self.points_payloads = []
            for t, f in enumerate(frames):
                z = f.astype(np.float32) * depth_scale
                valid = f > 0
                xyz = np.stack([(u - ppx) / fx * z, (v - ppy) / fy * z, z],
                               axis=-1)[valid]
                rgb = self.colors[t][valid] if color else None
                self.points_payloads.append(pack_points_i16mm(xyz, rgb))
        self.fps = fps
        self.codec = codec
        self.stall_after = stall_after
        self.die_after = die_after
        # encoded-frame cache: the stream is a fixed cycle and the compressed
        # body is seq-independent (seq lives in the header), so each frame
        # compresses once and later pulls just patch the header's seq field.
        # A real camera node pays compression on its own core; without the
        # cache a many-server loopback rig serialises every compression on
        # this host and the harness, not the system under test, dominates.
        self._enc_cache: dict[int, bytes] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FakeCameraServer":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # wakes a thread blocked in accept() (close alone does not)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2)

    def _frame_bytes(self, seq: int) -> bytes:
        """Encoded frame for ``seq``, compressing each cycle frame only once
        (the header's u32 seq at byte offset 8 is patched per send)."""
        t = seq % len(self.frames)
        enc = self._enc_cache.get(t)
        if enc is None:
            if self.points_payloads is not None:
                enc = encode_frame(
                    self.points_payloads[t], Kind.POINTS_I16MM, self.codec, 0,
                    flags=FLAG_HAS_RGB if self.points_have_rgb else 0)
            else:
                c = self.colors[t] if self.color else None
                enc = encode_depth_frame(self.frames[t], 0, self.codec,
                                         color=c)
            self._enc_cache[t] = enc
        buf = bytearray(enc)
        struct.pack_into("<I", buf, 8, seq & 0xFFFFFFFF)
        return bytes(buf)

    def _serve(self) -> None:
        self._seq = 0
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if not self._serve_conn(conn):
                # permanent fault injected: stop listening entirely
                try:
                    self._sock.close()
                except OSError:
                    pass
                return

    def _serve_conn(self, conn) -> bool:
        """Serve one client connection. Returns False to kill the server
        permanently (fault injection); True to accept the next client."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        last = 0.0
        try:
            while not self._stop.is_set():
                seq = self._seq
                recv_exact(conn, 1)  # pull request
                if self.die_after is not None and seq >= self.die_after:
                    conn.close()
                    return False
                if self.stall_after is not None and seq >= self.stall_after:
                    # stall: hold the socket open, never answer
                    self._stop.wait()
                    return False
                if self.fps:
                    now = time.time()
                    wait = (1.0 / self.fps) - (now - last)
                    if wait > 0:
                        time.sleep(wait)
                    last = time.time()
                conn.sendall(self._frame_bytes(seq))
                self._seq = seq + 1
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
        return True


def synthetic_frames(n_frames: int, h: int = 480, w: int = 848,
                     seed: int = 0) -> np.ndarray:
    """A slowly drifting synthetic scene (same generator family as tests)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    out = np.empty((n_frames, h, w), np.uint16)
    phase = rng.uniform(0, 6.28)
    for t in range(n_frames):
        p = phase + 0.02 * t
        depth = (1500 + 500 * np.sin(u / (w * 0.23) + p)
                 + 400 * np.cos(v / (h * 0.19))
                 + 150 * np.sin(u / (w * 0.041) + 1.0 + p)
                 + 120 * np.cos(v / (h * 0.037)))
        holes = rng.random((h, w)) < 0.07
        depth[holes] = 0
        out[t] = np.clip(depth, 0, 4000).astype(np.uint16)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--frames", help=".npy file of [T,H,W] uint16 depth")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-frames", type=int, default=64)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=848)
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--codec", choices=["raw", "zlib", "snappy"],
                    default="zlib")
    ap.add_argument("--points", action="store_true",
                    help="serve packed int16-mm points (reference legacy mode)")
    ap.add_argument("--color", action="store_true",
                    help="attach synthetic depth-aligned RGB")
    ap.add_argument("--color-size", default=None, metavar="HxW",
                    help="serve color at its own resolution (unaligned "
                         "stream, DEPTH16_COLOR_NATIVE), e.g. 720x1280")
    ap.add_argument("--color-frames", default=None,
                    help=".npy of recorded [T,Hc,Wc,3] u8 color (what "
                         "--record-dir saves as camN_color.npy)")
    ap.add_argument("--stall-after", type=int, default=None)
    ap.add_argument("--die-after", type=int, default=None)
    args = ap.parse_args(argv)

    if args.frames:
        frames = np.load(args.frames)
    else:
        frames = synthetic_frames(args.n_frames, args.height, args.width,
                                  args.seed)
    codec = {"raw": Codec.RAW, "zlib": Codec.ZLIB,
             "snappy": Codec.SNAPPY}[args.codec]
    cshape = None
    if args.color_size:
        hc, wc = args.color_size.lower().split("x")
        cshape = (int(hc), int(wc))
    cframes = np.load(args.color_frames) if args.color_frames else None
    srv = FakeCameraServer(frames, port=args.port, host=args.host,
                           fps=args.fps, codec=codec,
                           stall_after=args.stall_after,
                           die_after=args.die_after,
                           points=args.points, color=args.color,
                           color_shape=cshape, color_frames=cframes)
    srv.start()
    mode = "points" if args.points else "depth"
    print(f"fake camera server on {args.host}:{srv.port} "
          f"({len(frames)} frames, codec={args.codec}, mode={mode})", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
