"""Live viewer: subscribe to a stitched-cloud stream and render it.

Port of ``pointcloud_stitching_tpu/runtime/view_cli.py`` (numpy and
sockets; cv2 is imported only by the window and PNG paths). The consumer
half of the visualization story (reference: the client's
``pcl::visualization::PCLVisualizer`` window in its render loop —
src/pcs-multicamera-client.cpp, SURVEY.md §1 L4). `CloudPublisher` pushes
every fused cloud over TCP (POINTS_I16MM); this tool connects, renders each
frame as a depth-buffered orthographic projection and shows it live:

  * in a cv2 window when a GUI is available (the default; falls back
    cleanly when cv2/imshow is absent or headless — `--no-window` forces
    the fallback),
  * otherwise as a rolling image sequence on disk (`--out-dir`, PNG via cv2
    or zero-dependency PPM) — `frame_%05d` plus a continuously-overwritten
    `latest`, so `watch`/a browser tab/an http.server on the directory acts
    as the live monitor on a GUI-less serving box.

Projection bounds lock onto the first frame (expanding only when the cloud
outgrows them) so the view doesn't rescale every frame.

CLI:
  python -m pointcloud_stitching_tpu_torch.runtime.view_cli \
      --connect HOST:PORT [--axis z] [--size 800] [--out-dir viewer_out] \
      [--frames N] [--every K] [--window]
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from typing import Callable, Optional

import numpy as np

from ..io.plyio import save_ply
from ..io.render import render_view, save_image, view_rotation
from .publisher import valid_rows
from .wire import Kind, recv_frame

# initial orbit viewpoint reproducing each fixed --axis projection
_AXIS_VIEW = {"z": (0.0, 0.0), "x": (90.0, 0.0), "y": (0.0, 90.0)}

# sink command strings → (d_azimuth, d_elevation) in degrees
_ORBIT_STEP = 15.0
_ORBIT_CMDS = {"az+": (_ORBIT_STEP, 0.0), "az-": (-_ORBIT_STEP, 0.0),
               "el+": (0.0, _ORBIT_STEP), "el-": (0.0, -_ORBIT_STEP)}


class CloudView:
    """Orbitable render state: viewpoint + sticky projection window.

    Shared by the stream viewer below and stitch_cli's in-process --view
    sink: render(xyz, rgb) → [size,size,3] u8.
    """

    def __init__(self, axis: str = "z", size: int = 800,
                 shade_normals: bool = False):
        self.axis = axis
        self.azimuth, self.elevation = _AXIS_VIEW[axis]
        self.size = size
        # Lambert-shade encoded normals (cfg.with_normals streams) with a
        # view-forward headlight instead of showing them as normal-map
        # colors; toggled live by the 'n' key ("shade" command)
        self.shade_normals = shade_normals
        # sticky projection window: lock to the first frame, expand only
        self._lo: Optional[np.ndarray] = None
        self._span: float = 0.0

    def _update_bounds(self, xyz: np.ndarray) -> tuple[np.ndarray, float]:
        uv = (np.asarray(xyz, np.float32)
              @ view_rotation(self.azimuth, self.elevation).T)[:, :2]
        lo, hi = uv.min(axis=0), uv.max(axis=0)
        pad = 0.05 * max(float((hi - lo).max()), 1e-6)
        lo, span = lo - pad, float((hi - lo).max()) + 2 * pad
        if self._lo is None:
            self._lo, self._span = lo, span
        else:
            # expand (never shrink): keeps the view stable while following
            # a scene that grows past the initial window
            new_lo = np.minimum(self._lo, lo)
            new_hi = np.maximum(self._lo + self._span, lo + span)
            self._lo = new_lo
            self._span = float((new_hi - new_lo).max())
        return self._lo, self._span

    def orbit(self, d_azimuth: float, d_elevation: float) -> None:
        """Move the viewpoint; the projection window re-locks on the next
        render (bounds from one basis are meaningless in another)."""
        self.azimuth = (self.azimuth + d_azimuth) % 360.0
        self.elevation = float(np.clip(self.elevation + d_elevation,
                                       -89.0, 89.0))
        self._lo, self._span = None, 0.0

    def reset_view(self) -> None:
        self.azimuth, self.elevation = _AXIS_VIEW[self.axis]
        self._lo, self._span = None, 0.0

    def apply_command(self, cmd) -> bool:
        """True if ``cmd`` was an orbit/reset steering string (applied)."""
        if not isinstance(cmd, str):
            return False
        if cmd == "reset":
            self.reset_view()
            return True
        if cmd == "shade":
            self.shade_normals = not self.shade_normals
            return True
        if cmd in _ORBIT_CMDS:
            self.orbit(*_ORBIT_CMDS[cmd])
            return True
        return False

    def render(self, xyz, rgb=None) -> np.ndarray:
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        if len(xyz) == 0:  # all-masked frame: blank, bounds untouched
            return np.zeros((self.size, self.size, 3), np.uint8)
        bounds = self._update_bounds(xyz)
        return render_view(xyz, rgb, azimuth=self.azimuth,
                           elevation=self.elevation, size=self.size,
                           bounds=bounds,
                           shade_normals=self.shade_normals)

    def render_cloud(self, pc) -> np.ndarray:
        """Render a PointCloud's valid points (tensors on any device)."""
        return self.render(*valid_rows(pc))


class StreamViewer:
    """Pull frames from a publisher connection and render them.

    ``sink(frame_index, image)`` receives every rendered [size,size,3]
    uint8 image and steers the viewer through its return value:
    True = continue, False/"quit" = stop, "az+"/"az-"/"el+"/"el-" = orbit
    the viewpoint by 15° (the keyboard counterpart of PCLVisualizer's
    mouse orbit), "reset" = back to the initial
    --axis view, "snap" = save the retained cloud as a .ply snapshot
    (the reference's keypress savePLYFile — SURVEY §3.2).
    The cloud that produced the frame is retained, so an
    orbit command re-renders it from the new viewpoint immediately — the
    operator can spin a paused or slow stream. Separated from the CLI so
    tests can drive the full subscribe→decode→render→orbit path headlessly.
    """

    def __init__(self, address: tuple[str, int], axis: str = "z",
                 size: int = 800, every: int = 1,
                 connect_timeout: float = 10.0, snapshot_dir: str = ".",
                 shade_normals: bool = False):
        self.address = address
        self.view = CloudView(axis=axis, size=size,
                              shade_normals=shade_normals)
        self.every = max(every, 1)
        self._timeout = connect_timeout
        self._last_cloud: Optional[tuple] = None
        self.frames_rendered = 0
        self.snapshot_dir = snapshot_dir
        self._snap_count = 0

    # steering API kept on the viewer itself (tests drive it directly)
    @property
    def azimuth(self):
        return self.view.azimuth

    @property
    def elevation(self):
        return self.view.elevation

    def orbit(self, d_azimuth: float, d_elevation: float) -> None:
        self.view.orbit(d_azimuth, d_elevation)

    def reset_view(self) -> None:
        self.view.reset_view()

    def _render(self, xyz, rgb) -> np.ndarray:
        return self.view.render(xyz, rgb)

    def snap(self) -> Optional[str]:
        """Save the retained cloud as a .ply snapshot (the reference
        client's keypress save — pcl::io::savePLYFile in the render loop,
        src/pcs-multicamera-client.cpp, SURVEY §3.2). Returns the path,
        or None when no frame has arrived yet."""
        if self._last_cloud is None:
            return None
        os.makedirs(self.snapshot_dir, exist_ok=True)
        xyz, rgb = self._last_cloud
        path = os.path.join(self.snapshot_dir,
                            f"snapshot_{self._snap_count:05d}.ply")
        save_ply(path, xyz, rgb)
        self._snap_count += 1
        return path

    def _handle(self, result) -> bool:
        """Apply a sink's steering command; False = stop streaming.

        Handles "snap" at ANY point in the steering loop (first response
        or mid-orbit re-render), not just as the initial command."""
        while True:
            if result == "snap":
                path = self.snap()
                print(f"viewer: saved {path}", flush=True)
                # a snapshot produces no new image; re-consult the sink
                # only through the next streamed frame
                return True
            if not self.view.apply_command(result):
                break
            if self._last_cloud is None:
                return True
            xyz, rgb = self._last_cloud
            idx = self.frames_rendered
            self.frames_rendered += 1
            result = self._sink(idx, self._render(xyz, rgb))
        return result is not False and result != "quit"

    def run(self, sink: Callable[[int, np.ndarray], object],
            num_frames: Optional[int] = None) -> int:
        """Stream until the publisher closes, num_frames rendered, or the
        sink stops/steers (see class docstring). Returns frames rendered."""
        self._sink = sink
        sock = socket.create_connection(self.address, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(30.0)
        n_seen = 0
        try:
            while num_frames is None or self.frames_rendered < num_frames:
                try:
                    kind, seq, payload = recv_frame(sock)
                except (ConnectionError, OSError, EOFError):
                    break
                if kind != Kind.POINTS_I16MM:
                    continue
                n_seen += 1
                if (n_seen - 1) % self.every:
                    continue
                xyz, rgb = payload
                if len(xyz) == 0:
                    continue
                self._last_cloud = (xyz, rgb)
                idx = self.frames_rendered
                self.frames_rendered += 1
                if not self._handle(sink(idx, self._render(xyz, rgb))):
                    break
        finally:
            try:
                sock.close()
            except OSError:
                pass
        return self.frames_rendered


def _window_sink(title: str = "pointcloud_stitching_tpu_torch"):
    """cv2 window sink, or None when no GUI backend works.

    Keys: a/d orbit azimuth ∓/±15°, w/s elevation ±15°, 0 reset view,
    p save a .ply snapshot of the current cloud (the reference client's
    keypress save), q quit — the keyboard stand-in for PCLVisualizer's
    mouse orbit + snapshot handler.
    """
    # cv2's Qt backend ABORTS the process (not a Python exception) when
    # imshow runs with no display server, so gate on one existing first
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return None
    try:
        import cv2
        test = np.zeros((2, 2, 3), np.uint8)
        cv2.imshow(title, test)
        cv2.waitKey(1)
    except Exception:
        return None

    keymap = {ord("q"): "quit", ord("a"): "az-", ord("d"): "az+",
              ord("w"): "el+", ord("s"): "el-", ord("0"): "reset",
              ord("p"): "snap", ord("n"): "shade"}

    def sink(idx: int, img: np.ndarray):
        cv2.imshow(title, img[..., ::-1])  # cv2 is BGR
        return keymap.get(cv2.waitKey(1) & 0xFF, True)

    return sink


def _directory_sink(out_dir: str, keep: int = 0):
    """Image-sequence sink: frame_%05d + an atomically-replaced `latest`."""
    os.makedirs(out_dir, exist_ok=True)
    try:
        import cv2  # noqa: F401
        ext = ".png"
    except ImportError:
        ext = ".ppm"
    t0 = time.time()

    def sink(idx: int, img: np.ndarray) -> bool:
        save_image(os.path.join(out_dir, f"frame_{idx:05d}{ext}"), img)
        tmp = os.path.join(out_dir, f".latest_tmp{ext}")
        save_image(tmp, img)
        os.replace(tmp, os.path.join(out_dir, f"latest{ext}"))
        if keep and idx >= keep:
            old = os.path.join(out_dir, f"frame_{idx - keep:05d}{ext}")
            if os.path.exists(old):
                os.remove(old)
        if idx and idx % 30 == 0:
            fps = (idx + 1) / max(time.time() - t0, 1e-9)
            print(f"viewer: {idx + 1} frames, {fps:.1f} FPS -> {out_dir}",
                  flush=True)
        return True

    return sink


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="publisher address (stitch_cli --publish-port)")
    ap.add_argument("--axis", default="z", choices=("x", "y", "z"))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N rendered frames (default: forever)")
    ap.add_argument("--every", type=int, default=1,
                    help="render every K-th frame")
    ap.add_argument("--out-dir", default="viewer_out")
    ap.add_argument("--keep", type=int, default=300,
                    help="rolling image-sequence length (0 = keep all)")
    ap.add_argument("--snap-dir", default=None,
                    help=".ply snapshot directory for the 'p' key "
                         "(default: --out-dir)")
    ap.add_argument("--shade", action="store_true",
                    help="the stream carries encoded normals (pcs-stitch "
                         "--normals): Lambert-shade them with a headlight "
                         "instead of showing normal-map colors ('n' key "
                         "toggles live)")
    ap.add_argument("--window", dest="window", action="store_true",
                    default=None,
                    help="force a cv2 GUI window (default: try one, fall "
                         "back to the image sequence when headless)")
    ap.add_argument("--no-window", dest="window", action="store_false",
                    help="always write the image sequence")
    args = ap.parse_args(argv)

    host, port = args.connect.rsplit(":", 1)
    # default (no flag): try a window, fall back — matches the README's
    # "cv2 window when a GUI exists; otherwise a rolling image sequence"
    sink = _window_sink() if args.window is not False else None
    if sink is None:
        if args.window:
            print("viewer: no GUI available, writing image sequence",
                  flush=True)
        sink = _directory_sink(args.out_dir, keep=args.keep)

    viewer = StreamViewer((host, int(port)), axis=args.axis, size=args.size,
                          every=args.every,
                          snapshot_dir=args.snap_dir or args.out_dir,
                          shade_normals=args.shade)
    n = viewer.run(sink, num_frames=args.frames)
    print(f"viewer: rendered {n} frames", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
