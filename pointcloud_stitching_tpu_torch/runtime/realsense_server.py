"""Real camera server: RealSense D400 capture → wire protocol.

Equivalent of the reference's pcs-camera-server binary (reference:
src/pcs-camera-server.cpp — SURVEY.md §3.1): open the depth pipeline at
848x480@30, serve one frame per 1-byte pull request. Differences from the
reference, by design:

  * the wire carries raw u16 depth (DEPTH16), not deprojected points —
    deprojection moved on-device (BASELINE: "the host keeps only camera
    capture and socket ingest"); the legacy POINTS_I16MM payload is
    available via --points for reference-client compatibility,
  * intrinsics travel out-of-band: --dump-intrinsics writes the device's
    factory calibration as an .intr.json the stitcher loads via
    --intr-dir (the reference instead bakes intrinsics into the
    camera-side deprojection and never ships them).

Requires pyrealsense2, imported only when a camera is opened, so the
module loads everywhere; the fake server is the drop-in stand-in for
development. Copy of ``pointcloud_stitching_tpu/runtime/realsense_server.py``
(numpy only); ``--dump-intrinsics`` writes through the port's
``io.calio.save_intrinsics``.
"""
from __future__ import annotations

import argparse
import socket

import numpy as np

from .wire import Codec, Kind, encode_depth_frame, encode_frame, \
    pack_points_i16mm, recv_exact


def _open_pipeline(width: int, height: int, fps: int):
    try:
        import pyrealsense2 as rs
    except ImportError as e:
        raise SystemExit(
            "pyrealsense2 is required for the real camera server; use "
            "pointcloud_stitching_tpu_torch.runtime.fake_server for replay/"
            "synthetic streams") from e
    pipeline = rs.pipeline()
    cfg = rs.config()
    cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    profile = pipeline.start(cfg)
    stream = profile.get_stream(rs.stream.depth).as_video_stream_profile()
    intr = stream.get_intrinsics()
    scale = profile.get_device().first_depth_sensor().get_depth_scale()
    meta = dict(fx=intr.fx, fy=intr.fy, ppx=intr.ppx, ppy=intr.ppy,
                coeffs=list(intr.coeffs), model=str(intr.model),
                depth_scale=scale)
    return pipeline, meta


def dump_intrinsics(meta: dict, width: int, height: int, path: str) -> None:
    """Write the device's depth intrinsics as a stitch_cli-loadable
    .intr.json via io.calio.save_intrinsics (single owner of the on-disk
    schema). The rs2 model string maps to the DistortionModel enum values
    deprojection understands."""
    from ..io.calio import save_intrinsics
    from ..utils.types import Intrinsics
    m = str(meta.get("model", "")).lower()
    model = 2 if "inverse" in m else (1 if "brown" in m else 0)
    intr = Intrinsics.create(fx=meta["fx"], fy=meta["fy"], ppx=meta["ppx"],
                             ppy=meta["ppy"], coeffs=list(meta["coeffs"]),
                             model=model, width=width, height=height)
    save_intrinsics(path, intr)
    print(f"wrote intrinsics to {path}", flush=True)


def serve(port: int, host: str = "0.0.0.0", width: int = 848,
          height: int = 480, fps: int = 30, codec: Codec = Codec.SNAPPY,
          points: bool = False, decimation: int = 1,
          dump_intr: str | None = None) -> None:
    pipeline, meta = _open_pipeline(width, height, fps)
    print(f"camera intrinsics: {meta}", flush=True)
    if dump_intr:
        if decimation > 1:
            # the served stream is depth[::d, ::d]: decimated pixel
            # (u, v) is original (u·d, v·d), so the dumped intrinsics
            # must scale fx/fy/ppx/ppy and the grid size by 1/d or the
            # .intr.json could never match the frames it rides with
            # (the same rescale stitch_cli's own --decimation applies,
            # models/stitcher.py — and the u,v grids below apply in
            # reverse for the points payload)
            d = float(decimation)
            meta_d = dict(meta, fx=meta["fx"] / d, fy=meta["fy"] / d,
                          ppx=meta["ppx"] / d, ppy=meta["ppy"] / d)
            dump_intrinsics(meta_d, width // decimation,
                            height // decimation, dump_intr)
        else:
            dump_intrinsics(meta, width, height, dump_intr)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    print(f"camera server on {host}:{port}", flush=True)

    u = v = None
    while True:
        conn, addr = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        print(f"client {addr} connected", flush=True)
        seq = 0
        try:
            while True:
                recv_exact(conn, 1)  # pull
                frames = pipeline.wait_for_frames()
                depth = np.asanyarray(frames.get_depth_frame().get_data())
                if decimation > 1:
                    depth = depth[::decimation, ::decimation]
                if points:
                    if u is None:
                        h, w = depth.shape
                        u, v = np.meshgrid(
                            np.arange(w, dtype=np.float32) * decimation,
                            np.arange(h, dtype=np.float32) * decimation)
                    z = depth.astype(np.float32) * meta["depth_scale"]
                    valid = depth > 0
                    xyz = np.stack([(u - meta["ppx"]) / meta["fx"] * z,
                                    (v - meta["ppy"]) / meta["fy"] * z,
                                    z], axis=-1)[valid]
                    conn.sendall(encode_frame(pack_points_i16mm(xyz),
                                              Kind.POINTS_I16MM, codec, seq))
                else:
                    conn.sendall(encode_depth_frame(depth, seq, codec))
                seq += 1
        except (ConnectionError, OSError):
            print(f"client {addr} disconnected", flush=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--width", type=int, default=848)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--codec", choices=["raw", "zlib", "snappy"],
                    default="snappy")
    ap.add_argument("--points", action="store_true")
    ap.add_argument("--decimation", type=int, default=1)
    ap.add_argument("--dump-intrinsics", metavar="PATH",
                    help="write the device's depth intrinsics to PATH as "
                         ".intr.json (for stitch_cli --intr-dir)")
    args = ap.parse_args(argv)
    serve(args.port, args.host, args.width, args.height, args.fps,
          {"raw": Codec.RAW, "zlib": Codec.ZLIB,
           "snappy": Codec.SNAPPY}[args.codec],
          args.points, args.decimation, dump_intr=args.dump_intrinsics)


if __name__ == "__main__":
    main()
